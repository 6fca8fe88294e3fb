"""Forward render and training step (port of ``gsplat_tpu/train/step.py``).

``render_image`` is the entry point for eval renders and image dumps;
``train_step`` = ``compute_loss_and_grads`` + ``apply_adam`` is one
optimizer step on one camera: per-Gaussian projection, covariance and SH
colour, exact tile binning, the forward rasterizer, the fused SSIM+L1
loss, then autograd back through the rasterizer's custom backward (backward
kernel, segment sum) and the per-Gaussian maths, and a
visibility-masked Adam update. As in the reference, the steps call
``build_tile_tables`` and ``rasterize`` with their defaults, the packed
mode (``ops/render.py``); ``exact_mode()`` binds those two functions to
``bf16_colors=False`` / ``bf16_grads=False`` in every module that calls
them (``MODE_CALL_SITES``), which gives the exact f32 mode.

``StepStatics(pair_cap=0)`` (the default) sizes binning exactly: two
host reads a frame, and the step runs eagerly. A pair cap bins at the
reference's fixed capacities (``ops/binning.py``) with no host read in
the step, and the metrics' ``overflow`` and ``row_overflow`` report the
capacities the frame needed (exact sizing reports them too).
``monitored_train_step`` folds them and the loss's finiteness into a (3,)
device monitor, as the reference does, for one host read at a boundary.

The reference's jitted factories have counterparts: ``get_train_step``,
``get_monitored_train_step`` and ``get_render_fn``. On the card, and at a
pair cap, each captures its function into a CUDA graph (``_Graphed``):
the first call for a StepStatics and a state runs eagerly (that run is
the step, and PyTorch's warm-up before a capture), the second captures
and replays, later calls copy their inputs into the graph's static
buffers and replay; nothing in a replay reads the host. A capture that
fails raises. On the CPU, or with ``pair_cap=0``, they run eagerly.

The uv-gradient statistic of densification comes from a zero probe added
to uv before rasterization: its gradient is exactly the reference's
scaled ``grad_uv``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
from typing import NamedTuple

import torch

from ..ops import adam as adam_ops
from ..ops import covariance, projection
from ..ops import sh as sh_ops
from ..ops.binning import TileTables, build_tile_tables
from ..ops.loss import compute_psnr, fused_loss
from ..ops.render import rasterize
from .state import PARAM_DIMS, GaussianParams, TrainState

# The package's modules that call build_tile_tables and rasterize, the two
# functions that take the mode: exact_mode rebinds them there.
MODE_CALL_SITES = ("gsplat_tpu_torch.train.step", "gsplat_tpu_torch.parallel.tile_parallel")


@contextlib.contextmanager
def exact_mode():
    """For a ``with`` block: the package in the reference's exact f32 mode.

    The default is the packed mode. As the reference's own tests reach
    exact mode, ``build_tile_tables`` and ``rasterize`` are bound to
    ``bf16_colors=False`` and ``bf16_grads=False`` in each module of
    ``MODE_CALL_SITES``, so ``render_image``, ``train_step``,
    ``dp_train_step``, ``tp_train_step`` and the Trainer run exact; they
    are restored on exit."""
    from ..ops import binning, render

    mods = [importlib.import_module(name) for name in MODE_CALL_SITES]
    saved = [(m, m.build_tile_tables, m.rasterize) for m in mods]
    for m in mods:
        m.build_tile_tables = functools.partial(binning.build_tile_tables, bf16_colors=False)
        m.rasterize = functools.partial(render.rasterize, bf16_grads=False)
    try:
        yield
    finally:
        for m, tables, raster in saved:
            m.build_tile_tables, m.rasterize = tables, raster


@dataclasses.dataclass(frozen=True)
class StepStatics:
    """Per-geometry constants, under the reference's field names.

    ``pair_cap`` and ``row_cap`` are the reference's capacities; 0 sizes
    binning exactly (eager), and a pair cap with ``row_cap`` 0 derives the
    row cap from it as the reference does. Its ``chunk`` and
    ``interpret`` are gone: the kernels pick their own blocking.
    """

    width: int
    height: int
    tile: int
    l_max: int
    # camera intrinsics
    focal_x: float
    focal_y: float
    tan_fovx: float
    tan_fovy: float
    # config-derived
    near_thresh: float
    mh_dist: float
    cull_padding: int
    ssim_frac: float
    base_lr: float
    xyz_lr_init: float
    xyz_lr_final: float
    quat_lr: float
    scale_lr: float
    opacity_lr: float
    rgb_lr: float
    sh_lr: float
    scene_extent: float
    num_iters: int
    pair_cap: int = 0
    row_cap: int = 0

    @property
    def num_tiles_x(self) -> int:
        return (self.width + self.tile - 1) // self.tile

    @property
    def num_tiles_y(self) -> int:
        return (self.height + self.tile - 1) // self.tile


def _per_gaussian(params: GaussianParams, view, proj, campos, st: StepStatics):
    """Dense per-Gaussian forward: (uv, conic, rgb, mask, radius, z)."""
    xyz_c = projection.world_to_camera(params.xyz, view)
    uv = projection.project_to_screen(xyz_c, proj, st.width, st.height)
    mask = (
        projection.frustum_cull_mask(
            uv, xyz_c, st.near_thresh, st.cull_padding, st.width, st.height
        )
        & params.alive
    )
    jac = projection.projection_jacobian(
        xyz_c, st.focal_x, st.focal_y, st.tan_fovx, st.tan_fovy
    )
    sigma = covariance.sigma_from_quat_scale(params.quat, params.scale)
    conic, radius = covariance.conic_and_radius(
        sigma, jac, view, st.mh_dist, opacity_logit=params.opacity
    )
    rgb = sh_ops.sh_to_rgb(params.xyz, params.rgb, params.sh, campos, st.l_max)
    z = xyz_c[:, 2]
    return uv, conic, rgb, mask, radius, z


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _tables(uv, z, radius, mask, st: StepStatics) -> TileTables:
    return build_tile_tables(
        uv, z, radius, mask,
        num_tiles_x=st.num_tiles_x, num_tiles_y=st.num_tiles_y, tile_size=st.tile,
        pair_cap=st.pair_cap or None, row_cap=st.row_cap or None,
    )


@torch.no_grad()
def render_image(
    params: GaussianParams, view, proj, campos, bg, st: StepStatics
) -> tuple[torch.Tensor, TileTables]:
    """Forward-only render of one camera: ((H, W, 3) image, tile tables).

    ``view``/``proj`` (4, 4) and ``campos`` (3,) may be numpy arrays or
    tensors; they are moved to the parameters' device. ``bg`` is a number
    or a () float32 tensor.
    """
    dev = params.xyz.device
    view, proj, campos = (_as_f32(x, dev) for x in (view, proj, campos))
    uv, conic, rgb, mask, radius, z = _per_gaussian(params, view, proj, campos, st)
    tables = _tables(uv, z, radius, mask, st)
    out = rasterize(
        uv, conic, rgb, params.opacity, tables, bg,
        width=st.width, height=st.height, tile=st.tile,
    )
    return out.image, tables


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    psnr: torch.Tensor
    num_visible: torch.Tensor
    num_pairs: int | torch.Tensor  # a device count at a pair cap
    overflow: torch.Tensor | None = None  # required pair capacity
    row_overflow: torch.Tensor | None = None  # required row capacity


def compute_loss_and_grads(
    params: GaussianParams, view, proj, campos, gt_image: torch.Tensor,
    bg, st: StepStatics,
):
    """Forward and backward for one camera.

    Returns (loss, image, mask, tables, grads, g_uv): ``grads`` maps each
    parameter name to its gradient (zeros where a parameter is unused, as
    for SH bands above ``l_max``); ``g_uv`` (N_cap, 2) is the gradient of
    the uv probe. Dead capacity rows may carry NaN gradients, which
    ``apply_adam`` scrubs.
    """
    dev = params.xyz.device
    view, proj, campos = (_as_f32(x, dev) for x in (view, proj, campos))
    names = list(PARAM_DIMS)
    leaves = [getattr(params, name) for name in names]
    with torch.enable_grad():
        uv_probe = torch.zeros((params.capacity, 2), dtype=torch.float32, device=dev,
                               requires_grad=True)
        uv, conic, rgb, mask, radius, z = _per_gaussian(params, view, proj, campos, st)
        uv = uv + uv_probe
        tables = _tables(uv.detach(), z.detach(), radius, mask, st)
        out = rasterize(
            uv, conic, rgb, params.opacity, tables, bg,
            width=st.width, height=st.height, tile=st.tile,
        )
        loss = fused_loss(out.image, gt_image, st.ssim_frac)
        got = torch.autograd.grad(loss, leaves + [uv_probe], allow_unused=True)
    grads = {
        name: torch.zeros_like(leaf) if g is None else g
        for name, leaf, g in zip(names, leaves, got)
    }
    return loss.detach(), out.image.detach(), mask, tables, grads, got[-1]


def _device_scalar(x, device) -> torch.Tensor:
    """A () float32 tensor on ``device``: a tensor converted, a number
    filled in (a fill, no copy from the host)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _adam_constants(device: torch.device, xyz_lr_ratio: float) -> tuple:
    """() float32 tensors of B1, B2 and the xyz learning rate's decay
    base on ``device``, made once: a CUDA graph's step (whose eager first
    call makes them) reads them and builds no tensor from a number."""
    return tuple(torch.full((), x, dtype=torch.float32, device=device)
                 for x in (adam_ops.B1, adam_ops.B2, xyz_lr_ratio))


@torch.no_grad()
def apply_adam(
    state: TrainState,
    grads: dict[str, torch.Tensor],
    g_uv: torch.Tensor,
    mask: torch.Tensor,
    iteration,
    st: StepStatics,
    visible_count: torch.Tensor | None = None,
    g_norm: torch.Tensor | None = None,
) -> TrainState:
    """Masked Adam update and densification accumulators, in place.

    The reference returns a new state; updating in place here saves a copy
    of the parameters and moments. The xyz learning rate decays
    exponentially and is scaled by ``scene_extent``; with ``l_max == 0``
    SH is not optimized. ``iteration`` is a number or a () device tensor
    (a CUDA graph's input). ``visible_count`` (N_cap,) int32 and ``g_norm``
    (N_cap,), the per-camera visibility counts and uv-gradient norms summed
    over a camera batch, generalize the accumulators to data-parallel
    batches; by default they are the single camera's ``mask`` and
    ``|g_uv|``.
    """
    dev = g_uv.device
    it = _device_scalar(iteration, dev)
    b1, b2, ratio = _adam_constants(dev, st.xyz_lr_final / st.xyz_lr_init)
    bias1 = 1.0 - torch.pow(b1, it + 1.0)
    bias2 = 1.0 - torch.pow(b2, it + 1.0)
    decay = torch.pow(ratio, it / float(st.num_iters))
    lrs = {
        "xyz": st.scene_extent * st.base_lr * st.xyz_lr_init * decay,
        "rgb": st.base_lr * st.rgb_lr,
        "opacity": st.base_lr * st.opacity_lr,
        "scale": st.base_lr * st.scale_lr,
        "quat": st.base_lr * st.quat_lr,
        "sh": st.base_lr * st.sh_lr,
    }
    for name in PARAM_DIMS:
        if name == "sh" and st.l_max == 0:
            continue  # l_max = 0: SH is not optimized
        param = getattr(state.params, name)
        p, m, v = adam_ops.masked_adam_update(
            param, grads[name], state.adam_m[name], state.adam_v[name],
            mask, lrs[name], bias1, bias2,
        )
        param.copy_(p)
        state.adam_m[name].copy_(m)
        state.adam_v[name].copy_(v)
    if g_norm is None:
        g_norm = torch.sqrt(torch.sum(g_uv * g_uv, dim=1))
    state.uv_grad_accum.copy_(
        torch.where(mask, state.uv_grad_accum + g_norm, state.uv_grad_accum)
    )
    state.accum_dur.add_(mask.to(torch.int32) if visible_count is None else visible_count)
    return state


def train_step(
    state: TrainState, view, proj, campos, gt_image: torch.Tensor, bg,
    iteration, st: StepStatics,
) -> tuple[TrainState, StepMetrics]:
    """One optimizer step on one camera; updates ``state`` in place and
    returns it with the step's metrics."""
    loss, image, mask, tables, grads, g_uv = compute_loss_and_grads(
        state.params, view, proj, campos, gt_image, bg, st
    )
    apply_adam(state, grads, g_uv, mask, iteration, st)
    metrics = StepMetrics(
        loss=loss,
        psnr=compute_psnr(image, gt_image),
        num_visible=torch.sum(mask.to(torch.int32)),
        num_pairs=tables.num_pairs,
        overflow=tables.overflow,
        row_overflow=tables.row_overflow,
    )
    return state, metrics


def monitored_train_step(
    state: TrainState, view, proj, campos, gt_image: torch.Tensor, bg, iteration,
    monitor: torch.Tensor, st: StepStatics,
) -> tuple[TrainState, StepMetrics, torch.Tensor]:
    """``train_step`` and the reference's on-device window monitor:
    ``monitor`` (3,) float32 [max pair requirement seen, max row
    requirement seen, all losses finite] folds this step in on the device,
    so one host read at a boundary covers every step since the last
    ``fresh_monitor``. Returns (state, metrics, new monitor)."""
    state, m = train_step(state, view, proj, campos, gt_image, bg, iteration, st)
    new_monitor = torch.stack([
        torch.maximum(monitor[0], m.overflow.to(torch.float32)),
        torch.maximum(monitor[1], m.row_overflow.to(torch.float32)),
        torch.minimum(monitor[2], torch.isfinite(m.loss).to(torch.float32)),
    ])
    return state, m, new_monitor


def fresh_monitor(device: torch.device | str = "cuda") -> torch.Tensor:
    """[0, 0, 1] on ``device``, made by fills (no copy from the host)."""
    monitor = torch.zeros(3, dtype=torch.float32, device=device)
    monitor[2] = 1.0
    return monitor


def _state_tensors(state: TrainState) -> list[torch.Tensor]:
    return ([getattr(state.params, name) for name in PARAM_DIMS] + [state.alive]
            + [state.adam_m[name] for name in PARAM_DIMS]
            + [state.adam_v[name] for name in PARAM_DIMS]
            + [state.uv_grad_accum, state.accum_dur])


def _mode_key() -> tuple:
    """What ``exact_mode`` binds here now: a graph captured in one mode is
    not replayed in the other."""
    return tuple(tuple(sorted(getattr(fn, "keywords", {}).items()))
                 for fn in (build_tile_tables, rasterize))


def _tensors_of(out) -> list[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, tuple):
        return [t for x in out for t in _tensors_of(x)]
    return []


class _Graphed:
    """One StepStatics' step or render as a CUDA graph on the card.

    A graph holds the state's tensors at their addresses (the step updates
    them in place), so it belongs to one state: a call whose state tensors
    (addresses and shapes) or mode differ from the capture's drops the
    graph and starts again. The first call for a state runs eagerly on a
    side stream: PyTorch's warm-up before a capture, and the step itself,
    so no optimizer update is made twice. The second captures ``fn`` over
    static input buffers and replays it; later calls copy their inputs into
    the buffers (a device copy, or a fill for a number) and replay, with no
    host read. Each replay adds the launches the capture recorded
    (``_build.recording``). A capture that fails raises.
    """

    captures = 0  # made by every _Graphed of the process

    def __init__(self):
        self.warm_key = None  # the state and mode of the eager first call
        self.free()

    def free(self) -> None:
        """Drop the graph, its memory pool and its buffers."""
        self.graph, self.key, self.bufs, self.outputs, self.counted = None, None, {}, None, {}

    def run(self, tensors: list[torch.Tensor], fn, inputs: dict):
        """``fn(**inputs)``, through the graph of the state ``tensors``.
        ``inputs`` maps names to device tensors or numbers."""
        from ..kernels import _build

        key = (tuple((t.data_ptr(), tuple(t.shape)) for t in tensors), _mode_key())
        if self.graph is None or self.key != key:
            self.free()
            dev = tensors[0].device
            if self.warm_key != key:
                self.warm_key = key
                here = torch.cuda.current_stream(dev)
                side = torch.cuda.Stream(dev)
                side.wait_stream(here)
                with torch.cuda.stream(side):
                    out = fn(**inputs)
                here.wait_stream(side)
                for t in _tensors_of(out):  # made on the side stream, used here
                    t.record_stream(here)
                return out
            self.bufs = {k: v.detach().clone() if isinstance(v, torch.Tensor)
                         else torch.full((), v, dtype=torch.float32, device=dev)
                         for k, v in inputs.items()}
            graph = torch.cuda.CUDAGraph()
            here = torch.cuda.current_stream(dev)
            try:
                with _build.recording() as counted:
                    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                        self.outputs = fn(**self.bufs)
            except BaseException:
                torch.cuda.set_stream(here)  # a failed capture can leave its stream current
                self.free()
                raise
            self.graph, self.counted, self.key = graph, counted, key
            _Graphed.captures += 1
        for name, value in inputs.items():
            buf = self.bufs[name]
            if not isinstance(value, torch.Tensor):
                buf.fill_(value)
            elif value is not buf:
                buf.copy_(value)
        self.graph.replay()
        _build.add_launches(self.counted)
        return self.outputs


# The factories' callables by (kind, StepStatics): each holds its graph.
_CALLABLES: dict[tuple, "_Factory"] = {}


class _Factory:
    """A factory's callable for one StepStatics: eager on the CPU and at
    ``pair_cap=0``, else through its ``_Graphed``."""

    def __init__(self, kind: str, st: StepStatics):
        self.kind, self.st, self.graphed = kind, st, _Graphed()

    def __call__(self, *args):
        st = self.st
        if self.kind == "render":
            params, view, proj, campos, bg = args
            if params.xyz.device.type != "cuda" or not st.pair_cap:
                return render_image(params, view, proj, campos, bg, st)[0]
            dev = params.xyz.device

            def render(view, proj, campos, bg):
                return render_image(params, view, proj, campos, bg, st)[0]

            tensors = [getattr(params, name) for name in PARAM_DIMS] + [params.alive]
            inputs = dict(view=_on(view, dev), proj=_on(proj, dev), campos=_on(campos, dev),
                          bg=bg)
            # The image lives in the graph's pool: the caller gets its own.
            return self.graphed.run(tensors, render, inputs).clone()
        monitored = self.kind == "monitored"
        state, view, proj, campos, gt_image, bg, iteration = args[:7]
        if state.params.xyz.device.type != "cuda" or not st.pair_cap:
            if monitored:
                return monitored_train_step(*args, st)
            return train_step(*args, st)
        dev = state.params.xyz.device

        def step(view, proj, campos, gt_image, bg, iteration, monitor=None):
            if not monitored:
                return train_step(state, view, proj, campos, gt_image, bg, iteration, st)[1]
            _, m, new_monitor = monitored_train_step(state, view, proj, campos, gt_image,
                                                     bg, iteration, monitor, st)
            if torch.cuda.is_current_stream_capturing():
                monitor.copy_(new_monitor)  # the buffer accumulates over replays
                new_monitor = monitor
            return m, new_monitor

        inputs = dict(view=_on(view, dev), proj=_on(proj, dev), campos=_on(campos, dev),
                      gt_image=gt_image, bg=bg, iteration=iteration)
        if monitored:
            inputs["monitor"] = args[7]
        out = self.graphed.run(_state_tensors(state), step, inputs)
        m, new_monitor = out if monitored else (out, None)
        # The metrics are the graph's output buffers: the caller gets its
        # own copies, as the reference's step returns new arrays.
        m = StepMetrics(*(x.clone() if isinstance(x, torch.Tensor) else x for x in m))
        return (state, m, new_monitor) if monitored else (state, m)


def _on(x, device):
    """A tensor or a number as it is; a host array onto ``device`` (a host
    copy: a step with no host read takes the camera on the card)."""
    if isinstance(x, (torch.Tensor, int, float)):
        return x
    return _as_f32(x, device)


def _factory(kind: str, st: StepStatics) -> _Factory:
    if (kind, st) not in _CALLABLES:
        _CALLABLES[(kind, st)] = _Factory(kind, st)
    return _CALLABLES[(kind, st)]


def get_train_step(st: StepStatics):
    """``train_step`` for one StepStatics: ``fn(state, view, proj, campos,
    gt_image, bg, iteration) -> (state, metrics)``; on the card at a pair
    cap, through a CUDA graph (``_Graphed``), the metrics copied out of
    it. ``view``, ``proj``, ``campos`` and ``gt_image`` are best device
    tensors, ``bg`` and ``iteration`` numbers or device tensors: then a
    call reads no host memory."""
    return _factory("train", st)


def get_monitored_train_step(st: StepStatics):
    """``monitored_train_step`` for one StepStatics: ``fn(state, view,
    proj, campos, gt_image, bg, iteration, monitor) -> (state, metrics,
    monitor)``. As ``get_train_step``; through a graph the returned
    monitor is the graph's buffer, which the next call takes back as it
    is (a fresh monitor is copied into it)."""
    return _factory("monitored", st)


def get_render_fn(st: StepStatics):
    """``render_image``'s image for one StepStatics: ``fn(params, view,
    proj, campos, bg) -> (H, W, 3)``; on the card at a pair cap through a
    CUDA graph, the image copied out of it."""
    return _factory("render", st)


def release_graphs() -> None:
    """Free the factories' graphs: a graph's activations stay in its own
    memory pool, so the graphs of statics that no longer run are dropped
    (the trainer calls this when its capacities, SH band or capacity
    change)."""
    for factory in _CALLABLES.values():
        factory.graphed.free()
    _CALLABLES.clear()


def graph_captures() -> int:
    """CUDA graph captures the factories have made in this process."""
    return _Graphed.captures
