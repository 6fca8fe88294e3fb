"""Forward render and training step (port of ``gsplat_tpu/train/step.py``).

``render_image`` is the entry point for eval renders and image dumps;
``train_step`` = ``compute_loss_and_grads`` + ``apply_adam`` is one
optimizer step on one camera: per-Gaussian projection, covariance and SH
colour, exact tile binning, the forward rasterizer, the fused SSIM+L1
loss, then autograd back through the rasterizer's custom backward (backward
kernel, segment sum) and the per-Gaussian maths, and a
visibility-masked Adam update. As in the reference, the steps call
``build_tile_tables`` and ``rasterize`` with their defaults, which follow
the package's mode (``kernels/packing.py``): packed by default, the exact
f32 mode inside ``exact_mode()``.

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
fails raises. On the CPU, or with ``pair_cap=0``, they run eagerly. The
dp and tp factories of ``parallel`` are callables of the same kind
(``factory_callable``), captured only where their process group's
collectives can be (NCCL).

The step and the render stamp the tracer's stage clock
(``utils/profiling.py``): a step's stages are geometry, sh, binning,
raster_fwd, loss, raster_bwd (stamped inside ``_Rasterize.backward``),
per_gaussian_bwd and adam (the update, the metrics and the monitor's
fold); a render's the first four. The dp factories stamp a clock of
their own kind, ``"dp"``, whose ``allreduce`` stage (the collectives with
their pack and unpack) lies between per_gaussian_bwd and adam. A graph
captures the stamps, so its replays stamp the card's clock with no host
work.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from ..kernels.adam import masked_adam_update_
from ..kernels.covariance import covariance
from ..kernels.sh import sh_to_rgb
from ..kernels.packing import exact_mode, packed  # noqa: F401  (exact_mode: exported here)
from ..ops import adam as adam_ops
from ..ops import projection
from ..ops.binning import TileTables, build_tile_tables
from ..ops.loss import compute_psnr, fused_loss
from ..ops.render import rasterize
from ..utils import profiling
from .state import PARAM_DIMS, GaussianParams, TrainState


@dataclasses.dataclass(frozen=True)
class StepStatics:
    """Per-geometry constants, under the reference's field names.

    ``pair_cap`` and ``row_cap`` are the reference's capacities; 0 sizes
    binning exactly (eager), and a pair cap with ``row_cap`` 0 derives the
    row cap from it as the reference does. Its ``chunk`` and
    ``interpret`` are gone: the kernels pick their own blocking.
    ``MipStepStatics`` holds the same fields for Mip-Splatting's step.
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

    @property
    def mip(self) -> bool:
        """Whether the step is Mip-Splatting's (``MipStepStatics``)."""
        return False


@dataclasses.dataclass(frozen=True)
class MipStepStatics(StepStatics):
    """StepStatics of Mip-Splatting's step and render (``ops/mip.py``): the
    parameters' ``filter_3d`` and the 2D Mip filter in place of 3DGS's 0.3
    dilation. The fields are StepStatics'; the type is the static switch,
    so a Mip step and a plain step of equal fields are two graphs."""

    @property
    def mip(self) -> bool:
        return True


def mip_statics(st: StepStatics) -> MipStepStatics:
    """``st``'s fields as Mip-Splatting's statics."""
    return MipStepStatics(**dataclasses.asdict(st))


def _per_gaussian(params: GaussianParams, view, proj, campos, st: StepStatics):
    """Dense per-Gaussian forward of plain 3DGS: (uv, conic, rgb, mask,
    radius, z). ``view``/``proj`` (4, 4) and ``campos`` (3,) may be numpy
    arrays or tensors; they are moved to the parameters' device."""
    if st.mip:
        raise ValueError("_per_gaussian has no opacity scale: Mip-Splatting's statics take "
                         "_geometry")
    return _geometry(params, view, proj, campos, st)[:6]


def _geometry(params: GaussianParams, view, proj, campos, st: StepStatics):
    """``_per_gaussian`` and the opacity's scale: (uv, conic, rgb, mask,
    radius, z, opacity_scale). ``opacity_scale`` (N,) multiplies the
    opacity under ``st.mip`` (the 3D filter's factor times the 2D Mip
    filter's); None otherwise."""
    view, proj, campos = (_as_f32(x, params.xyz.device) for x in (view, proj, campos))
    xyz_c = projection.world_to_camera(params.xyz, view)
    uv = projection.project_to_screen(xyz_c, proj, st.width, st.height)
    mask = (
        projection.frustum_cull_mask(
            uv, xyz_c, st.near_thresh, st.cull_padding, st.width, st.height
        )
        & params.alive
    )
    if st.mip and params.filter_3d is None:
        raise ValueError("Mip-Splatting statics need the parameters' filter_3d "
                         "(train/state.py::with_filter_3d)")
    conic, radius, opacity_scale = covariance(
        xyz_c, params.quat, params.scale, params.opacity, view, focal_x=st.focal_x,
        focal_y=st.focal_y, tan_fovx=st.tan_fovx, tan_fovy=st.tan_fovy, mh_dist=st.mh_dist,
        filter_3d=params.filter_3d if st.mip else None)
    profiling.stage_done("geometry")
    rgb = sh_to_rgb(params.xyz, params.rgb, params.sh, campos, st.l_max)
    profiling.stage_done("sh")
    z = xyz_c[:, 2]
    return uv, conic, rgb, mask, radius, z, opacity_scale


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def tile_tables(uv, z, radius, mask, st: StepStatics, rows: int | None = None,
                row_limit: int | None = None) -> TileTables:
    """Binning at the statics' caps, over ``rows`` tile rows (default the
    image's; a tile-parallel strip's) to ``row_limit``; stamps ``binning``."""
    tables = build_tile_tables(
        uv, z, radius, mask,
        num_tiles_x=st.num_tiles_x, num_tiles_y=rows or st.num_tiles_y, tile_size=st.tile,
        row_limit=row_limit, pair_cap=st.pair_cap or None, row_cap=st.row_cap or None,
    )
    profiling.stage_done("binning")
    return tables


@torch.no_grad()
def render_image(
    params: GaussianParams, view, proj, campos, bg, st: StepStatics
) -> tuple[torch.Tensor, TileTables]:
    """Forward-only render of one camera: ((H, W, 3) image, tile tables).

    ``view``/``proj`` (4, 4) and ``campos`` (3,) may be numpy arrays or
    tensors; they are moved to the parameters' device. ``bg`` is a number
    or a () float32 tensor. Stamps the ``"render"`` stage clock.
    """
    with profiling.stage_clock("render", params.xyz.device):
        uv, conic, rgb, mask, radius, z, opacity_scale = _geometry(
            params, view, proj, campos, st)
        tables = tile_tables(uv, z, radius, mask, st)
        out = rasterize(
            uv, conic, rgb, params.opacity, tables, bg,
            width=st.width, height=st.height, tile=st.tile, opacity_scale=opacity_scale,
        )
    return out.image, tables


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    psnr: torch.Tensor
    num_visible: torch.Tensor
    num_pairs: int | torch.Tensor  # a device count at a pair cap
    overflow: torch.Tensor | None = None  # required pair capacity
    row_overflow: torch.Tensor | None = None  # required row capacity


def probed_forward(params: GaussianParams, view, proj, campos, st: StepStatics):
    """``_geometry`` with a zero uv probe added to uv (its gradient is
    the reference's scaled ``grad_uv``), called under ``enable_grad``:
    (probe, uv, conic, rgb, mask, radius, z, opacity_scale)."""
    probe = torch.zeros((params.capacity, 2), dtype=torch.float32, device=params.xyz.device,
                        requires_grad=True)
    uv, *rest = _geometry(params, view, proj, campos, st)
    return (probe, uv + probe, *rest)


def probed_grads(outputs: torch.Tensor, params: GaussianParams, probe: torch.Tensor,
                 grad_outputs=None):
    """Back-propagate ``outputs`` (times ``grad_outputs``) to the parameters
    and the uv probe: ({name: gradient, zeros where a parameter is unused,
    as for SH bands above ``l_max``}, the probe's (N_cap, 2) gradient).
    Stamps ``per_gaussian_bwd``."""
    leaves = [getattr(params, name) for name in PARAM_DIMS]
    got = torch.autograd.grad(outputs, leaves + [probe], grad_outputs=grad_outputs,
                              allow_unused=True)
    grads = {name: torch.zeros_like(leaf) if g is None else g
             for name, leaf, g in zip(PARAM_DIMS, leaves, got)}
    profiling.stage_done("per_gaussian_bwd")
    return grads, got[-1]


def compute_loss_and_grads(
    params: GaussianParams, view, proj, campos, gt_image: torch.Tensor,
    bg, st: StepStatics,
):
    """Forward and backward for one camera.

    Returns (loss, image, mask, tables, grads, g_uv): ``grads`` maps each
    parameter name to its gradient (``probed_grads``); ``g_uv`` (N_cap, 2)
    is the gradient of the uv probe. Dead capacity rows may carry NaN
    gradients, which ``apply_adam`` scrubs. Stamps the ``"step"`` stage
    clock (in a step, the step's clock).
    """
    with profiling.stage_clock("step", params.xyz.device), torch.enable_grad():
        probe, uv, conic, rgb, mask, radius, z, opacity_scale = probed_forward(
            params, view, proj, campos, st)
        tables = tile_tables(uv.detach(), z.detach(), radius, mask, st)
        out = rasterize(
            uv, conic, rgb, params.opacity, tables, bg,
            width=st.width, height=st.height, tile=st.tile, opacity_scale=opacity_scale,
        )
        profiling.stage_done("raster_fwd")
        # "loss" ends, and "raster_bwd" is stamped, in _Rasterize.backward
        loss = fused_loss(out.image, gt_image, st.ssim_frac)
        grads, g_uv = probed_grads(loss, params, probe)
    return loss.detach(), out.image.detach(), mask, tables, grads, g_uv


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
    of the parameters and moments: each group steps in one
    ``kernels/adam.py::masked_adam_update_`` call (on the card, one launch
    of ``csrc/adam.cu``; the bias corrections and the xyz rate stay device
    tensors, so a graph's replay steps at its own iteration). The xyz
    learning rate decays exponentially and is scaled by ``scene_extent``;
    with ``l_max == 0`` SH is not optimized. ``iteration`` is a number or a () device tensor
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
        masked_adam_update_(getattr(state.params, name), grads[name], state.adam_m[name],
                            state.adam_v[name], mask, lrs[name], bias1, bias2)
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
    returns it with the step's metrics. Stamps the ``"step"`` stage clock:
    its last stage, ``adam``, holds the update and the metrics."""
    with profiling.stage_clock("step", state.params.xyz.device):
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
    ``fresh_monitor``. Returns (state, metrics, new monitor). The fold
    ends the stage clock's ``adam`` stage."""
    with profiling.stage_clock("step", state.params.xyz.device):
        state, m = train_step(state, view, proj, campos, gt_image, bg, iteration, st)
        new_monitor = fold_monitor(monitor, m)
    return state, m, new_monitor


def fold_monitor(monitor: torch.Tensor, m: StepMetrics) -> torch.Tensor:
    """The (3,) monitor with one step's metrics folded in, on the device:
    the larger pair and row requirements, and whether every loss so far is
    finite."""
    return torch.stack([
        torch.maximum(monitor[0], m.overflow.to(torch.float32)),
        torch.maximum(monitor[1], m.row_overflow.to(torch.float32)),
        torch.minimum(monitor[2], torch.isfinite(m.loss).to(torch.float32)),
    ])


def fresh_monitor(device: torch.device | str = "cuda") -> torch.Tensor:
    """[0, 0, 1] on ``device``, made by fills (no copy from the host)."""
    monitor = torch.zeros(3, dtype=torch.float32, device=device)
    monitor[2] = 1.0
    return monitor


def _param_tensors(params: GaussianParams) -> list[torch.Tensor]:
    """The tensors a graph of ``params`` reads: the parameters, ``alive``
    and, for Mip-Splatting, ``filter_3d``."""
    return ([getattr(params, name) for name in PARAM_DIMS] + [params.alive]
            + ([] if params.filter_3d is None else [params.filter_3d]))


def _state_tensors(state: TrainState) -> list[torch.Tensor]:
    return (_param_tensors(state.params)
            + [state.adam_m[name] for name in PARAM_DIMS]
            + [state.adam_v[name] for name in PARAM_DIMS]
            + [state.uv_grad_accum, state.accum_dur])


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
    (``_build.recording``) and advances the stage clocks' slots as the
    capture's stamps do (``profiling.recording``). A capture that fails
    raises. The tracer counts eager first calls (``step.eager``) and
    captures (``step.captures``), a render's too, and spans both.
    """

    def __init__(self):
        self.warm_key = None  # the state and mode of the eager first call
        self.free()

    def free(self) -> None:
        """Drop the graph, its memory pool and its buffers."""
        self.graph, self.key, self.bufs, self.outputs = None, None, {}, None
        self.counted, self.advanced = {}, {}

    def run(self, tensors: list[torch.Tensor], fn, inputs: dict):
        """``fn(**inputs)``, through the graph of the state ``tensors``.
        ``inputs`` maps names to device tensors or numbers."""
        from ..kernels import _build

        key = (tuple((t.data_ptr(), tuple(t.shape)) for t in tensors), packed())
        if self.graph is None or self.key != key:
            self.free()
            dev = tensors[0].device
            if self.warm_key != key:
                self.warm_key = key
                profiling.count("step.eager")
                with profiling.span("step.eager"):
                    here = torch.cuda.current_stream(dev)
                    side = torch.cuda.Stream(dev)
                    side.wait_stream(here)
                    with torch.cuda.stream(side):
                        out = fn(**inputs)
                    here.wait_stream(side)
                    for t in _tensors_of(out):  # made on the side stream, used here
                        t.record_stream(here)
                return out
            with profiling.span("step.capture"):
                self.bufs = {k: v.detach().clone() if isinstance(v, torch.Tensor)
                             else torch.full((), v, dtype=torch.float32, device=dev)
                             for k, v in inputs.items()}
                profiling.rings_on(dev)  # the stage clocks' rings stay out of the pool
                graph = torch.cuda.CUDAGraph()
                here = torch.cuda.current_stream(dev)
                try:
                    with _build.recording() as counted, profiling.recording() as advanced:
                        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                            self.outputs = fn(**self.bufs)
                except BaseException:
                    torch.cuda.set_stream(here)  # a failed capture can leave its stream current
                    self.free()
                    raise
            self.graph, self.counted, self.advanced, self.key = graph, counted, advanced, key
            profiling.count("step.captures")
        for name, value in inputs.items():
            buf = self.bufs[name]
            if not isinstance(value, torch.Tensor):
                buf.fill_(value)
            elif value is not buf:
                buf.copy_(value)
        self.graph.replay()
        _build.add_launches(self.counted)
        profiling.advance(self.advanced)
        return self.outputs


# The factories' callables by key, (kind, StepStatics[, process group]):
# each holds its graph.
_CALLABLES: dict[tuple, "_Factory"] = {}


class _Factory:
    """A factory's callable for one StepStatics: eager on the CPU, at
    ``pair_cap=0`` and where ``capturable()`` is false, else through its
    ``_Graphed``. ``step(state, view, proj, campos, gt_image, bg,
    iteration, st) -> (state, metrics)`` is the step it runs
    (``train_step``, or a parallel step bound to its process group), and
    ``monitored`` folds the metrics into the monitor; with no ``step`` it
    is the render. ``clock`` is the kind of stage clock a step stamps
    (``"step"``, or ``"dp"`` for the data-parallel step), and
    ``on_call(state)``, if given, runs on every call of a step outside its
    graph (a replay runs no Python of the step). A call is the span
    ``<clock>.issue`` or ``render.issue``, which carries the slot of the
    call's stage clock: its input copies, the replay and the copies out of
    its outputs."""

    def __init__(self, st: StepStatics, step=None, monitored: bool = False,
                 capturable=None, clock: str = "step", on_call=None):
        self.st, self.step, self.monitored = st, step, monitored
        self.capturable, self.clock, self.on_call = capturable, clock, on_call
        self.graphed = _Graphed()

    def _graphs(self, device: torch.device) -> bool:
        return (device.type == "cuda" and bool(self.st.pair_cap)
                and (self.capturable is None or self.capturable()))

    def __call__(self, *args):
        if self.step is None:
            with profiling.issue_span("render", args[0].xyz.device):
                return self._call(*args)
        if self.on_call is not None:
            self.on_call(args[0])
        with profiling.issue_span(self.clock, args[0].params.xyz.device):
            return self._call(*args)

    def _call(self, *args):
        st = self.st
        if self.step is None:
            params, view, proj, campos, bg = args
            if not self._graphs(params.xyz.device):
                return render_image(params, view, proj, campos, bg, st)[0]
            dev = params.xyz.device

            def render(view, proj, campos, bg):
                return render_image(params, view, proj, campos, bg, st)[0]

            tensors = _param_tensors(params)
            inputs = dict(view=_on(view, dev), proj=_on(proj, dev), campos=_on(campos, dev),
                          bg=bg)
            # The image lives in the graph's pool: the caller gets its own.
            return self.graphed.run(tensors, render, inputs).clone()
        state, view, proj, campos, gt_image, bg, iteration = args[:7]
        dev = state.params.xyz.device
        if not self._graphs(dev):
            with profiling.stage_clock(self.clock, dev):
                state, m = self.step(*args[:7], st)
                return (state, m, fold_monitor(args[7], m)) if self.monitored else (state, m)

        def step(view, proj, campos, gt_image, bg, iteration, monitor=None):
            with profiling.stage_clock(self.clock, dev):
                m = self.step(state, view, proj, campos, gt_image, bg, iteration, st)[1]
                if monitor is None:
                    return m
                new_monitor = fold_monitor(monitor, m)
                if torch.cuda.is_current_stream_capturing():
                    monitor.copy_(new_monitor)  # the buffer accumulates over replays
                    new_monitor = monitor
                return m, new_monitor

        inputs = dict(view=_on(view, dev), proj=_on(proj, dev), campos=_on(campos, dev),
                      gt_image=gt_image, bg=bg, iteration=iteration)
        if self.monitored:
            inputs["monitor"] = args[7]
        out = self.graphed.run(_state_tensors(state), step, inputs)
        m, new_monitor = out if self.monitored else (out, None)
        # The metrics are the graph's output buffers: the caller gets its
        # own copies, as the reference's step returns new arrays.
        m = StepMetrics(*(x.clone() if isinstance(x, torch.Tensor) else x for x in m))
        return (state, m, new_monitor) if self.monitored else (state, m)


def _on(x, device):
    """A tensor or a number as it is; a host array onto ``device`` (a host
    copy: a step with no host read takes the camera on the card)."""
    if isinstance(x, (torch.Tensor, int, float)):
        return x
    return _as_f32(x, device)


def factory_callable(key: tuple, **kw) -> _Factory:
    """The factories' callable for ``key`` (its kind, its StepStatics and
    whatever else tells two apart), made once from ``kw`` (``_Factory``'s
    arguments) and kept until ``release_graphs``."""
    if key not in _CALLABLES:
        _CALLABLES[key] = _Factory(key[1], **kw)
    return _CALLABLES[key]


def get_train_step(st: StepStatics):
    """``train_step`` for one StepStatics: ``fn(state, view, proj, campos,
    gt_image, bg, iteration) -> (state, metrics)``; on the card at a pair
    cap, through a CUDA graph (``_Graphed``), the metrics copied out of
    it. ``view``, ``proj``, ``campos`` and ``gt_image`` are best device
    tensors, ``bg`` and ``iteration`` numbers or device tensors: then a
    call reads no host memory."""
    return factory_callable(("train", st), step=train_step)


def get_monitored_train_step(st: StepStatics):
    """``monitored_train_step`` for one StepStatics: ``fn(state, view,
    proj, campos, gt_image, bg, iteration, monitor) -> (state, metrics,
    monitor)``. As ``get_train_step``; through a graph the returned
    monitor is the graph's buffer, which the next call takes back as it
    is (a fresh monitor is copied into it)."""
    return factory_callable(("monitored", st), step=train_step, monitored=True)


def get_render_fn(st: StepStatics):
    """``render_image``'s image for one StepStatics: ``fn(params, view,
    proj, campos, bg) -> (H, W, 3)``; on the card at a pair cap through a
    CUDA graph, the image copied out of it."""
    return factory_callable(("render", st))


def release_graphs() -> None:
    """Free the factories' graphs: a graph's activations stay in its own
    memory pool, so the graphs of statics that no longer run are dropped
    (the trainer calls this when its capacities, SH band or capacity
    change)."""
    for factory in _CALLABLES.values():
        factory.graphed.free()
    _CALLABLES.clear()


def graph_captures() -> int:
    """CUDA graph captures the factories have made in this process (the
    tracer's counter ``step.captures``)."""
    return profiling.counter("step.captures")
