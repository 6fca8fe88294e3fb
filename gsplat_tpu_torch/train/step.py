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

Everything runs eagerly (no jit); binning syncs the host twice per frame
to size its outputs exactly, so the reference's ``overflow`` and
``row_overflow`` metrics have no counterpart. The uv-gradient statistic of
densification comes from a zero probe added to uv before rasterization:
its gradient is exactly the reference's scaled ``grad_uv``.
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

    The reference's ``pair_cap``, ``row_cap``, ``chunk`` and ``interpret``
    are gone: binning sizes every frame exactly and the kernels pick their
    own blocking.
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


@torch.no_grad()
def render_image(
    params: GaussianParams, view, proj, campos, bg: float, st: StepStatics
) -> tuple[torch.Tensor, TileTables]:
    """Forward-only render of one camera: ((H, W, 3) image, tile tables).

    ``view``/``proj`` (4, 4) and ``campos`` (3,) may be numpy arrays or
    tensors; they are moved to the parameters' device.
    """
    dev = params.xyz.device
    view, proj, campos = (_as_f32(x, dev) for x in (view, proj, campos))
    uv, conic, rgb, mask, radius, z = _per_gaussian(params, view, proj, campos, st)
    tables = build_tile_tables(
        uv, z, radius, mask,
        num_tiles_x=st.num_tiles_x, num_tiles_y=st.num_tiles_y, tile_size=st.tile,
    )
    out = rasterize(
        uv, conic, rgb, params.opacity, tables, bg,
        width=st.width, height=st.height, tile=st.tile,
    )
    return out.image, tables


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    psnr: torch.Tensor
    num_visible: torch.Tensor
    num_pairs: int


def compute_loss_and_grads(
    params: GaussianParams, view, proj, campos, gt_image: torch.Tensor,
    bg: float, st: StepStatics,
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
        tables = build_tile_tables(
            uv.detach(), z.detach(), radius, mask,
            num_tiles_x=st.num_tiles_x, num_tiles_y=st.num_tiles_y, tile_size=st.tile,
        )
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


@torch.no_grad()
def apply_adam(
    state: TrainState,
    grads: dict[str, torch.Tensor],
    g_uv: torch.Tensor,
    mask: torch.Tensor,
    iteration: int,
    st: StepStatics,
    visible_count: torch.Tensor | None = None,
    g_norm: torch.Tensor | None = None,
) -> TrainState:
    """Masked Adam update and densification accumulators, in place.

    The reference returns a new state; updating in place here saves a copy
    of the parameters and moments. The xyz learning rate decays
    exponentially and is scaled by ``scene_extent``; with ``l_max == 0``
    SH is not optimized. ``visible_count`` (N_cap,) int32 and ``g_norm``
    (N_cap,), the per-camera visibility counts and uv-gradient norms summed
    over a camera batch, generalize the accumulators to data-parallel
    batches; by default they are the single camera's ``mask`` and
    ``|g_uv|``.
    """
    dev = g_uv.device
    it = torch.tensor(float(iteration), dtype=torch.float32, device=dev)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    bias1 = 1.0 - torch.pow(f32(adam_ops.B1), it + 1.0)
    bias2 = 1.0 - torch.pow(f32(adam_ops.B2), it + 1.0)
    decay = torch.pow(f32(st.xyz_lr_final / st.xyz_lr_init), it / float(st.num_iters))
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
    state: TrainState, view, proj, campos, gt_image: torch.Tensor, bg: float,
    iteration: int, st: StepStatics,
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
    )
    return state, metrics
