"""One camera's tile rows sharded over ``torch.distributed`` ranks (port
of ``gsplat_tpu/parallel/tile_parallel.py``).

Rank d of D renders strip d: ``strip_rows`` whole tile rows starting at
row ``d * strip_rows``, the last strip padded past the image. Every rank
runs the per-Gaussian forward on the replicated parameters, shifts uv into
the strip's coordinates, and bins and rasterizes only its strip, at the
StepStatics' pair and row caps as the reference bins each strip (or sized
exactly at ``pair_cap=0``); binning's ``row_limit`` keeps the last strip's
padding rows out, so the strips' pair sets together are the whole
frame's. The strips are all-gathered (without autograd) and every rank
computes the fused loss on the whole image.

The gradient is the single-camera step's: every rank takes d(loss)/d(image)
on the whole image, back-propagates its own rows of it through its strip's
render, and the ranks sum the parameter gradients and the uv gradient. The
reference reaches the same sum through the all-gather's transpose and a
``pmean``. ``torch.distributed.nn``'s differentiable all-gather is not used:
its backward needs an all-to-all, which gloo does not offer.

The uv-gradient scale is the global image's unpadded (W, H), as in the
reference (``grad_scale_wh``): where the tile grid pads the image, the uv
gradient differs from the single-camera step's by W / W_pad and H / H_pad
(ROADMAP R10).

The single step's pieces (``probed_forward``, ``tile_tables``,
``probed_grads``) make the step, which stamps every stage of the
``"step"`` clock: the all-gather falls in ``loss``, ``sum_over_ranks`` in
``adam``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..ops.loss import compute_psnr, fused_loss
from ..ops.render import rasterize
from ..train.state import GaussianParams, TrainState
from ..train.step import (
    StepMetrics, StepStatics, apply_adam, factory_callable, probed_forward, probed_grads,
    tile_tables)
from ..utils import profiling
from . import comm


def strip_rows(st: StepStatics, n_ranks: int) -> int:
    """Tile rows of each strip."""
    return (st.num_tiles_y + n_ranks - 1) // n_ranks


@functools.lru_cache(maxsize=None)
def _strip_shift(device: torch.device, y_off: float) -> torch.Tensor:
    """(2,) float32 [0, y_off] on ``device``, made once by fills: the uv
    shift into a strip's coordinates, which a captured step reads and
    does not build from host values."""
    shift = torch.zeros(2, dtype=torch.float32, device=device)
    shift[1] = y_off
    return shift


class StripGrads(NamedTuple):
    """One camera's loss, image and gradients, the same on every rank."""

    loss: torch.Tensor
    psnr: torch.Tensor
    image: torch.Tensor  # (H, W, 3), gathered from the strips
    grads: dict  # name -> gradient
    g_uv: torch.Tensor  # (N_cap, 2)
    mask: torch.Tensor  # (N_cap,) bool: visible on any rank
    num_pairs: torch.Tensor  # () int32, summed over the strips
    overflow: torch.Tensor  # () int32, max over the strips: the pair requirement
    row_overflow: torch.Tensor  # () int32, max over the strips: the row requirement


def tp_loss_and_grads(params: GaussianParams, view, proj, campos, gt_image: torch.Tensor,
                      bg, st: StepStatics, group=None) -> StripGrads:
    """This rank's strip forward, the whole image's loss, this rank's strip
    backward, then the sums over the strips. ``bg`` is a number or a ()
    float32 device tensor."""
    if st.mip:
        raise ValueError("the tile-parallel step does not run Mip-Splatting (MipStepStatics)")
    d, n_ranks = dist.get_rank(group), dist.get_world_size(group)
    rows_local = strip_rows(st, n_ranks)
    h_local = rows_local * st.tile
    with torch.enable_grad():
        probe, uv, conic, rgb, mask, radius, z, _ = probed_forward(
            params, view, proj, campos, st)
        uv_l = uv - _strip_shift(params.xyz.device, float(d * h_local))
        tables = tile_tables(
            uv_l.detach(), z.detach(), radius, mask, st, rows=rows_local,
            row_limit=min(max(st.num_tiles_y - d * rows_local, 0), rows_local))
        strip = rasterize(
            uv_l, conic, rgb, params.opacity, tables, bg,
            width=st.width, height=h_local, tile=st.tile,
            grad_scale_wh=(st.width, st.height),
        ).image
        profiling.stage_done("raster_fwd")
        image = comm.all_gather_rows(strip, group)[: st.height].detach().requires_grad_(True)
        loss = fused_loss(image, gt_image, st.ssim_frac)
        (d_image,) = torch.autograd.grad(loss, image)
        d_strip = torch.zeros_like(strip)
        mine = d_image[d * h_local:(d + 1) * h_local]
        d_strip[: mine.shape[0]] = mine
        grads, g_uv = probed_grads(strip, params, probe, grad_outputs=d_strip)
    image = image.detach()
    summed, (g_uv,), scalars, visible_count, counts = comm.sum_over_ranks(
        grads, [g_uv], [loss.detach(), compute_psnr(image, gt_image)], mask,
        [tables.num_pairs, tables.overflow, tables.row_overflow], group)
    # Every rank computed the same loss; rank 0's slot is the one all read.
    overflow, row_overflow = counts[1:].amax(dim=1)
    return StripGrads(loss=scalars[0, 0], psnr=scalars[1, 0], image=image, grads=summed,
                      g_uv=g_uv, mask=visible_count > 0, num_pairs=counts[0].sum(),
                      overflow=overflow, row_overflow=row_overflow)


def tp_train_step(
    state: TrainState, view, proj, campos, gt_image: torch.Tensor, bg,
    iteration, st: StepStatics, group=None,
) -> tuple[TrainState, StepMetrics]:
    """One optimizer step on one camera, its tile rows sharded over the
    group's ranks; updates ``state`` in place. ``bg`` and ``iteration`` are
    numbers or () device tensors. Metrics, as the reference's: loss and
    PSNR of the whole image, the Gaussians any strip sees, the strips'
    pairs summed and the largest strip's pair and row requirements, all on
    the device."""
    r = tp_loss_and_grads(state.params, view, proj, campos, gt_image, bg, st, group)
    apply_adam(state, r.grads, r.g_uv, r.mask, iteration, st)
    return state, StepMetrics(loss=r.loss, psnr=r.psnr,
                              num_visible=torch.sum(r.mask.to(torch.int32)),
                              num_pairs=r.num_pairs, overflow=r.overflow,
                              row_overflow=r.row_overflow)


def get_tp_train_step(st: StepStatics, group=None):
    """``tp_train_step`` for one StepStatics and process group (the
    reference's factory, the group in the place of its mesh): ``fn(state,
    view, proj, campos, gt_image, bg, iteration) -> (state, metrics)``. On
    the card, at a pair cap and over NCCL, the whole step (the strip's
    forward, the all-gather and the loss, the backward, the all-reduces,
    Adam) runs as one CUDA graph, as ``data_parallel.get_dp_train_step``'s;
    else eagerly."""
    return factory_callable(("tp", st, group),
                            capturable=functools.partial(comm.capturable, group),
                            step=functools.partial(tp_train_step, group=group))


def get_monitored_tp_train_step(st: StepStatics, group=None):
    """``get_tp_train_step`` with the trainer's on-device monitor, as the
    reference's: ``fn(state, view, proj, campos, gt_image, bg, iteration,
    monitor) -> (state, metrics, monitor)``."""
    return factory_callable(("tp_monitored", st, group), monitored=True,
                            capturable=functools.partial(comm.capturable, group),
                            step=functools.partial(tp_train_step, group=group))

