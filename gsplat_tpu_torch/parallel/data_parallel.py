"""Camera data parallelism over ``torch.distributed`` (port of
``gsplat_tpu/parallel/data_parallel.py``).

A batch of B cameras is spread over the B ranks of a process group, one
camera a rank. Every rank holds the whole state, replicated; it renders
its own camera and back-propagates it (``compute_loss_and_grads``, binning
at the StepStatics' pair and row caps, or sized exactly at
``pair_cap=0``), then the ranks sum (``comm.sum_over_ranks``: one float32
and one int32 buffer):

- the gradients and the uv gradient, divided by B: the loss is the mean of
  the cameras' losses;
- each camera's uv-gradient norm (the densification statistic, taken
  before the mean) and each camera's visibility mask (``visible_count``);
  a Gaussian is updated where any camera sees it (``visible_count > 0``);
- the losses (their mean is the step's), and the pair counts and
  binning's pair and row requirements (the max of each, as the
  reference's ``pmax``).

Then every rank applies the same masked Adam update to the same state, so
the replicas stay bit-identical with no parameter traffic. Dead capacity
rows may carry NaN gradients; they stay dead rows, and ``apply_adam``
scrubs them as in one camera's step.

The factories' steps stamp the tracer's ``"dp"`` stage clock: a step's
stages with ``allreduce`` (the pack, both all-reduces and the unpack)
between per_gaussian_bwd and adam. Each call is a ``dp.issue`` span and
adds the bytes its step all-reduces to the counter ``comm.reduced_bytes``
(``reduced_bytes``), counted outside the step's graph.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..ops.loss import compute_psnr
from ..train.state import GaussianParams, TrainState
from ..train.step import (
    StepMetrics, StepStatics, apply_adam, compute_loss_and_grads, factory_callable)
from ..utils import profiling
from . import comm

# What a dp step reduces besides the parameter gradients: the uv gradient
# and its norm a Gaussian (columns), the loss and PSNR a rank (scalars),
# the pair count and binning's pair and row requirements a rank (counts).
COLUMNS, SCALARS, COUNTS = 3, 2, 3


class BatchGrads(NamedTuple):
    """A camera batch's reduced gradients and statistics (the same on every
    rank), and this rank's own image."""

    loss: torch.Tensor  # mean over the batch
    psnr: torch.Tensor  # mean over the batch
    image: torch.Tensor  # this rank's render
    grads: dict  # name -> mean gradient
    g_uv: torch.Tensor  # (N_cap, 2) mean uv gradient
    g_norm: torch.Tensor  # (N_cap,) sum of the cameras' uv-gradient norms
    visible_count: torch.Tensor  # (N_cap,) int32: cameras that see each Gaussian
    num_pairs: torch.Tensor  # () int32, max over the batch
    overflow: torch.Tensor  # () int32, max over the batch: the pair requirement
    row_overflow: torch.Tensor  # () int32, max over the batch: the row requirement


def dp_loss_and_grads(params: GaussianParams, view, proj, campos, gt_image: torch.Tensor,
                      bg, st: StepStatics, group=None) -> BatchGrads:
    """This rank's camera forward and backward, then the batch's sums.
    ``bg`` is a number or a () float32 device tensor."""
    loss, image, mask, tables, grads, g_uv = compute_loss_and_grads(
        params, view, proj, campos, gt_image, bg, st)
    g_norm = torch.sqrt(torch.sum(g_uv * g_uv, dim=1))
    summed, (g_uv_sum, g_norm_sum), scalars, visible_count, counts = comm.sum_over_ranks(
        grads, [g_uv, g_norm], [loss, compute_psnr(image, gt_image)], mask,
        [tables.num_pairs, tables.overflow, tables.row_overflow], group)
    b = dist.get_world_size(group)
    num_pairs, overflow, row_overflow = counts.amax(dim=1)
    out = BatchGrads(
        loss=scalars[0].sum() / b, psnr=scalars[1].sum() / b, image=image,
        grads={k: g / b for k, g in summed.items()}, g_uv=g_uv_sum / b, g_norm=g_norm_sum,
        visible_count=visible_count, num_pairs=num_pairs, overflow=overflow,
        row_overflow=row_overflow,
    )
    profiling.stage_done("allreduce")
    return out


def reduced_bytes(capacity: int, group=None) -> int:
    """The bytes one dp step SUM-reduces over the group at ``capacity``
    Gaussians: ``comm.sum_over_ranks``'s float and int32 buffers."""
    return comm.reduced_bytes(capacity, COLUMNS, SCALARS, COUNTS, dist.get_world_size(group))


def _count_reduced(group, state: TrainState) -> None:
    profiling.count("comm.reduced_bytes", reduced_bytes(state.params.capacity, group))


def dp_train_step(
    state: TrainState, view, proj, campos, gt_image: torch.Tensor, bg,
    iteration, st: StepStatics, group=None,
) -> tuple[TrainState, StepMetrics]:
    """One replicated optimizer step over the batch of the group's cameras,
    this rank's being (view, proj, campos, gt_image, bg); updates ``state``
    in place. ``bg`` and ``iteration`` are numbers or () device tensors.
    Metrics, as the reference's: the mean loss and PSNR, the Gaussians any
    camera sees, and the largest pair count, pair requirement and row
    requirement of the batch, all on the device."""
    r = dp_loss_and_grads(state.params, view, proj, campos, gt_image, bg, st, group)
    union = r.visible_count > 0
    apply_adam(state, r.grads, r.g_uv, union, iteration, st,
               visible_count=r.visible_count, g_norm=r.g_norm)
    return state, StepMetrics(loss=r.loss, psnr=r.psnr,
                              num_visible=torch.sum(union.to(torch.int32)),
                              num_pairs=r.num_pairs, overflow=r.overflow,
                              row_overflow=r.row_overflow)


def get_dp_train_step(st: StepStatics, group=None):
    """``dp_train_step`` for one StepStatics and process group (the
    reference's factory, the group in the place of its mesh): ``fn(state,
    view, proj, campos, gt_image, bg, iteration) -> (state, metrics)``,
    this rank's camera. On the card, at a pair cap and over NCCL, the
    whole step, its collectives included, runs as one CUDA graph
    (``train.step._Graphed``: an eager first call, then the capture and
    replays; the NCCL communicator is made when the group forms,
    ``initialize_multihost``); over gloo, on the CPU or at ``pair_cap=0`` it
    runs eagerly."""
    return factory_callable(("dp", st, group), **_factory_kw(group))


def get_monitored_dp_train_step(st: StepStatics, group=None):
    """``get_dp_train_step`` with the trainer's on-device monitor, as the
    reference's: ``fn(state, view, proj, campos, gt_image, bg, iteration,
    monitor) -> (state, metrics, monitor)``, the monitor [max pair
    requirement, max row requirement, all losses finite] over the batch's
    reduced metrics, so every rank folds the same values."""
    return factory_callable(("dp_monitored", st, group), monitored=True, **_factory_kw(group))


def _factory_kw(group) -> dict:
    return dict(capturable=functools.partial(comm.capturable, group),
                step=functools.partial(dp_train_step, group=group), clock="dp",
                on_call=functools.partial(_count_reduced, group))
