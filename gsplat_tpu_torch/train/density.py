"""Adaptive density control: prune, clone and split, opacity reset, Morton
re-sort (port of ``gsplat_tpu/train/density.py``).

The reference's semantics over a fixed capacity:

- average uv gradient = accumulated norm / visible steps;
- prune when the opacity logit is below ``logit(delete_opacity_threshold)``
  or the largest scale exceeds 0.1 x scene extent, unless the Gaussian
  qualifies for densification (gradient above the threshold and largest
  scale / 1.6 within 0.1 x extent);
- clone a kept Gaussian whose gradient is above the threshold and whose
  largest scale is at most 0.01 x extent; split it when larger;
- skip the whole step when the result would exceed ``max_gaussians``;
  report ``needs_grow`` when it would exceed the capacity;
- new layout ``[kept | clones | split children x2]``; moments move with
  kept rows and are zero for new ones; split children are the parent's
  centre plus ``R(quat) (noise * exp(scale))`` with scale
  ``log(exp(scale) / split_scale_factor)``;
- the accumulators reset on every call.

Differences by design. The reference draws the split noise with JAX's
threefry inside the step; here the caller passes the two (N_cap, 3)
standard-normal draws (``split_noise`` makes them from a
``torch.Generator``). The reference returns a new state; here a step that
applies rewrites the state's tensors in place (``copy_`` under
``no_grad``), as ``apply_adam`` does, and ``morton_sort`` permutes them in
place. A step that needs a larger capacity changes nothing in the state it
was given, so the caller can grow it and run the step again.

Mip-Splatting's ``filter_3d`` moves with its rows (a clone or split child
takes its parent's); the trainer recomputes it after the step. The
opacity prune reads the raw opacity, as the published code's
``densify_and_prune`` does.

``morton_sort`` orders the rows by their Morton codes with the radix sort
(``kernels/sort.py``, call site ``"morton"``); being stable, it gives the
reference's stable argsort.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..kernels.sort import radix_sort
from ..ops import mip
from ..ops.morton import KEY_BITS, morton_codes
from .state import PARAM_DIMS, TrainState


@dataclasses.dataclass(frozen=True)
class DensityStatics:
    scene_extent: float
    uv_grad_threshold: float
    delete_opacity_threshold: float
    split_scale_factor: float
    max_gaussians: int
    # strict_reference=False extensions (dead flags in the reference):
    use_split: bool = True
    use_clone: bool = True
    use_delete: bool = True


class DensityInfo(NamedTuple):
    new_total: int  # alive rows after the step (before it if not applied)
    num_pruned: int
    num_cloned: int
    num_split: int
    applied: bool  # False if skipped (max_gaussians, nothing to do, capacity)
    needs_grow: bool  # exceeds the capacity: grow the state and rerun


def split_noise(state: TrainState, seed: int, iteration: int):
    """The two (N_cap, 3) standard-normal draws of a density step, from a
    ``torch.Generator`` on the state's device seeded with
    ``seed * 1_000_003 + iteration`` (the reference's key)."""
    dev = state.alive.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed * 1_000_003 + iteration)
    shape = (state.capacity, 3)
    return (torch.randn(shape, generator=gen, device=dev),
            torch.randn(shape, generator=gen, device=dev))


def _quat_rotate(quat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Rotate (N, 3) vectors by (N, 4) (w, x, y, z) quaternions,
    rsqrt-normalized."""
    inv = torch.rsqrt(torch.sum(quat * quat, dim=1))
    w, x, y, z = (quat[:, i] * inv for i in range(4))
    x2, y2, z2 = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1 - 2 * (y2 + z2), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (x2 + z2), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (x2 + y2),
        ],
        dim=1,
    ).reshape(-1, 3, 3)
    return torch.einsum("nij,nj->ni", r, vec)


@torch.no_grad()
def adaptive_density_step(
    state: TrainState,
    ds: DensityStatics,
    noise0: torch.Tensor,
    noise1: torch.Tensor,
) -> tuple[TrainState, DensityInfo]:
    """One prune/clone/split step; ``noise0``/``noise1`` (N_cap, 3) are the
    split children's standard-normal draws. Returns (state, info): the
    given state updated in place, or, when ``info.needs_grow``, a state
    that shares its tensors but has fresh zero accumulators. Reads the
    counts on the host once."""
    p = state.params
    alive = state.alive
    acc, dur = state.uv_grad_accum, state.accum_dur
    avg_grad = torch.where(dur > 0, acc / torch.clamp(dur, min=1).to(torch.float32), 0.0)
    exp_scale = torch.exp(p.scale)
    scale_max = exp_scale.amax(dim=1)

    max_scale = ds.scene_extent * 0.1
    clone_scale_thr = ds.scene_extent * 0.01
    op_thr = math.log(ds.delete_opacity_threshold) - math.log(
        1.0 - ds.delete_opacity_threshold
    )

    densify_exempt = (avg_grad > ds.uv_grad_threshold) & (scale_max / 1.6 <= max_scale)
    prune = (p.opacity < op_thr) | (~densify_exempt & (scale_max > max_scale))
    if not ds.use_delete:
        prune = torch.zeros_like(prune)
    prune = prune & alive
    densify = (avg_grad > ds.uv_grad_threshold) & ~prune & alive
    clone = densify & (scale_max <= clone_scale_thr)
    split = densify & (scale_max > clone_scale_thr)
    if not ds.use_clone:
        clone = torch.zeros_like(clone)
    if not ds.use_split:
        split = torch.zeros_like(split)
    keep = alive & ~(prune | split)

    n_keep, n_clone, n_split, n_prune, n_alive = torch.stack(
        [keep.sum(), clone.sum(), split.sum(), prune.sum(), alive.sum()]).tolist()
    new_total = n_keep + n_clone + 2 * n_split
    exceeds_max = new_total > ds.max_gaussians
    nothing = n_clone + 2 * n_split == 0 and n_prune == 0
    needs_grow = not exceeds_max and new_total > state.capacity
    apply = not (exceeds_max or nothing or needs_grow)
    info = DensityInfo(new_total if apply else n_alive, n_prune, n_clone, n_split,
                       apply, needs_grow)
    if needs_grow:
        return dataclasses.replace(state, uv_grad_accum=torch.zeros_like(acc),
                                   accum_dur=torch.zeros_like(dur)), info
    if apply:
        _rebuild(state, keep, clone, split, exp_scale, noise0, noise1, ds)
    acc.zero_()
    dur.zero_()
    return state, info


def _rebuild(state, keep, clone, split, exp_scale, noise0, noise1, ds) -> None:
    """Write the layout ``[kept | clones | split children x2]`` into the
    state's tensors; rows past it become zero and not alive."""
    p = state.params
    keep_i, clone_i, split_i = (m.nonzero()[:, 0] for m in (keep, clone, split))
    n_keep, total = keep_i.shape[0], keep_i.shape[0] + clone_i.shape[0] + 2 * split_i.shape[0]
    first_child = total - 2 * split_i.shape[0]
    src = torch.cat([keep_i, clone_i, split_i.repeat_interleave(2)])
    e = exp_scale[split_i]
    for name in PARAM_DIMS:
        t = getattr(p, name)
        new = t[src]
        if name == "xyz":
            q = p.quat[split_i]
            for j, noise in enumerate((noise0, noise1)):
                new[first_child + j::2] = t[split_i] + _quat_rotate(q, noise[split_i] * e)
        elif name == "scale":
            new[first_child:] = torch.log(e / ds.split_scale_factor).repeat_interleave(2, dim=0)
        t[:total] = new
        t[total:] = 0
    if p.filter_3d is not None:  # the trainer sweeps again after the step
        p.filter_3d[:total] = p.filter_3d[src]
        p.filter_3d[total:] = 0
    for moments in (state.adam_m, state.adam_v):
        for m in moments.values():
            m[:n_keep] = m[keep_i]
            m[n_keep:] = 0
    state.alive.copy_(torch.arange(state.capacity, device=state.alive.device) < total)


@torch.no_grad()
def morton_sort(state: TrainState) -> TrainState:
    """Permute every per-Gaussian tensor, in place, into Morton order of
    the alive rows' centres. Dead rows key to the largest code, so the
    alive rows stay a contiguous prefix."""
    codes = morton_codes(state.params.xyz, state.alive)
    order = radix_sort(codes, KEY_BITS, site="morton")[1].long()
    tensors = [getattr(state.params, name) for name in PARAM_DIMS]
    tensors += [*state.adam_m.values(), *state.adam_v.values(), state.alive,
                state.uv_grad_accum, state.accum_dur]
    if state.params.filter_3d is not None:
        tensors.append(state.params.filter_3d)
    for t in tensors:
        t.copy_(t[order])
    return state


@torch.no_grad()
def reset_opacity(state: TrainState, reset_value: float) -> TrainState:
    """Alive opacities := logit(reset_value); the opacity moments and the
    accumulators are zeroed. In place.

    With Mip-Splatting's ``filter_3d`` the reset is the published one
    (``reset_opacity`` of its ``gaussian_model.py``): the filtered opacity
    ``sigmoid(o) c`` (``c`` the 3D filter's factor) becomes ``min(sigmoid(o)
    c, reset_value)`` and the raw one that over ``c``."""
    op = state.params.opacity
    if state.params.filter_3d is not None:
        coef = mip.opacity_scale_3d(state.params.scale, state.params.filter_3d)
        target = torch.clamp(torch.sigmoid(op) * coef, max=reset_value) / coef
        new = torch.log(target) - torch.log(1.0 - target)
    else:
        logit = math.log(reset_value) - math.log(1.0 - reset_value)
        new = torch.tensor(logit, dtype=torch.float32, device=op.device)
    op.copy_(torch.where(state.alive, new, op))
    state.adam_m["opacity"].zero_()
    state.adam_v["opacity"].zero_()
    state.uv_grad_accum.zero_()
    state.accum_dur.zero_()
    return state


@torch.no_grad()
def zero_sh(state: TrainState) -> TrainState:
    """The l_max 0 -> 1 transition zeroes the SH coefficients. In place."""
    state.params.sh.zero_()
    return state
