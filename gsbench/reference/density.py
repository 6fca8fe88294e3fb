"""Adaptive density control at a print boundary, as the trainer applies it.

Average uv gradient = accumulated norm / visible steps. Prune an alive
Gaussian whose opacity logit is under logit(delete threshold), or whose
largest scale exceeds 0.1 x the scene extent unless it qualifies for
densification (gradient over the threshold, largest scale / 1.6 within
0.1 x extent); of the kept ones with a gradient over the threshold, clone
those whose largest scale is at most 0.01 x extent and split the larger.
Skip the step past ``max_gaussians``. The layout is ``[kept | clones |
split children x2]``: moments move with the kept rows, new rows get none;
a split child is the parent's centre plus R(quat) (noise * exp(scale)),
its scale log(exp(scale) / split factor). The accumulators reset. The
split noise is two standard-normal (capacity, 3) draws of a
``torch.Generator`` seeded with seed * 1_000_003 + iteration, at the
capacity the step runs at (grown when the result does not fit).

``morton_codes``: 10 bits an axis over the alive rows' bounding box,
interleaved; the trainer re-sorts its rows by them after the step.
"""

from __future__ import annotations

import math

import torch

from .gaussians import PARAMS
from .init import capacity
from .step import State

MORTON_MAX = (1 << 10) - 1


def split_noise(cap: int, seed: int, iteration: int, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + iteration)
    return tuple(torch.randn((cap, 3), generator=gen, device=device) for _ in range(2))


def _rotate(quat, vec):
    inv = torch.rsqrt(torch.sum(quat * quat, dim=1))
    w, x, y, z = (quat[:, i] * inv for i in range(4))
    r = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                    dim=1).reshape(-1, 3, 3)
    return torch.einsum("nij,nj->ni", r, vec)


@torch.no_grad()
def step(s: State, train: dict, extent: float, seed: int, iteration: int) -> dict:
    """Apply one step to ``s`` (its rows rewritten, not re-sorted); returns
    the counts of pruned, cloned and split Gaussians."""
    p, alive = s.params, s.alive
    avg = torch.where(s.dur > 0, s.uv_accum / torch.clamp(s.dur, min=1).to(torch.float32), 0.0)
    e = torch.exp(p["scale"])
    smax = e.amax(dim=1)
    thr = train["delete_opacity_threshold"]
    grad_thr = train["uv_grad_threshold"]
    exempt = (avg > grad_thr) & (smax / 1.6 <= 0.1 * extent)
    prune = ((p["opacity"] < math.log(thr) - math.log(1.0 - thr))
             | (~exempt & (smax > 0.1 * extent))) & alive
    densify = (avg > grad_thr) & ~prune & alive
    clone = densify & (smax <= 0.01 * extent)
    split = densify & (smax > 0.01 * extent)
    keep = alive & ~(prune | split)
    counts = dict(pruned=int(prune.sum()), cloned=int(clone.sum()), split=int(split.sum()))
    total = int(keep.sum()) + counts["cloned"] + 2 * counts["split"]
    cap = alive.shape[0]
    s.uv_accum, s.dur = torch.zeros_like(s.uv_accum), torch.zeros_like(s.dur)
    if total > train["max_gaussians"] or not (counts["cloned"] or counts["split"]
                                              or counts["pruned"]):
        return counts
    if total > cap:  # the trainer grows the state first
        cap = min(capacity(total, minimum=2 * cap), capacity(train["max_gaussians"]))
    noise = split_noise(cap, seed, iteration, alive.device)
    keep_i, clone_i, split_i = (m.nonzero()[:, 0] for m in (keep, clone, split))
    src = torch.cat([keep_i, clone_i, split_i.repeat_interleave(2)])
    first = total - 2 * split_i.shape[0]
    es = e[split_i]

    def rows(t, new_tail=None):
        out = torch.zeros((cap,) + t.shape[1:], device=t.device)
        out[:total] = t[src] if new_tail is None else torch.cat([t[keep_i], new_tail])
        return out

    new = {k: rows(p[k]) for k in PARAMS}
    for j in range(2):
        new["xyz"][first + j:total:2] = p["xyz"][split_i] + _rotate(p["quat"][split_i],
                                                                    noise[j][split_i] * es)
    new["scale"][first:total] = torch.log(es / train["split_scale_factor"]).repeat_interleave(
        2, dim=0)
    n_new = total - keep_i.shape[0]
    for moments in (s.m, s.v):
        for k in PARAMS:
            t = moments[k]
            moments[k] = rows(t, torch.zeros((n_new,) + t.shape[1:], device=t.device))
    s.params = new
    s.alive = torch.arange(cap, device=alive.device) < total
    s.uv_accum = torch.zeros(cap, device=alive.device)
    s.dur = torch.zeros(cap, dtype=torch.int32, device=alive.device)
    return counts


def morton_codes(xyz, mask):
    """(N,) int64 Z-order codes of the rows of ``mask``; the rest last."""
    big = torch.tensor(1e30, device=xyz.device)
    lo = torch.where(mask[:, None], xyz, big).amin(dim=0)
    hi = torch.where(mask[:, None], xyz, -big).amax(dim=0)
    q = torch.clamp((xyz - lo) * (MORTON_MAX / torch.clamp(hi - lo, min=1e-12)), 0,
                    MORTON_MAX).to(torch.int64)
    code = torch.zeros_like(q[:, 0])
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return torch.where(mask, code, torch.full_like(code, 0x7FFFFFFF))


def unsorted_share(xyz, alive) -> float:
    """Share of neighbouring rows out of Morton order, a dead row before an
    alive one counting as out of order."""
    code = morton_codes(xyz, alive)
    if code.shape[0] < 2:
        return 0.0
    return float((code[1:] < code[:-1]).double().mean())
