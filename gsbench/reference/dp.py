"""One step of data-parallel training over a batch of B cameras, as the
measured dp step defines it (``--dp B``: one camera a rank, the state
replicated).

Every camera's loss and gradients are taken at the same state, by the
operations of ``step.train_step`` up to Adam (``camera_grads``). The batch
then averages the cameras' gradients and their uv gradients, updates the
Gaussians that any camera sees (the union of the cameras' masks) by
``step.adam``, adds each camera's uv-gradient norm to ``uv_accum`` over the
union and the number of cameras that see a Gaussian to ``dur``, and
returns the mean of the cameras' losses.

Plain PyTorch in float32 (TF32 off, ``gaussians.full_f32``); it imports
nothing of the program. It departs from the port's step in one way: it
sums the B cameras' gradients in camera order, where the port sums them in
its all-reduce's order, so the two differ by rounding.
"""

from __future__ import annotations

import torch

from . import binning, raster, step
from .gaussians import PARAMS, Statics, full_f32, pack_attrs, per_gaussian
from .loss import loss_and_grad


def camera_grads(state: step.State, view, proj, campos, gt, bg: float, st: Statics,
                 low: bool = False, loss_rows: slice = slice(None)) -> tuple:
    """One camera's (loss, {leaf: gradient}, uv gradient, mask) at ``state``,
    as ``step.train_step`` computes them before Adam."""
    leaves = {k: state.params[k].detach().requires_grad_() for k in PARAMS}
    probe = torch.zeros((state.alive.shape[0], 2), device=gt.device, requires_grad=True)
    with torch.enable_grad():
        uv, conic, rgb, mask, radius, z = per_gaussian(leaves, state.alive, view, proj, campos,
                                                       st, low)
        uv = uv + probe
        attrs = pack_attrs(uv, conic, rgb, leaves["opacity"])
    a0 = attrs.detach()
    with torch.no_grad():
        tables = binning.bin_tiles(uv.detach(), z.detach(), radius, mask, st.tiles_x,
                                   st.tiles_y, st.tile)
        out = raster.forward(a0, tables, bg, st.tiles_x, st.tiles_y)
        image = raster.to_image(out[:, :3], st.tiles_x, st.tiles_y, st.width, st.height)
        loss, d_image = loss_and_grad(image, gt, st.ssim_frac, loss_rows)
        rows = raster.backward_rows(a0, tables, out, raster.to_tiles(d_image, st.tiles_x,
                                                                     st.tiles_y),
                                    bg, st.tiles_x, st.tiles_y)
        d_attrs = torch.zeros_like(a0).index_add_(0, tables.gid, rows)
        del rows, out
    got = torch.autograd.grad(attrs, [leaves[k] for k in PARAMS] + [probe], d_attrs,
                              allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(PARAMS, got)}
    return float(loss), grads, got[-1], mask


def batch_step(state: step.State, cams: list, gts: list, bg: float, it: int, st: Statics,
               low: bool = False, loss_rows: slice = slice(None)) -> float:
    """One step over the cameras ``cams`` ((view, proj, campos) each) and
    their ground truths ``gts``, ``state`` updated in place; returns the
    mean loss. ``low`` and ``loss_rows`` are ``step.train_step``'s."""
    full_f32()
    b = len(cams)
    losses, total, g_uv, norms, visible = [], None, None, None, None
    for (view, proj, campos), gt in zip(cams, gts):
        loss, grads, guv, mask = camera_grads(state, view, proj, campos, gt, bg, st, low,
                                              loss_rows)
        norm = torch.sqrt(torch.sum(guv * guv, dim=1))
        seen = mask.to(torch.int32)
        losses.append(loss)
        if total is None:
            total, g_uv, norms, visible = grads, guv, norm, seen
        else:
            total = {k: total[k] + grads[k] for k in PARAMS}
            g_uv, norms, visible = g_uv + guv, norms + norm, visible + seen
    union = visible > 0
    uv_accum, dur = state.uv_accum, state.dur
    step.adam(state, {k: g / b for k, g in total.items()}, g_uv / b, union, it, st)
    state.uv_accum = torch.where(union, uv_accum + norms, uv_accum)
    state.dur = dur + visible
    return sum(losses) / b
