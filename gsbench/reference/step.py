"""One training step and one render, as the measured entries define them.

A step: the per-Gaussian forward with autograd, a zero probe added to uv
(its gradient is densification's statistic), binning, the forward
rasterizer, the fused loss, the backward rasterizer's rows summed per
Gaussian, autograd back through the per-Gaussian chain, then Adam on the
visible, alive rows only (B1 0.9, B2 0.999, eps 1e-8, NaN gradients as
0, bias corrections from the iteration, the xyz learning rate decayed
exponentially over ``num_iters`` and scaled by the scene extent) and the
densification accumulators.
"""

from __future__ import annotations

import dataclasses

import torch

from . import binning, raster
from .gaussians import PARAMS, Statics, pack_attrs, per_gaussian
from .loss import loss_and_grad

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class State:
    params: dict  # name -> (N, ...) float32
    alive: torch.Tensor  # (N,) bool
    m: dict
    v: dict
    uv_accum: torch.Tensor
    dur: torch.Tensor

    @classmethod
    def fresh(cls, params: dict, alive: torch.Tensor) -> "State":
        def zeros():
            return {k: torch.zeros_like(v) for k, v in params.items()}

        return cls(dict(params), alive, zeros(), zeros(),
                   torch.zeros(alive.shape, device=alive.device),
                   torch.zeros(alive.shape, dtype=torch.int32, device=alive.device))


def render(params: dict, alive, view, proj, campos, bg: float, st: Statics,
           low: bool = False) -> torch.Tensor:
    """(H, W, 3) image."""
    with torch.no_grad():
        uv, conic, rgb, mask, radius, z = per_gaussian(params, alive, view, proj, campos, st, low)
        tables = binning.bin_tiles(uv, z, radius, mask, st.tiles_x, st.tiles_y, st.tile)
        out = raster.forward(pack_attrs(uv, conic, rgb, params["opacity"]), tables, bg,
                             st.tiles_x, st.tiles_y)
        return raster.to_image(out[:, :3], st.tiles_x, st.tiles_y, st.width, st.height)


def work(params: dict, alive, view, proj, campos, st: Statics) -> dict:
    """What one view asks of the kernels: Gaussians, tile rows, pairs,
    tiles, and the forward's pair-pixels (its n_splats row summed), those
    past the 1/255 cutoff and the pairs up to each tile's deepest
    n_splats, counted as ``chip_smoke.py::pair_pixel_counts`` (``:681``)
    counts them, on the reference's own tables."""
    with torch.no_grad():
        uv, conic, rgb, mask, radius, z = per_gaussian(params, alive, view, proj, campos, st)
        tables = binning.bin_tiles(uv, z, radius, mask, st.tiles_x, st.tiles_y, st.tile)
        attrs = pack_attrs(uv, conic, rgb, params["opacity"])
        out = raster.forward(attrs, tables, 0.0, st.tiles_x, st.tiles_y)
        nspl = out[:, 4]
        passing = 0
        deepest = nspl.amax(dim=1)
        dev = attrs.device
        for c0 in range(0, int(deepest.max()) if deepest.numel() else 0, raster.CHUNK):
            tiles = torch.nonzero(deepest > c0).flatten()
            x0, y0, px, py = raster._grid(tiles, st.tiles_x, dev)
            a, valid, _ = raster._pairs(attrs, tables, tiles, c0, x0, y0)
            alpha = raster._alpha(a, px, py)[3]
            k = torch.arange(c0, c0 + raster.CHUNK, device=dev)
            live = valid[:, None, :] & (k < nspl[tiles][:, :, None]) & (alpha > raster.CUTOFF)
            passing += int(live.sum())
        reached = int(torch.minimum(deepest, tables.tile_count.to(torch.float32)).sum())
    return dict(gaussians=int(alive.shape[0]), rows=tables.rows, pairs=tables.pairs,
                tiles=st.tiles_x * st.tiles_y, pair_pixels=int(nspl.double().sum()),
                passing=passing, reached=reached)


def train_step(state: State, view, proj, campos, gt, bg: float, it: int, st: Statics,
               low: bool = False, loss_rows: slice = slice(None)) -> float:
    """One step, ``state`` updated in place; returns the loss.
    ``loss_rows`` plants a fault (the loss over some image rows only)."""
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
    adam(state, grads, got[-1], mask, it, st)
    return float(loss)


@torch.no_grad()
def adam(state: State, grads: dict, g_uv, mask, it: int, st: Statics) -> None:
    dev = mask.device
    itf = torch.full((), float(it), device=dev)
    b1, b2, ratio = (torch.full((), x, device=dev) for x in
                     (B1, B2, st.xyz_lr_final / st.xyz_lr_init))
    bias1 = 1.0 - torch.pow(b1, itf + 1.0)
    bias2 = 1.0 - torch.pow(b2, itf + 1.0)
    decay = torch.pow(ratio, itf / float(st.num_iters))
    lrs = dict(xyz=st.scene_extent * st.base_lr * st.xyz_lr_init * decay,
               rgb=st.base_lr * st.rgb_lr, opacity=st.base_lr * st.opacity_lr,
               scale=st.base_lr * st.scale_lr, quat=st.base_lr * st.quat_lr,
               sh=st.base_lr * st.sh_lr)
    for k in PARAMS:
        if k == "sh" and st.l_max == 0:
            continue
        p, m, v = state.params[k], state.m[k], state.v[k]
        mk = mask.reshape(mask.shape + (1,) * (p.dim() - 1))
        g = torch.where(torch.isnan(grads[k]), 0.0, grads[k])
        m_new = B1 * m + (1.0 - B1) * g
        v_new = B2 * v + (1.0 - B2) * g * g
        step = -lrs[k] * (m_new / bias1) / (torch.sqrt(v_new / bias2) + EPS)
        state.params[k] = torch.where(mk, p + step, p)
        state.m[k] = torch.where(mk, m_new, m)
        state.v[k] = torch.where(mk, v_new, v)
    g_norm = torch.sqrt(torch.sum(g_uv * g_uv, dim=1))
    state.uv_accum = torch.where(mask, state.uv_accum + g_norm, state.uv_accum)
    state.dur = state.dur + mask.to(torch.int32)
