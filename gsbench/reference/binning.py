"""Tile binning, sized exactly: which tiles each Gaussian covers and each
tile's Gaussians in depth order.

Each visible Gaussian covers the tile rows of its OBB / cut-ellipse
span; in each row, the closed-form x-interval of the OBB intersected with
the ellipse gives its tiles. Pairs are sorted stably by (tile, log-depth
bucket) with Gaussian order breaking ties, which is the measured step's
order. The float closed forms and the log2 bucket are the step's own
(``ROADMAP.md`` R5, R6: other formulas would put a few pairs in other
tiles or swap two splats of a bucket).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

QD_Z0 = 1e-4
QD_OCTAVES = 32.0
I32_SAFE = float(1 << 30)


class Tables(NamedTuple):
    gid: torch.Tensor  # (P,) int64, tile-major, depth order within a tile
    tile_start: torch.Tensor  # (T,) int64
    tile_count: torch.Tensor  # (T,) int64
    rows: int  # tile rows expanded
    pairs: int


def depth_bits(num_tiles: int) -> int:
    return max(1, min(16, 30 - int(num_tiles).bit_length()))


def _to_i64(x):
    x = torch.nan_to_num(x, nan=0.0, posinf=I32_SAFE, neginf=-I32_SAFE)
    return torch.clamp(x, -I32_SAFE, I32_SAFE).to(torch.int32).to(torch.int64)


def _x_extreme_obb(u, a1x, a1y, a2x, a2y, dy0, dy1):
    one = torch.ones_like(a1x)
    s0 = torch.sign(torch.where(a1x == 0, one, a1x))
    t0 = torch.sign(torch.where(a2x == 0, one, a2x))
    y_at = s0 * a1y + t0 * a2y
    x_unc = a1x.abs() + a2x.abs()
    d = torch.clamp(y_at, dy0, dy1)
    in_range = (y_at >= dy0) & (y_at <= dy1)
    eps = torch.full_like(a1y, 1e-20)
    a1y_s = torch.where(a1y.abs() < eps, eps, a1y)
    a2y_s = torch.where(a2y.abs() < eps, eps, a2y)
    neg_inf = torch.full_like(u, -float("inf"))
    cands = []
    for sv in (1.0, -1.0):
        t = (d - sv * a1y) / a2y_s
        cands.append(torch.where(t.abs() <= 1.0 + 1e-5,
                                 sv * a1x + torch.clamp(t, -1, 1) * a2x, neg_inf))
    for tv in (1.0, -1.0):
        s = (d - tv * a2y) / a1y_s
        cands.append(torch.where(s.abs() <= 1.0 + 1e-5,
                                 torch.clamp(s, -1, 1) * a1x + tv * a2x, neg_inf))
    x_con = torch.maximum(torch.maximum(cands[0], cands[1]), torch.maximum(cands[2], cands[3]))
    return u + torch.where(in_range, x_unc, x_con)


def _x_extreme_ell(u, e1x, e1y, e2x, e2y, dy0, dy1):
    rx2 = e1x * e1x + e2x * e2x
    rx = torch.sqrt(rx2)
    ry2 = e1y * e1y + e2y * e2y
    ry = torch.sqrt(ry2)
    dot = e1x * e1y + e2x * e2y
    eps = 1e-20
    y_at = dot / torch.clamp(rx, min=eps)
    in_range = (y_at >= dy0) & (y_at <= dy1)
    d = torch.clamp(torch.clamp(y_at, dy0, dy1), -ry, ry)
    alpha = dot / torch.clamp(ry2, min=eps)
    w = torch.sqrt(torch.clamp(rx2 - alpha * dot, min=0.0))
    x_con = alpha * d + w * torch.sqrt(torch.clamp(1.0 - (d * d) / torch.clamp(ry2, min=eps),
                                                   min=0.0))
    x_con = torch.where(ry2 <= eps, rx, x_con)
    return u + torch.where(in_range, rx, x_con)


def bin_tiles(uv, z, radius, mask, tiles_x: int, tiles_y: int, tile: int) -> Tables:
    ts = float(tile)
    num_tiles = tiles_x * tiles_y
    dev = uv.device
    u, v = uv[:, 0], uv[:, 1]
    r_major, r_minor, sin_t, cos_t, s_e = (radius[:, k] for k in range(5))
    a1x, a1y = r_major * cos_t, r_major * sin_t
    a2x, a2y = -r_minor * sin_t, r_minor * cos_t
    hx = torch.minimum(a1x.abs() + a2x.abs(), s_e * torch.sqrt(a1x * a1x + a2x * a2x))
    hy = torch.minimum(a1y.abs() + a2y.abs(), s_e * torch.sqrt(a1y * a1y + a2y * a2y))
    ty0 = torch.clamp(_to_i64(torch.ceil((v - hy - (ts - 1.0)) / ts)), 0, tiles_y)
    ty1 = torch.clamp(_to_i64(torch.floor((v + hy) / ts)) + 1, 0, tiles_y)
    has_x = (torch.floor((u + hx) / ts) >= 0) & (torch.ceil((u - hx - (ts - 1.0)) / ts) < tiles_x)
    nrow = torch.where(mask & has_x, torch.clamp(ty1 - ty0, min=0), torch.zeros_like(ty0))
    qbits = depth_bits(num_tiles)
    levels = float(1 << qbits)
    z0 = torch.full((), QD_Z0, dtype=torch.float32, device=dev)
    qd = torch.clamp(torch.floor((torch.log2(torch.maximum(z, z0)) - torch.log2(z0))
                                 * (levels / QD_OCTAVES)), 0.0, levels - 1.0).to(torch.int64)
    # level 1: tile rows, in Gaussian order
    g = torch.repeat_interleave(torch.arange(uv.shape[0], device=dev), nrow)
    first = torch.cumsum(nrow, 0) - nrow
    row_y = ty0[g] + (torch.arange(g.shape[0], device=dev) - first[g])
    dy0 = row_y.to(torch.float32) * ts - v[g]
    dy1 = dy0 + (ts - 1.0)
    xhi_o = _x_extreme_obb(u[g], a1x[g], a1y[g], a2x[g], a2y[g], dy0, dy1)
    xlo_o = -_x_extreme_obb(-u[g], -a1x[g], a1y[g], -a2x[g], a2y[g], dy0, dy1)
    e1x, e1y, e2x, e2y = s_e[g] * a1x[g], s_e[g] * a1y[g], s_e[g] * a2x[g], s_e[g] * a2y[g]
    xhi_e = _x_extreme_ell(u[g], e1x, e1y, e2x, e2y, dy0, dy1)
    xlo_e = -_x_extreme_ell(-u[g], -e1x, e1y, -e2x, e2y, dy0, dy1)
    xhi, xlo = torch.minimum(xhi_o, xhi_e), torch.maximum(xlo_o, xlo_e)
    ok = torch.isfinite(xlo) & torch.isfinite(xhi)
    zero = torch.zeros_like(xlo)
    cx0 = torch.clamp(_to_i64(torch.ceil((torch.where(ok, xlo, zero) - (ts - 1.0)) / ts)),
                      0, tiles_x - 1)
    cx1 = torch.clamp(_to_i64(torch.floor(torch.where(ok, xhi, zero - 1.0) / ts)),
                      -1, tiles_x - 1)
    empty = ~ok | (torch.floor(xhi / ts) < 0) | (torch.ceil((xlo - (ts - 1.0)) / ts) >= tiles_x)
    ncol = torch.where(empty, torch.zeros_like(cx0), torch.clamp(cx1 - cx0 + 1, min=0))
    # level 2: the tiles of each row
    r = torch.repeat_interleave(torch.arange(g.shape[0], device=dev), ncol)
    first2 = torch.cumsum(ncol, 0) - ncol
    tile_id = row_y[r] * tiles_x + cx0[r] + (torch.arange(r.shape[0], device=dev) - first2[r])
    gid = g[r]
    keys = (tile_id << qbits) | torch.clamp(qd[gid], 0, (1 << qbits) - 1)
    order = torch.sort(keys, stable=True).indices
    keys, gid = keys[order], gid[order]
    bounds = torch.searchsorted(keys, torch.arange(num_tiles + 1, device=dev) << qbits)
    return Tables(gid, bounds[:-1], bounds[1:] - bounds[:-1], int(g.shape[0]), int(gid.shape[0]))
