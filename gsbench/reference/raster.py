"""Tile rasterizer, forward and backward, in the packed mode.

Forward: front-to-back alpha compositing of each tile's depth-ordered
pairs, 64 pairs a step, with the T < 1e-4 stop and the 1/255 alpha cutoff
evaluated op by op in the order the measured kernels round them
(``ROADMAP.md`` R7). Output (T, 5, 256) rows ``[r g b T_final n_splats]``.

Backward: each tile replayed back to front from its pixels' T_final and
n_splats; one gradient row ``[du dv dc00 dc01 dc11 dopa dr dg db]`` per
pair, in sorted pair order, rounded as its packed words decode, the uv
rows scaled by half the padded grid's width and height. The 0.99 alpha
clamp and the power <= 0 clamp carry no derivative; the background gets
none.

Each step visits only the tiles that still have work (pairs left, a pixel
still alive, a pixel whose n_splats reaches the step): a skipped tile
would change no output.
"""

from __future__ import annotations

import torch

from . import packing

CUTOFF = 0.00392156862  # 1/255
T_EPS = 1e-4
ALPHA_MAX = 0.99
CHUNK = 64
TILE = 16


def _grid(tiles, tiles_x, dev):
    """(T,) x and y origins of the tiles ``tiles``, and (1, PIX, 1) pixel
    offsets inside a tile."""
    x0 = ((tiles % tiles_x) * TILE).to(torch.float32)
    y0 = ((tiles // tiles_x) * TILE).to(torch.float32)
    p = torch.arange(TILE * TILE, device=dev)
    px = (p % TILE).to(torch.float32)[None, :, None]
    py = (p // TILE).to(torch.float32)[None, :, None]
    return x0, y0, px, py


def _pairs(attrs, tables, tiles, c0, x0, y0):
    """(t, 1, K, 9) rounded attribute rows of pairs c0..c0+63 of ``tiles``,
    their validity (t, K) and their sorted indices (t, K)."""
    k = torch.arange(CHUNK, device=attrs.device)
    start, count = tables.tile_start[tiles], tables.tile_count[tiles]
    valid = (c0 + k)[None, :] < count[:, None]
    idx = torch.where(valid, start[:, None] + c0 + k[None, :], 0)
    a = packing.round_pair_attrs(attrs[tables.gid[idx]], x0[:, None], y0[:, None])
    return a[:, None], valid, idx


def _alpha(a, px, py):
    dx, dy = a[..., 0] - px, a[..., 1] - py
    power = torch.clamp(-0.5 * (a[..., 2] * dx * dx + 2.0 * a[..., 3] * dx * dy
                                + a[..., 4] * dy * dy), max=0.0)
    g = torch.exp(power)
    return dx, dy, g, torch.clamp(a[..., 5] * g, max=ALPHA_MAX)


def forward(attrs, tables, bg: float, tiles_x: int, tiles_y: int) -> torch.Tensor:
    dev = attrs.device
    nt, pix = tiles_x * tiles_y, TILE * TILE
    tcar = torch.ones((nt, pix, 1), device=dev)
    tf = torch.full((nt, pix), -1.0, device=dev)
    acc = torch.zeros((nt, pix, 3), device=dev)
    nspl = torch.zeros((nt, pix), device=dev)
    count = tables.tile_count
    for c0 in range(0, int(count.max()) if nt else 0, CHUNK):
        tiles = torch.nonzero((count > c0) & (tf < 0).any(dim=1)).flatten()
        if tiles.numel() == 0:
            break
        x0, y0, px, py = _grid(tiles, tiles_x, dev)
        a, valid, _ = _pairs(attrs, tables, tiles, c0, x0, y0)
        _, _, _, alpha = _alpha(a, px, py)
        alpha = torch.where((alpha > CUTOFF) & valid[:, None, :], alpha, 0.0)
        incl = torch.cumprod(1.0 - alpha, dim=-1)
        excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=-1)
        tc = tcar[tiles]
        t_entry = tc * excl
        alive = t_entry >= T_EPS
        w = torch.where(alive, alpha * t_entry, 0.0)
        acc[tiles] += torch.einsum("tpk,tkc->tpc", w, a[:, 0, :, 6:9])
        nspl[tiles] += (alive & valid[:, None, :]).sum(dim=-1).to(torch.float32)
        post = tc * incl
        cross = torch.where(alive & (post < T_EPS), post, -1.0)
        tf[tiles] = torch.maximum(tf[tiles], cross.amax(dim=-1))
        tcar[tiles] = tc * incl[..., -1:]
    t_final = torch.where(tf >= 0.0, tf, tcar[..., 0])
    color = acc + (t_final * bg)[..., None]
    return torch.cat([color.permute(0, 2, 1), t_final[:, None], nspl[:, None]], dim=1)


def backward_rows(attrs, tables, out, d_tiles, bg: float, tiles_x: int,
                  tiles_y: int) -> torch.Tensor:
    """(P, 9) gradient rows in sorted pair order, rounded to the packed
    words."""
    dev = attrs.device
    rows = torch.zeros((tables.pairs, 9), device=dev)
    scale_u, scale_v = 0.5 * tiles_x * TILE, 0.5 * tiles_y * TILE
    tfin, nspl = out[:, 3, :, None], out[:, 4, :, None]
    di = d_tiles.permute(0, 2, 1)
    bg_term = tfin * (bg * d_tiles.sum(dim=1))[:, :, None]
    used = torch.minimum(nspl[:, :, 0].amax(dim=1), tables.tile_count.to(torch.float32))
    tcar, pq = tfin.clone(), torch.zeros_like(tfin)
    top = int(used.max()) if used.numel() else 0
    for c0 in reversed(range(0, top, CHUNK)):
        tiles = torch.nonzero(used > c0).flatten()
        x0, y0, px, py = _grid(tiles, tiles_x, dev)
        a, valid, idx = _pairs(attrs, tables, tiles, c0, x0, y0)
        dx, dy, g, alpha = _alpha(a, px, py)
        c00, c01, c11, opa = a[..., 2], a[..., 3], a[..., 4], a[..., 5]
        rel = torch.arange(c0, c0 + CHUNK, device=dev, dtype=torch.float32)
        ok = valid[:, None, :] & (rel < nspl[tiles]) & (alpha > CUTOFF)
        alpha_v, g_v = torch.where(ok, alpha, 0.0), torch.where(ok, g, 0.0)
        incl = torch.cumprod(1.0 - alpha_v, dim=-1)
        t_in = tcar[tiles] / torch.clamp(incl[..., -1:], min=1e-30)
        excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=-1)
        t_entry = t_in * excl
        w = alpha_v * t_entry
        dit = di[tiles]
        cdi = torch.einsum("tkc,tpc->tpk", a[:, 0, :, 6:9], dit)
        q = w * cdi
        pk = torch.flip(torch.cumsum(torch.flip(q, [-1]), dim=-1), [-1]) + pq[tiles]
        inv = 1.0 / (1.0 - alpha_v)
        grad_alpha = cdi * t_entry - (pk - q) * inv - bg_term[tiles] * inv
        gp = g_v * grad_alpha * opa
        vals = torch.stack([
            scale_u * torch.sum(-(c00 * dx + c01 * dy) * gp, dim=1),
            scale_v * torch.sum(-(c11 * dy + c01 * dx) * gp, dim=1),
            torch.sum(-0.5 * dx * dx * gp, dim=1),
            torch.sum(-dx * dy * gp, dim=1),
            torch.sum(-0.5 * dy * dy * gp, dim=1),
            torch.sum(g_v * grad_alpha, dim=1),
        ], dim=-1)
        vals = torch.cat([vals, torch.einsum("tpk,tpc->tkc", w, dit)], dim=-1)
        rows[idx[valid]] = vals[valid]
        tcar[tiles] = t_in
        pq[tiles] = pk[..., :1]
    return packing.round_grad_rows(rows)


def to_image(tiles, tiles_x, tiles_y, width, height):
    """(T, 3, PIX) -> (H, W, 3), cropped."""
    x = tiles.reshape(tiles_y, tiles_x, 3, TILE, TILE).permute(0, 3, 1, 4, 2)
    return x.reshape(tiles_y * TILE, tiles_x * TILE, 3)[:height, :width]


def to_tiles(image, tiles_x, tiles_y):
    """(H, W, 3) -> (T, 3, PIX), zero on the padded pixels."""
    h, w = image.shape[:2]
    x = torch.zeros((tiles_y * TILE, tiles_x * TILE, 3), device=image.device)
    x[:h, :w] = image
    x = x.reshape(tiles_y, TILE, tiles_x, TILE, 3).permute(0, 2, 4, 1, 3)
    return x.reshape(tiles_x * tiles_y, 3, TILE * TILE).contiguous()
