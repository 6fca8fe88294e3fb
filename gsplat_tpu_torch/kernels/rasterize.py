"""Tile rasterizer, forward and backward (port of
``gsplat_tpu/kernels/rasterize.py::rasterize_forward`` and
``rasterize_backward``, in both of its modes).

Forward, per tile: front-to-back alpha compositing of the tile's
depth-sorted pairs with the T < 1e-4 early stop, per-pixel splat count and
background. Pairs are read through ``splat_gid`` from per-Gaussian
attribute rows ``[u v c00 c01 c11 opa r g b]`` (``opa`` already sigmoid-ed).
Output (T, 5, PIX) f32 rows ``[r g b T_final n_splats]``: the reference's
(T, 8, PIX) layout without its three zero rows. CUDA kernel:
``csrc/rasterize_fwd.cu``.

Backward, per tile: back-to-front replay from each pixel's T_final and
n_splats, one (9,) gradient row per pair ``[du dv dc00 dc01 dc11 dopa dr dg
db]`` in sorted-pair order. CUDA kernel: ``csrc/rasterize_bwd.cu``. Both
kernels take 16x16 tiles only.

``packed`` is the reference's default mode (its packed pair stream): each
pair's attributes are rounded as that stream carries them
(``packing.round_pair_attrs``: f16 tile-relative u, v, bf16 conic and
opacity, bf16 then e5s9 colour) and the pixels take tile-local
coordinates. ``pack_grads`` writes the backward's rows as (P, 4) int32
words (``packing.pack_grad_rows``) instead of (P, 9) float32. Either way
the sums are formed in float32, where the reference's packed TPU kernels
take bf16 matrix products.

The background ``bg`` is a () float32 tensor (a number is filled into
one, ``background``): the kernels read it from device memory, so a CUDA
graph that replays them takes each replay's background, and the plain
versions take the same tensor.

The plain versions evaluate ``power`` and alpha op by op in the order
``csrc/raster_common.cuh`` rounds them, so kernels and plain versions agree
on which pair-pixels pass the 1/255 cutoff: change both together.
"""

from __future__ import annotations

import torch

from . import _build, packing

ALPHA_CUTOFF = 0.00392156862  # 1/255
T_EPS = 1e-4
ALPHA_MAX = 0.99
ATTR_COLS = 9
GRAD_COLS = 9
OUT_ROWS = 5
KERNEL_TILE = 16
_PLAIN_CHUNK = 64  # pairs per step of the plain version


def background(bg, device) -> torch.Tensor:
    """``bg`` as the () float32 tensor on ``device`` that the rasterizers
    read: a tensor as it is, a number filled into a new one (a fill, no
    copy from the host)."""
    if isinstance(bg, torch.Tensor):
        return bg.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(bg), dtype=torch.float32, device=device)


def _tile_lists(splat_gid, tile_start, tile_count):
    """(T, L) gid matrix of each tile's pairs in order, plus its mask.
    The pairs are the first ``sum(tile_count)`` of ``splat_gid``: all of
    them, or the live ones of a capped table."""
    num_tiles = tile_start.shape[0]
    dev = splat_gid.device
    max_len = int(tile_count.max()) if num_tiles else 0
    lists = torch.zeros((num_tiles, max(max_len, 1)), dtype=torch.int64, device=dev)
    valid = torch.zeros_like(lists, dtype=torch.bool)
    p = int(tile_count.sum()) if num_tiles else 0
    if p:
        tile_of = torch.repeat_interleave(
            torch.arange(num_tiles, device=dev), tile_count.to(torch.int64),
            output_size=p,
        )
        pos = torch.arange(p, device=dev) - tile_start.to(torch.int64)[tile_of]
        lists[tile_of, pos] = splat_gid[:p].to(torch.int64)
        valid[tile_of, pos] = True
    return lists, valid


def _tile_origins(num_tiles, num_tiles_x, tile, dev):
    """(T,) float32 x and y of each tile's first pixel."""
    t_idx = torch.arange(num_tiles, device=dev)
    return (((t_idx % num_tiles_x) * tile).to(torch.float32),
            ((t_idx // num_tiles_x) * tile).to(torch.float32))


def _pixel_centres(num_tiles, num_tiles_x, tile, dev, packed=False):
    """(T, PIX, 1) float32 x and y of every tile pixel: global, or relative
    to the tile's first pixel when ``packed``."""
    p_idx = torch.arange(tile * tile, device=dev)
    x0, y0 = _tile_origins(num_tiles, num_tiles_x, tile, dev)
    if packed:
        x0, y0 = torch.zeros_like(x0), torch.zeros_like(y0)
    px = x0[:, None] + (p_idx % tile).to(torch.float32)[None, :]
    py = y0[:, None] + (p_idx // tile).to(torch.float32)[None, :]
    return px[:, :, None], py[:, :, None]


def _pair_attrs(attrs, idx, origins, packed):
    """(T, 1, K, 9) attribute rows of the Gaussians ``idx`` (T, K): as they
    are, or rounded as the packed stream carries them, u and v relative to
    the tile origins ``origins`` ((T,) x, (T,) y)."""
    a = attrs[idx]
    if packed:
        a = packing.round_pair_attrs(a, origins[0][:, None], origins[1][:, None])
    return a[:, None]


def _check_tables(name, attrs, splat_gid, tile_start, tile_count, tile):
    """Raise unless the kernel takes these table and attribute tensors."""
    if tile != KERNEL_TILE:
        raise ValueError(f"{name}: the kernel takes tile={KERNEL_TILE}, got {tile}")
    if attrs.dtype != torch.float32 or attrs.dim() != 2 or attrs.shape[1] != ATTR_COLS:
        raise ValueError(f"{name}: attrs must be (N, {ATTR_COLS}) float32")
    for t in (splat_gid, tile_start, tile_count):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name}: index tensors must be 1-D int32")
    if tile_count.shape[0] != tile_start.shape[0]:
        raise ValueError(f"{name}: tile_start/tile_count lengths differ")


def rasterize_forward_plain(
    attrs: torch.Tensor,
    splat_gid: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    bg,
    *,
    num_tiles_x: int,
    tile: int = KERNEL_TILE,
    packed: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version: every tile at once, 64 pairs a step.

    Within a chunk the transmittance is a cumulative product along the
    pair axis carried across chunks (the reference kernel's formulation);
    a pixel is alive while the T entering a splat is >= 1e-4, and T_final
    is the first post-T below 1e-4 (the largest, T being monotone).
    """
    num_tiles = tile_start.shape[0]
    dev = attrs.device
    bg = background(bg, dev)
    pix = tile * tile
    lists, valid = _tile_lists(splat_gid, tile_start, tile_count)
    px, py = _pixel_centres(num_tiles, num_tiles_x, tile, dev, packed)
    origins = _tile_origins(num_tiles, num_tiles_x, tile, dev)

    tcar = torch.ones((num_tiles, pix, 1), dtype=torch.float32, device=dev)
    tf = torch.full((num_tiles, pix), -1.0, dtype=torch.float32, device=dev)
    acc = torch.zeros((num_tiles, pix, 3), dtype=torch.float32, device=dev)
    nspl = torch.zeros((num_tiles, pix), dtype=torch.float32, device=dev)
    for c0 in range(0, lists.shape[1], _PLAIN_CHUNK):
        a = _pair_attrs(attrs, lists[:, c0 : c0 + _PLAIN_CHUNK], origins, packed)
        real = valid[:, None, c0 : c0 + _PLAIN_CHUNK]  # (T, 1, K)
        dx = a[..., 0] - px  # (T, PIX, K)
        dy = a[..., 1] - py
        power = -0.5 * (a[..., 2] * dx * dx + 2.0 * a[..., 3] * dx * dy
                        + a[..., 4] * dy * dy)
        power = torch.clamp(power, max=0.0)
        alpha = torch.clamp(a[..., 5] * torch.exp(power), max=ALPHA_MAX)
        alpha = torch.where((alpha > ALPHA_CUTOFF) & real, alpha, 0.0)
        incl = torch.cumprod(1.0 - alpha, dim=-1)
        excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=-1)
        t_entry = tcar * excl
        alive = t_entry >= T_EPS
        w = torch.where(alive, alpha * t_entry, 0.0)
        acc += torch.einsum("tpk,tkc->tpc", w, a[:, 0, :, 6:9])
        nspl += (alive & real).sum(dim=-1).to(torch.float32)
        post = tcar * incl
        cross = torch.where(alive & (post < T_EPS), post, -1.0)
        tf = torch.maximum(tf, cross.amax(dim=-1))
        tcar = tcar * incl[..., -1:]
    t_final = torch.where(tf >= 0.0, tf, tcar[..., 0])
    color = acc + (t_final * bg)[..., None]
    return torch.cat(
        [color.permute(0, 2, 1), t_final[:, None, :], nspl[:, None, :]], dim=1
    )


def rasterize_forward(
    attrs: torch.Tensor,
    splat_gid: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    bg,
    *,
    num_tiles_x: int,
    tile: int = KERNEL_TILE,
    packed: bool = False,
) -> torch.Tensor:
    """Render every tile: (T, 5, tile*tile) rows [r g b T_final n_splats].

    ``attrs`` (N, 9) f32 per-Gaussian rows; ``splat_gid`` (P,) int32 pair ->
    Gaussian, tile-major and depth-sorted; ``tile_start``/``tile_count``
    (T,) int32 ranges into it; ``bg`` the () float32 background (or a
    number, ``background``); ``packed`` rounds each pair's attributes as
    the reference's packed stream does. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel.
    """
    if attrs.device.type == "cpu":
        return rasterize_forward_plain(
            attrs, splat_gid, tile_start, tile_count, bg,
            num_tiles_x=num_tiles_x, tile=tile, packed=packed,
        )
    name = "rasterize_forward"
    _check_tables(name, attrs, splat_gid, tile_start, tile_count, tile)
    num_tiles = tile_start.shape[0]
    bg = background(bg, attrs.device)
    _build.require_cuda(name, attrs, splat_gid, tile_start, tile_count, bg)
    lib = _build.build()
    out = torch.empty(
        (num_tiles, OUT_ROWS, tile * tile), dtype=torch.float32, device=attrs.device
    )
    err = lib.gs_rasterize_forward(
        out.data_ptr(), attrs.data_ptr(), splat_gid.data_ptr(),
        tile_start.data_ptr(), tile_count.data_ptr(), num_tiles, num_tiles_x,
        bg.data_ptr(), int(packed), _build.stream_ptr(attrs.device),
    )
    _build.check(err, name)
    _build.launches[name] += 1
    if packed:
        _build.launches[f"{name}/packed"] += 1
    return out


def grad_scales(num_tiles_x: int, num_tiles_y: int, tile: int = KERNEL_TILE):
    """The uv-gradient scale (0.5 * padded grid width, 0.5 * height).

    The reference scales by the padded tile grid, not by the image's W and
    H (``gsplat_tpu/ops/render.py:120-124``).
    """
    return 0.5 * num_tiles_x * tile, 0.5 * num_tiles_y * tile


def rasterize_backward_plain(
    attrs: torch.Tensor,
    splat_gid: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    out: torch.Tensor,
    d_tiles: torch.Tensor,
    bg,
    *,
    num_tiles_x: int,
    num_tiles_y: int,
    tile: int = KERNEL_TILE,
    grad_scale: tuple[float, float] | None = None,
    packed: bool = False,
    pack_grads: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version: every tile at once, 64 pairs a step, last
    chunk first (the reference kernel's formulation).

    A chunk recovers T at its entry from T at its exit by dividing by the
    product of its (1 - alpha), takes per-splat entry transmittances as
    exclusive cumulative products, and the suffix sum of w (c . dI) as a
    reversed cumulative sum carried across chunks. Chunks past every
    pixel's n_splats are not visited; their rows stay zero. With
    ``pack_grads`` the float32 rows are then packed.
    """
    rows = _backward_rows_plain(
        attrs, splat_gid, tile_start, tile_count, out, d_tiles, bg,
        num_tiles_x=num_tiles_x, num_tiles_y=num_tiles_y, tile=tile,
        grad_scale=grad_scale, packed=packed,
    )
    return packing.pack_grad_rows(rows) if pack_grads else rows


def _backward_rows_plain(attrs, splat_gid, tile_start, tile_count, out, d_tiles, bg, *,
                         num_tiles_x, num_tiles_y, tile, grad_scale, packed):
    num_tiles = tile_start.shape[0]
    dev = attrs.device
    bg = background(bg, dev)
    rows = torch.zeros((splat_gid.shape[0], GRAD_COLS), dtype=attrs.dtype, device=dev)
    if splat_gid.shape[0] == 0:
        return rows
    lists, valid = _tile_lists(splat_gid, tile_start, tile_count)
    px, py = _pixel_centres(num_tiles, num_tiles_x, tile, dev, packed)
    origins = _tile_origins(num_tiles, num_tiles_x, tile, dev)
    scale_u, scale_v = grad_scale or grad_scales(num_tiles_x, num_tiles_y, tile)
    tfin = out[:, 3, :, None]  # (T, PIX, 1)
    nspl = out[:, 4, :, None]
    di = d_tiles.permute(0, 2, 1)  # (T, PIX, 3)
    bg_term = tfin * (bg * d_tiles.sum(dim=1))[:, :, None]
    used = min(int(nspl.max()), lists.shape[1])
    tcar = tfin  # T at the exit of the chunk being replayed
    pq = torch.zeros_like(tfin)  # suffix sum of the chunks behind it
    for c0 in reversed(range(0, used, _PLAIN_CHUNK)):
        sel = valid[:, c0 : c0 + _PLAIN_CHUNK]  # (T, K)
        kk = sel.shape[1]
        a = _pair_attrs(attrs, lists[:, c0 : c0 + _PLAIN_CHUNK], origins, packed)
        dx = a[..., 0] - px  # (T, PIX, K)
        dy = a[..., 1] - py
        c00, c01, c11, opa = a[..., 2], a[..., 3], a[..., 4], a[..., 5]
        power = torch.clamp(
            -0.5 * (c00 * dx * dx + 2.0 * c01 * dx * dy + c11 * dy * dy), max=0.0
        )
        gval = torch.exp(power)
        alpha = torch.clamp(opa * gval, max=ALPHA_MAX)
        rel = torch.arange(c0, c0 + kk, device=dev, dtype=torch.float32)
        ok = sel[:, None, :] & (rel < nspl) & (alpha > ALPHA_CUTOFF)
        alpha_v = torch.where(ok, alpha, 0.0)
        g_v = torch.where(ok, gval, 0.0)
        incl = torch.cumprod(1.0 - alpha_v, dim=-1)
        t_in = tcar / torch.clamp(incl[..., -1:], min=1e-30)
        excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=-1)
        t_entry = t_in * excl
        w = alpha_v * t_entry
        cdi = torch.einsum("tkc,tpc->tpk", a[:, 0, :, 6:9], di)
        q = w * cdi
        pk = torch.flip(torch.cumsum(torch.flip(q, [-1]), dim=-1), [-1]) + pq
        pn = pk - q
        inv = 1.0 / (1.0 - alpha_v)
        grad_alpha = cdi * t_entry - pn * inv - bg_term * inv
        gp = g_v * grad_alpha * opa
        vals = torch.stack(
            [
                scale_u * torch.sum(-(c00 * dx + c01 * dy) * gp, dim=1),
                scale_v * torch.sum(-(c11 * dy + c01 * dx) * gp, dim=1),
                torch.sum(-0.5 * dx * dx * gp, dim=1),
                torch.sum(-dx * dy * gp, dim=1),
                torch.sum(-0.5 * dy * dy * gp, dim=1),
                torch.sum(g_v * grad_alpha, dim=1),
            ],
            dim=-1,
        )  # (T, K, 6)
        vals = torch.cat([vals, torch.einsum("tpk,tpc->tkc", w, di)], dim=-1)
        slot = tile_start.to(torch.int64)[:, None] + c0 + torch.arange(kk, device=dev)
        rows[slot[sel]] = vals[sel]
        tcar = t_in
        pq = pk[..., :1]
    return rows


def rasterize_backward(
    attrs: torch.Tensor,
    splat_gid: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    out: torch.Tensor,
    d_tiles: torch.Tensor,
    bg,
    *,
    num_tiles_x: int,
    num_tiles_y: int,
    tile: int = KERNEL_TILE,
    grad_scale: tuple[float, float] | None = None,
    packed: bool = False,
    pack_grads: bool = False,
) -> torch.Tensor:
    """Per-pair gradient rows (P, 9) f32, in sorted-pair order, or with
    ``pack_grads`` their (P, 4) int32 words.

    ``attrs``, ``splat_gid``, ``tile_start``, ``tile_count`` and ``packed``
    as for ``rasterize_forward``; ``out`` is its (T, 5, PIX) output and
    ``d_tiles`` the (T, 3, PIX) image cotangent in tile layout (zero on
    padded pixels). Rows are ``[du dv dc00 dc01 dc11 dopa dr dg db]``: du,
    dv scaled by ``grad_scale`` (default ``grad_scales``, the padded
    grid's), dopa with respect to the sigmoid-ed opacity. Every row is
    written, zeros for pairs no pixel reached. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel.
    """
    if attrs.device.type == "cpu":
        return rasterize_backward_plain(
            attrs, splat_gid, tile_start, tile_count, out, d_tiles, bg,
            num_tiles_x=num_tiles_x, num_tiles_y=num_tiles_y, tile=tile,
            grad_scale=grad_scale, packed=packed, pack_grads=pack_grads,
        )
    name = "rasterize_backward"
    _check_tables(name, attrs, splat_gid, tile_start, tile_count, tile)
    num_tiles = tile_start.shape[0]
    if num_tiles != num_tiles_x * num_tiles_y:
        raise ValueError(f"{name}: {num_tiles} tiles is not {num_tiles_x}x{num_tiles_y}")
    pix = tile * tile
    for t, rows_ in ((out, OUT_ROWS), (d_tiles, 3)):
        if t.dtype != torch.float32 or tuple(t.shape) != (num_tiles, rows_, pix):
            raise ValueError(f"{name}: expected ({num_tiles}, {rows_}, {pix}) float32")
    bg = background(bg, attrs.device)
    _build.require_cuda(name, attrs, splat_gid, tile_start, tile_count, out, d_tiles, bg)
    lib = _build.build()
    grads = torch.empty(
        (splat_gid.shape[0], packing.GRAD_WORDS) if pack_grads
        else (splat_gid.shape[0], GRAD_COLS),
        dtype=torch.int32 if pack_grads else torch.float32, device=attrs.device,
    )
    scale_u, scale_v = grad_scale or grad_scales(num_tiles_x, num_tiles_y, tile)
    err = lib.gs_rasterize_backward(
        grads.data_ptr(), attrs.data_ptr(), splat_gid.data_ptr(),
        tile_start.data_ptr(), tile_count.data_ptr(), out.data_ptr(),
        d_tiles.data_ptr(), num_tiles, num_tiles_x, bg.data_ptr(), scale_u, scale_v,
        int(packed), int(pack_grads), _build.stream_ptr(attrs.device),
    )
    _build.check(err, name)
    _build.launches[name] += 1
    if packed:
        _build.launches[f"{name}/packed"] += 1
    return grads
