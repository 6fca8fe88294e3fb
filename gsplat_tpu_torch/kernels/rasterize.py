"""Forward tile rasterizer (port of
``gsplat_tpu/kernels/rasterize.py::rasterize_forward``).

Per tile: front-to-back alpha compositing of the tile's depth-sorted pairs
with the T < 1e-4 early stop, per-pixel splat count and background. Pairs
are read through ``splat_gid`` from per-Gaussian attribute rows
``[u v c00 c01 c11 opa r g b]`` (``opa`` already sigmoid-ed). CUDA kernel:
``csrc/rasterize_fwd.cu`` (16x16 tiles only).

Output (T, 5, PIX) f32 rows ``[r g b T_final n_splats]``: the reference's
(T, 8, PIX) layout without its three zero rows.
"""

from __future__ import annotations

import torch

from . import _build

ALPHA_CUTOFF = 0.00392156862  # 1/255
T_EPS = 1e-4
ALPHA_MAX = 0.99
ATTR_COLS = 9
OUT_ROWS = 5
KERNEL_TILE = 16
_PLAIN_CHUNK = 64  # pairs per step of the plain version


def _tile_lists(splat_gid, tile_start, tile_count):
    """(T, L) gid matrix of each tile's pairs in order, plus its mask."""
    num_tiles = tile_start.shape[0]
    dev = splat_gid.device
    max_len = int(tile_count.max()) if num_tiles else 0
    lists = torch.zeros((num_tiles, max(max_len, 1)), dtype=torch.int64, device=dev)
    valid = torch.zeros_like(lists, dtype=torch.bool)
    p = splat_gid.shape[0]
    if p:
        tile_of = torch.repeat_interleave(
            torch.arange(num_tiles, device=dev), tile_count.to(torch.int64),
            output_size=p,
        )
        pos = torch.arange(p, device=dev) - tile_start.to(torch.int64)[tile_of]
        lists[tile_of, pos] = splat_gid.to(torch.int64)
        valid[tile_of, pos] = True
    return lists, valid


def rasterize_forward_plain(
    attrs: torch.Tensor,
    splat_gid: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    bg: float,
    *,
    num_tiles_x: int,
    tile: int = KERNEL_TILE,
) -> torch.Tensor:
    """Plain PyTorch version: every tile at once, 64 pairs a step.

    Within a chunk the transmittance is a cumulative product along the
    pair axis carried across chunks (the reference kernel's formulation);
    a pixel is alive while the T entering a splat is >= 1e-4, and T_final
    is the first post-T below 1e-4 (the largest, T being monotone).
    """
    num_tiles = tile_start.shape[0]
    dev = attrs.device
    pix = tile * tile
    lists, valid = _tile_lists(splat_gid, tile_start, tile_count)
    t_idx = torch.arange(num_tiles, device=dev)
    p_idx = torch.arange(pix, device=dev)
    px = ((t_idx % num_tiles_x) * tile)[:, None] + (p_idx % tile)[None, :]
    py = ((t_idx // num_tiles_x) * tile)[:, None] + (p_idx // tile)[None, :]
    px = px.to(torch.float32)[:, :, None]  # (T, PIX, 1)
    py = py.to(torch.float32)[:, :, None]

    tcar = torch.ones((num_tiles, pix, 1), dtype=torch.float32, device=dev)
    tf = torch.full((num_tiles, pix), -1.0, dtype=torch.float32, device=dev)
    acc = torch.zeros((num_tiles, pix, 3), dtype=torch.float32, device=dev)
    nspl = torch.zeros((num_tiles, pix), dtype=torch.float32, device=dev)
    for c0 in range(0, lists.shape[1], _PLAIN_CHUNK):
        a = attrs[lists[:, c0 : c0 + _PLAIN_CHUNK]]  # (T, K, 9)
        real = valid[:, None, c0 : c0 + _PLAIN_CHUNK]  # (T, 1, K)
        a = a[:, None, :, :]  # (T, 1, K, 9)
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
    bg: float,
    *,
    num_tiles_x: int,
    tile: int = KERNEL_TILE,
) -> torch.Tensor:
    """Render every tile: (T, 5, tile*tile) rows [r g b T_final n_splats].

    ``attrs`` (N, 9) f32 per-Gaussian rows; ``splat_gid`` (P,) int32 pair ->
    Gaussian, tile-major and depth-sorted; ``tile_start``/``tile_count``
    (T,) int32 ranges into it. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel.
    """
    if attrs.device.type == "cpu":
        return rasterize_forward_plain(
            attrs, splat_gid, tile_start, tile_count, bg,
            num_tiles_x=num_tiles_x, tile=tile,
        )
    name = "rasterize_forward"
    if tile != KERNEL_TILE:
        raise ValueError(f"{name}: the kernel takes tile={KERNEL_TILE}, got {tile}")
    if attrs.dtype != torch.float32 or attrs.dim() != 2 or attrs.shape[1] != ATTR_COLS:
        raise ValueError(f"{name}: attrs must be (N, {ATTR_COLS}) float32")
    for t in (splat_gid, tile_start, tile_count):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name}: index tensors must be 1-D int32")
    num_tiles = tile_start.shape[0]
    if tile_count.shape[0] != num_tiles:
        raise ValueError(f"{name}: tile_start/tile_count lengths differ")
    _build.require_cuda(name, attrs, splat_gid, tile_start, tile_count)
    lib = _build.build()
    out = torch.empty(
        (num_tiles, OUT_ROWS, tile * tile), dtype=torch.float32, device=attrs.device
    )
    err = lib.gs_rasterize_forward(
        out.data_ptr(), attrs.data_ptr(), splat_gid.data_ptr(),
        tile_start.data_ptr(), tile_count.data_ptr(), num_tiles, num_tiles_x,
        float(bg), _build.stream_ptr(attrs.device),
    )
    _build.check(err, name)
    _build.launches[name] += 1
    return out
