"""Tile binning + depth sort (port of ``gsplat_tpu/ops/binning.py``).

The reference's ``build_tile_tables``, resized for a GPU:

1. Level 1 enumerates each visible Gaussian's tile ROWS (the pixel-rect
   y-span of its OBB/ellipse, ``_span_y``); level 2 computes, per row, the
   exact x-interval of the OBB intersected with the alpha-cutoff ellipse in
   closed form (``_strip_x_extreme``, ``_strip_x_extreme_ell``), so the
   candidates ARE the pairs. Both levels run the segment-expand kernel, in
   original Gaussian order.
2. Only index columns are expanded (Gaussian id, and the base from which a
   slot's tile row / tile index follows); per-row geometry is gathered by
   Gaussian id. Gathers are cheap on the GPU, where the reference had to
   ride f32 records through both levels.
3. ONE stable radix sort on ``(tile << qd_bits) | quantized depth``.
   Candidates are Gaussian-major and a Gaussian has at most one pair per
   tile, so stability reproduces the reference's ``(key, gid)`` order.
   The exact-ordering mode (``depth_rank=``) puts a dense depth rank in
   place of the quantized depth, in ``bitlen(N - 1)`` bits.
4. Tile ranges come from ``searchsorted`` at the qd-aligned boundaries.
5. The same two facts give the backward its per-Gaussian runs without a
   second sort: Gaussian g's candidates are the run ``[pair_start[g],
   pair_start[g+1])``, in ascending tile order, and ``pair_slot`` (the
   inverse of the sort's permutation) gives each candidate's slot in the
   sorted pair list, so ``pair_slot`` over a run ascends too.

By default sizing is exact per frame: one host sync of the row total
after level 1 and one of the pair total after level 2, as the original
CUDA renderer did. ``pair_cap=`` bins at the reference's fixed capacities
instead, with no host read (so a CUDA graph can hold the step): both
expansions write into their capacities and read their live totals on the
device, what lies past a capacity is dropped as the reference drops it,
and ``overflow`` / ``row_overflow`` report what the frame needed, counted
as the reference counts it (one sentinel row for each Gaussian without a
row, one sentinel candidate for each row without a tile), so that the
caller grows the capacities. Exact sizing reports the same requirements.

The reference's binning also carries each pair's attributes through its
sort, rounded to its packed stream by default (``bf16_colors=True``). Here
no attribute rides binning (the rasterizers read them through
``splat_gid``), so ``bf16_colors`` is only recorded on the tables, and the
rasterizers round each pair as that stream would carry it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.expand import segment_expand
from ..kernels.segsum import inverse_permutation
from ..kernels.sort import radix_sort

_QD_Z0 = 1e-4
_QD_OCTAVES = 32.0
# Float -> int32 conversions clamp first (XLA's conversion saturates; a raw
# torch cast of an out-of-range float is undefined). Any bound beyond the
# image's tile count works: results are clipped to the grid afterwards.
_I32_SAFE = float(1 << 30)


class TileTables(NamedTuple):
    """Per-tile ranges of the sorted pair list, and per-Gaussian runs of it.

    ``splat_gid[tile_start[t] : tile_start[t] + tile_count[t]]`` are tile
    t's Gaussian ids, depth-ascending. Exactly ``num_pairs`` long, or, at
    fixed capacities, ``pair_cap`` long with a -1 tail past the live
    ``num_pairs``. ``pair_slot[pair_start[g] : pair_start[g + 1]]`` are
    Gaussian g's slots in that list, ascending.
    """

    splat_gid: torch.Tensor  # (P,) int32
    tile_start: torch.Tensor  # (T,) int32
    tile_count: torch.Tensor  # (T,) int32
    pair_slot: torch.Tensor  # (P,) int32, candidate -> sorted slot
    pair_start: torch.Tensor  # (N+1,) int32, Gaussian -> first candidate; [N] = pairs
    num_pairs: int | torch.Tensor  # a host int, or a () int32 device count when capped
    bf16_colors: bool  # the rasterizers round pairs to the packed stream
    # The reference's requirements, () int32 on the device: the pair
    # capacity and the row capacity the frame needs (sentinels counted).
    overflow: torch.Tensor | None = None
    row_overflow: torch.Tensor | None = None


class Geometry(NamedTuple):
    """Per-Gaussian binning geometry (OBB axes and ellipse scale)."""

    u: torch.Tensor
    v: torch.Tensor
    a1x: torch.Tensor
    a1y: torch.Tensor
    a2x: torch.Tensor
    a2y: torch.Tensor
    s_e: torch.Tensor
    qd: torch.Tensor  # int32 quantized depth


def depth_key_bits(num_tiles: int) -> int:
    """Quantized-depth bits packed below the tile index in the sort key."""
    return max(1, min(16, 30 - int(num_tiles).bit_length()))


def sort_key_bits(num_tiles: int, qd_bits: int) -> int:
    """Width of the largest key ((num_tiles - 1) << qd) | (2^qd - 1)."""
    return ((int(num_tiles) << qd_bits) - 1).bit_length()


def quantize_depth(z: torch.Tensor, qd_bits: int) -> torch.Tensor:
    """z -> int32 log-spaced depth bucket in [0, 2^qd_bits)."""
    levels = float(1 << qd_bits)
    scale = levels / _QD_OCTAVES
    z0 = torch.full((), _QD_Z0, dtype=torch.float32, device=z.device)
    q = torch.floor((torch.log2(torch.maximum(z, z0)) - torch.log2(z0)) * scale)
    return torch.clamp(q, 0.0, levels - 1.0).to(torch.int32)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """Saturating f32 -> int32 (NaN -> 0), as XLA converts."""
    x = torch.nan_to_num(x, nan=0.0, posinf=_I32_SAFE, neginf=-_I32_SAFE)
    return torch.clamp(x, -_I32_SAFE, _I32_SAFE).to(torch.int32)


def _strip_x_extreme(u, a1x, a1y, a2x, a2y, dy0, dy1):
    """Exact max-x of the OBB {s*a1 + t*a2 : |s|,|t| <= 1} (around u)
    within the strip dy in [dy0, dy1]; -inf when it does not reach it."""
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
        ok = t.abs() <= 1.0 + 1e-5
        cands.append(torch.where(ok, sv * a1x + torch.clamp(t, -1, 1) * a2x, neg_inf))
    for tv in (1.0, -1.0):
        s = (d - tv * a2y) / a1y_s
        ok = s.abs() <= 1.0 + 1e-5
        cands.append(torch.where(ok, torch.clamp(s, -1, 1) * a1x + tv * a2x, neg_inf))
    x_con = torch.maximum(
        torch.maximum(cands[0], cands[1]), torch.maximum(cands[2], cands[3])
    )
    return u + torch.where(in_range, x_unc, x_con)


def _strip_x_extreme_ell(u, e1x, e1y, e2x, e2y, dy0, dy1):
    """Exact max-x of the ELLIPSE {s*e1 + t*e2 : s^2+t^2 <= 1} (around u)
    within the strip dy in [dy0, dy1]."""
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
    x_con = alpha * d + w * torch.sqrt(
        torch.clamp(1.0 - (d * d) / torch.clamp(ry2, min=eps), min=0.0)
    )
    x_con = torch.where(ry2 <= eps, rx, x_con)
    return u + torch.where(in_range, rx, x_con)


def _span_y(v, a1y, a2y, s_e, tile_size, nty):
    """Pixel-rect tile-row span [ty0, ty1) of the OBB/ellipse intersection."""
    hy = torch.minimum(
        a1y.abs() + a2y.abs(), s_e * torch.sqrt(a1y * a1y + a2y * a2y)
    )
    ts = float(tile_size)
    ty0 = torch.clamp(_to_i32(torch.ceil((v - hy - (ts - 1.0)) / ts)), 0, nty)
    ty1 = torch.clamp(_to_i32(torch.floor((v + hy) / ts)) + 1, 0, nty)
    return ty0, ty1


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive offsets of ``counts`` plus their total: (n+1,) int32, on
    the device."""
    zero = torch.zeros((1,), dtype=torch.int32, device=counts.device)
    return torch.cat([zero, torch.cumsum(counts, dim=0, dtype=torch.int32)])


def _exclusive_offsets(counts: torch.Tensor):
    """(exclusive offsets + total as an (n+1,) int32 tensor, host total)."""
    ext = _offsets(counts)
    return ext, int(ext[-1])  # host sync: the exact size of the next level


def _row_counts(uv, z, radius, mask, *, num_tiles_x, num_tiles_y, tile_size, row_limit,
                depth_rank):
    """Level 1's per-Gaussian inputs: (geometry, first tile row ty0, row
    counts), every one on the device."""
    ts = float(tile_size)
    u, v = uv[:, 0], uv[:, 1]
    r_major, r_minor = radius[:, 0], radius[:, 1]
    sin_t, cos_t = radius[:, 2], radius[:, 3]
    a1x, a1y = r_major * cos_t, r_major * sin_t
    a2x, a2y = -r_minor * sin_t, r_minor * cos_t
    # (N, 4) records (hand-built OBBs) get s_e = 2 >= sqrt(2): pure OBB.
    s_e = radius[:, 4] if radius.shape[1] >= 5 else torch.full_like(u, 2.0)
    hx = torch.minimum(
        a1x.abs() + a2x.abs(), s_e * torch.sqrt(a1x * a1x + a2x * a2x)
    )
    nty_eff = num_tiles_y if row_limit is None else row_limit
    ty0, ty1 = _span_y(v, a1y, a2y, s_e, tile_size, nty_eff)
    has_x = (torch.floor((u + hx) / ts) >= 0) & (
        torch.ceil((u - hx - (ts - 1.0)) / ts) < num_tiles_x
    )
    zero = torch.zeros_like(ty0)
    row_counts = torch.where(mask & has_x, torch.clamp(ty1 - ty0, min=0), zero)
    if depth_rank is not None:
        qd = torch.where(row_counts > 0, depth_rank.to(torch.int32), zero)
    else:
        qd = quantize_depth(z, depth_key_bits(num_tiles_x * num_tiles_y))
    return Geometry(u, v, a1x, a1y, a2x, a2y, s_e, qd), ty0, row_counts


def row_expand_inputs(uv, z, radius, mask, *, num_tiles_x, num_tiles_y, tile_size,
                      row_limit=None, depth_rank=None):
    """Level-1 records: one run of tile rows per visible Gaussian, rows
    clipped to ``[0, row_limit)`` (default ``num_tiles_y``). The depth
    field is ``depth_rank`` where given (0 for Gaussians without a row),
    else the quantized depth.

    Returns (geometry, records (2, N) int32 [gid, ty0 - offset],
    offsets_ext (N+1,) int32, total_rows). After expansion, slot s of a
    Gaussian's run is tile row ``s + records[1]``.
    """
    geom, ty0, row_counts = _row_counts(
        uv, z, radius, mask, num_tiles_x=num_tiles_x, num_tiles_y=num_tiles_y,
        tile_size=tile_size, row_limit=row_limit, depth_rank=depth_rank)
    off_ext, total_rows = _exclusive_offsets(row_counts)
    return geom, _records(ty0, off_ext), off_ext, total_rows


def _records(base: torch.Tensor, off_ext: torch.Tensor) -> torch.Tensor:
    """Level 1's (2, N) int32 records [gid, base - offset]: slot s of
    Gaussian g's run then has ``s + records[1] = base[g] + (s - offset[g])``."""
    rid = torch.arange(base.shape[0], dtype=torch.int32, device=base.device)
    return torch.stack([rid, base - off_ext[:-1]])


def _pair_counts(geom: Geometry, rows: torch.Tensor, *, num_tiles_x, tile_size):
    """Level 2's per-row inputs: (Gaussian id, first tile index of the
    run, tile count) of each expanded (2, R) [gid, base] row."""
    ts = float(tile_size)
    num_rows = rows.shape[1]
    dev = rows.device
    gid_r = rows[0]
    row_y = torch.arange(num_rows, dtype=torch.int32, device=dev) + rows[1]
    g = gid_r.long()
    r_u, r_v = geom.u[g], geom.v[g]
    r_a1x, r_a1y, r_a2x, r_a2y = geom.a1x[g], geom.a1y[g], geom.a2x[g], geom.a2y[g]
    r_se = geom.s_e[g]
    # Strip of PIXEL rows: py = row_y*ts + 0..ts-1, dy = py - v.
    dy0 = row_y.to(torch.float32) * ts - r_v
    dy1 = dy0 + (ts - 1.0)
    # x-interval of the OBB-ellipse intersection within the strip.
    xhi_o = _strip_x_extreme(r_u, r_a1x, r_a1y, r_a2x, r_a2y, dy0, dy1)
    xlo_o = -_strip_x_extreme(-r_u, -r_a1x, r_a1y, -r_a2x, r_a2y, dy0, dy1)
    e1x, e1y = r_se * r_a1x, r_se * r_a1y
    e2x, e2y = r_se * r_a2x, r_se * r_a2y
    xhi_e = _strip_x_extreme_ell(r_u, e1x, e1y, e2x, e2y, dy0, dy1)
    xlo_e = -_strip_x_extreme_ell(-r_u, -e1x, e1y, -e2x, e2y, dy0, dy1)
    xhi = torch.minimum(xhi_o, xhi_e)
    xlo = torch.maximum(xlo_o, xlo_e)
    ok = torch.isfinite(xlo) & torch.isfinite(xhi)
    # Pixel-rect tile gate: tile tx covers pixels tx*ts .. tx*ts + (ts-1).
    zero_f = torch.zeros_like(xlo)
    cx0 = torch.clamp(
        _to_i32(torch.ceil((torch.where(ok, xlo, zero_f) - (ts - 1.0)) / ts)),
        0, num_tiles_x - 1,
    )
    cx1 = torch.clamp(
        _to_i32(torch.floor(torch.where(ok, xhi, zero_f - 1.0) / ts)),
        -1, num_tiles_x - 1,
    )
    empty = (~ok) | (torch.floor(xhi / ts) < 0) | (
        torch.ceil((xlo - (ts - 1.0)) / ts) >= num_tiles_x
    )
    counts2 = torch.where(
        empty, torch.zeros_like(cx0), torch.clamp(cx1 - cx0 + 1, min=0)
    )
    return gid_r, row_y * num_tiles_x + cx0, counts2


def pair_expand_inputs(geom: Geometry, rows: torch.Tensor, *, num_tiles_x, tile_size):
    """Level-2 records: one run of tiles per tile row (exact strip test).

    ``rows`` is the expanded level-1 (2, R) [gid, base]. Returns
    (records (2, R) int32 [gid, tile0 - offset], offsets_ext (R+1,) int32,
    total_pairs). After expansion, slot s of a row's run is tile
    ``s + records[1]``.
    """
    gid_r, tile0, counts2 = _pair_counts(geom, rows, num_tiles_x=num_tiles_x,
                                         tile_size=tile_size)
    off_ext, total_pairs = _exclusive_offsets(counts2)
    return torch.stack([gid_r, tile0 - off_ext[:-1]]), off_ext, total_pairs


def pair_keys(geom: Geometry, pairs: torch.Tensor, qd_bits: int):
    """Sort keys (tile << qd_bits) | qdepth of the expanded (2, P) pairs."""
    num_pairs = pairs.shape[1]
    gid = pairs[0]
    tile_idx = torch.arange(num_pairs, dtype=torch.int32, device=pairs.device) + pairs[1]
    qd = torch.clamp(geom.qd[gid.long()], 0, (1 << qd_bits) - 1)
    return (tile_idx << qd_bits) | qd, gid


def tile_ranges(sorted_keys: torch.Tensor, num_tiles: int, qd_bits: int,
                live: torch.Tensor | None = None):
    """(tile_start, tile_count) from the qd-aligned key boundaries; with
    ``live`` (a device count) only the first ``live`` keys are pairs."""
    bounds = torch.searchsorted(
        sorted_keys,
        torch.arange(num_tiles + 1, dtype=torch.int32, device=sorted_keys.device)
        << qd_bits,
        side="left", out_int32=True,
    )
    if live is not None:
        bounds = torch.minimum(bounds, live)
    return bounds[:-1].contiguous(), (bounds[1:] - bounds[:-1]).contiguous()


# The reference's smallest row capacity: its expand kernel's window (8192
# slots + 128 lanes); it rounds every row capacity up to 4096.
ROW_CAP_FLOOR = 8192 + 128


def resolve_row_cap(pair_cap: int, row_cap: int | None) -> tuple[int, bool]:
    """The row capacity the reference bins at for these caps, and whether
    it was derived from the pair cap (``row_cap`` None or 0). Derived, the
    pair requirement also covers twice the rows, so that one cap's growth
    covers both."""
    derived = not row_cap
    if derived:
        row_cap = max(pair_cap // 2, min(pair_cap, 1 << 19), ROW_CAP_FLOOR)
    else:
        row_cap = max(row_cap, ROW_CAP_FLOOR)
    return ((row_cap + 4095) // 4096) * 4096, derived


def build_tile_tables(
    uv: torch.Tensor,
    z: torch.Tensor,
    radius: torch.Tensor,
    mask: torch.Tensor,
    *,
    num_tiles_x: int,
    num_tiles_y: int,
    tile_size: int,
    row_limit: int | None = None,
    bf16_colors: bool = True,
    depth_rank: torch.Tensor | None = None,
    pair_cap: int | None = None,
    row_cap: int | None = None,
) -> TileTables:
    """Binning of one frame, sized exactly or at fixed capacities.

    Args:
      uv: (N, 2) screen positions. z: (N,) camera depths. radius: (N, 4|5)
      [r_major r_minor sin cos (ell_scale)] records. mask: (N,) visibility.
      row_limit: tile rows at and past it are not enumerated (<=
        ``num_tiles_y``): a strip of a tile-sharded frame whose last rows
        lie past the image's (``parallel/tile_parallel.py``).
      bf16_colors: the reference's default packed mode (f16 tile-relative
        u, v, bf16 conic and opacity, e5s9 colour), recorded on the tables
        for the rasterizers; False is its exact f32 mode.
      depth_rank: optional (N,) int32 dense depth rank (0 = nearest, e.g.
        the argsort of the argsort of z): the reference's exact-ordering
        mode. The rank replaces the quantized depth in the sort key, so a
        tile's splats are in exact rank order. It needs
        ``bitlen(num_tiles) + bitlen(N - 1) <= 30``, N the capacity.
      pair_cap, row_cap: None sizes the frame exactly (two host reads).
        A pair cap bins at the reference's fixed capacities, with no host
        read: the row cap is resolved as the reference resolves it
        (``resolve_row_cap``; None derives it from the pair cap), the
        tables are (pair_cap,) long, ``num_pairs`` is a device count, and
        the rows and candidates past a capacity are dropped as the
        reference drops them (``_capped``).
    """
    num_tiles = num_tiles_x * num_tiles_y
    n = uv.shape[0]
    if depth_rank is not None:
        qd_bits = max(1, int(n - 1).bit_length())
        if int(num_tiles).bit_length() + qd_bits > 30:
            raise ValueError(
                "exact depth-rank mode needs bitlen(tiles) + bitlen(N-1) "
                f"<= 30; got {int(num_tiles).bit_length()} + {qd_bits}"
            )
    else:
        qd_bits = depth_key_bits(num_tiles)
    key_bits = sort_key_bits(num_tiles, qd_bits)
    geom, ty0, rc = _row_counts(
        uv, z, radius, mask, num_tiles_x=num_tiles_x, num_tiles_y=num_tiles_y,
        tile_size=tile_size, row_limit=row_limit, depth_rank=depth_rank,
    )
    if pair_cap is not None:
        return _capped(geom, ty0, rc, pair_cap, row_cap, num_tiles=num_tiles,
                       num_tiles_x=num_tiles_x,
                       tile_size=tile_size, qd_bits=qd_bits, key_bits=key_bits,
                       bf16_colors=bf16_colors)
    off1, total_rows = _exclusive_offsets(rc)
    rows = segment_expand(_records(ty0, off1), off1, total_rows)
    rec2, off2, total_pairs = pair_expand_inputs(
        geom, rows, num_tiles_x=num_tiles_x, tile_size=tile_size
    )
    pairs = segment_expand(rec2, off2, total_pairs)
    keys, gid = pair_keys(geom, pairs, qd_bits)
    sorted_keys, perm = radix_sort(keys, key_bits, site="tile")
    tile_start, tile_count = tile_ranges(sorted_keys, num_tiles, qd_bits)
    # The reference's requirement: a sentinel row for each Gaussian without
    # a row, and a sentinel candidate for each row without a tile and each
    # sentinel row.
    counts2 = off2[1:] - off2[:-1]
    no_row = (rc == 0).sum(dtype=torch.int32)
    return TileTables(
        splat_gid=gid[perm.long()],
        tile_start=tile_start,
        tile_count=tile_count,
        pair_slot=inverse_permutation(perm),
        pair_start=off2[off1.long()],
        num_pairs=total_pairs,
        bf16_colors=bool(bf16_colors),
        overflow=torch.clamp(counts2, min=1).sum(dtype=torch.int32) + no_row,
        row_overflow=torch.clamp(rc, min=1).sum(dtype=torch.int32),
    )


def _capped(geom: Geometry, ty0, rc, pair_cap: int, row_cap: int | None, *, num_tiles,
            num_tiles_x, tile_size, qd_bits, key_bits, bf16_colors) -> TileTables:
    """Binning at fixed capacities, as the reference bins.

    The reference gives every Gaussian at least one row (a sentinel for
    one without) and every row at least one candidate (a sentinel for one
    without a tile), expands both levels in Gaussian order into its
    capacities, and drops the rows and candidates whose slot in that order
    is at or past the capacity. Its slots follow arithmetically from
    ``max(count, 1)`` offsets, so the port keeps exactly the real rows and
    candidates whose slot there is below the cap, without expanding a
    sentinel: a row of Gaussian g, for one, sits behind every sentinel row
    of a Gaussian before g. ``overflow`` and ``row_overflow`` are the
    reference's requirements. Both expansions read their live totals on
    the device (``segment_expand(..., capped=True)``); the tail past the
    live pairs gets the largest key, so the stable sort leaves it behind
    every pair and ``tile_ranges`` stops at the live count.
    """
    n = rc.shape[0]
    dev = rc.device
    # The reference's limits, with its messages.
    if pair_cap >= (1 << 26) or n >= (1 << 23):
        raise ValueError("pair_cap must be < 2^26 and N < 2^23")
    if pair_cap % 512 != 0:
        raise ValueError("pair_cap must be a multiple of 512")
    row_cap, derived = resolve_row_cap(pair_cap, row_cap)
    if row_cap >= (1 << 26):
        raise ValueError("row_cap must be < 2^26")
    # Level 1: the reference's row slots, and the real rows below the cap.
    slot1 = _offsets(torch.clamp(rc, min=1))
    kept1 = torch.minimum(rc, torch.clamp(row_cap - slot1[:-1], min=0))
    off1 = _offsets(kept1)
    rows = segment_expand(_records(ty0, off1), off1, row_cap, capped=True)
    live_r = torch.arange(row_cap, dtype=torch.int32, device=dev) < off1[-1]
    rows = torch.where(live_r, rows, 0)  # the tail is not written
    # Level 2: each live row's first candidate slot in the reference's
    # order (its rows' candidates before it, plus one sentinel for each
    # Gaussian without a row before its own), and the tiles below the cap.
    gid_r, tile0, c2 = _pair_counts(geom, rows, num_tiles_x=num_tiles_x,
                                    tile_size=tile_size)
    c2 = torch.where(live_r, c2, 0)
    need2 = torch.where(live_r, torch.clamp(c2, min=1), 0)
    slot2 = _offsets(need2)
    no_row = rc == 0
    sentinels_before = _offsets(no_row.to(torch.int32))[gid_r.long()]
    kept2 = torch.minimum(c2, torch.clamp(pair_cap - (slot2[:-1] + sentinels_before), min=0))
    off2 = _offsets(kept2)
    pairs = segment_expand(torch.stack([gid_r, tile0 - off2[:-1]]), off2, pair_cap,
                           capped=True)
    num_pairs = off2[-1]
    live_p = torch.arange(pair_cap, dtype=torch.int32, device=dev) < num_pairs
    pairs = torch.where(live_p, pairs, 0)
    keys, gid = pair_keys(geom, pairs, qd_bits)
    keys = torch.where(live_p, keys, (1 << key_bits) - 1)
    sorted_keys, perm = radix_sort(keys, key_bits, site="tile")
    tile_start, tile_count = tile_ranges(sorted_keys, num_tiles, qd_bits, live=num_pairs)
    row_req = slot1[-1]
    # The sentinel rows that fit under the row cap each hold a candidate.
    overflow = slot2[-1] + (no_row & (slot1[:-1] < row_cap)).sum(dtype=torch.int32)
    if derived:
        overflow = torch.maximum(overflow, 2 * row_req)
    return TileTables(
        splat_gid=torch.where(live_p, gid[perm.long()], -1),
        tile_start=tile_start,
        tile_count=tile_count,
        pair_slot=inverse_permutation(perm),
        pair_start=off2[off1.long()],
        num_pairs=num_pairs,
        bf16_colors=bool(bf16_colors),
        overflow=overflow,
        row_overflow=row_req,
    )
