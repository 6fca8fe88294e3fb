"""Segment sum by Gaussian (port of
``gsplat_tpu/kernels/segsum.py::segment_sum_by_gid``, f32 rows and the
packed gradient words).

``out[g] = sum(rows[c] for c in [pair_start[g], pair_start[g+1]))`` in
ascending c: the per-Gaussian sums of the backward rasterizer's per-pair
rows, which it stores in candidate order (``TileTables.pair_cand``), so
that each Gaussian's rows are one contiguous run of binning's
``pair_start``. Row g is zero when Gaussian g has no pairs. The reference
sums a gid-sorted stream; a run lists its Gaussian's pairs in the order a
stable sort of ``splat_gid`` would, so no second sort is made. CUDA
kernel: ``csrc/segsum.cu`` (f32 rows: 9 lanes per Gaussian, one per
column; packed rows: a thread per Gaussian, one 16-byte load a row; fixed
summation order, deterministic). Packed rows (int32, the backward's
``pack_grads`` words, as the reference tells them by their dtype) are
unpacked and summed in float32 in the same order.
"""

from __future__ import annotations

import torch

from . import _build, packing


def segment_sum_plain(rows: torch.Tensor, pair_start: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of the rows (unpacked first if
    packed) over each row's Gaussian (on the CPU it adds in index order,
    which is run order). The rows summed are the first ``pair_start[n]``
    (all, or a capped table's live ones)."""
    if rows.dtype == torch.int32:
        rows = packing.unpack_grad_rows(rows)
    counts = (pair_start[1:] - pair_start[:-1]).long()
    live = int(pair_start[-1])
    gid = torch.repeat_interleave(
        torch.arange(n, device=rows.device), counts, output_size=live)
    out = torch.zeros((n, rows.shape[1]), dtype=torch.float32, device=rows.device)
    return out.index_add_(0, gid, rows[:live])


def segment_sum(rows: torch.Tensor, pair_start: torch.Tensor, n: int) -> torch.Tensor:
    """(n, C) f32 per-Gaussian sums of (P, C) f32 ``rows``, or (n, 9) sums
    of (P, 4) int32 packed gradient words (``packing.pack_grad_rows``).

    ``pair_start`` (n+1,) int32 is non-decreasing from 0 to at most P:
    Gaussian g's rows are ``rows[pair_start[g] : pair_start[g+1]]`` (the
    backward rasterizer stores them so). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (which takes C = 9, and
    packed rows at a 16-byte aligned address).
    """
    if rows.device.type == "cpu":
        return segment_sum_plain(rows, pair_start, n)
    name = "segment_sum"
    packed = rows.dtype == torch.int32
    cols = packing.GRAD_WORDS if packed else 9
    if rows.dim() != 2 or rows.shape[1] != cols or rows.dtype not in (
            torch.float32, torch.int32):
        raise ValueError(f"{name}: rows must be (P, 9) float32 or (P, 4) int32")
    if pair_start.dtype != torch.int32 or pair_start.shape != (n + 1,):
        raise ValueError(f"{name}: pair_start must be ({n + 1},) int32")
    _build.require_cuda(name, rows, pair_start)
    if packed and rows.data_ptr() % 16:
        raise ValueError(f"{name}: packed rows must be 16-byte aligned")
    lib = _build.build()
    out = torch.empty((n, 9), dtype=torch.float32, device=rows.device)
    err = (lib.gs_segment_sum_packed if packed else lib.gs_segment_sum)(
        out.data_ptr(), rows.data_ptr(), pair_start.data_ptr(), int(n),
        _build.stream_ptr(rows.device),
    )
    _build.check(err, name)
    _build.launches[name] += 1
    if packed:
        _build.launches[f"{name}/packed"] += 1
    return out
