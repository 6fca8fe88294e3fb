"""Segment sum by Gaussian (port of
``gsplat_tpu/kernels/segsum.py::segment_sum_by_gid``, f32 rows and the
packed gradient words).

``out[g] = sum(rows[pair_slot[c]] for c in [pair_start[g], pair_start[g+1]))``
in ascending c: the per-Gaussian sums of the backward rasterizer's per-pair
rows, read through binning's per-Gaussian runs (``TileTables.pair_slot``,
``pair_start``). Row g is zero when Gaussian g has no pairs. The reference
sums a gid-sorted stream; binning's runs already list each Gaussian's
pairs in the order a stable sort of ``splat_gid`` would, so no second sort
is made. CUDA kernel: ``csrc/segsum.cu`` (9 lanes per Gaussian, one per
column, fixed summation order, deterministic). Packed rows (int32, the
backward's ``pack_grads`` words, as the reference tells them by their
dtype) are unpacked and summed in float32 in the same order (4 lanes per
Gaussian, one per word).

``inverse_permutation`` makes binning's ``pair_slot`` from the tile sort's
permutation (CUDA kernel in the same source: one 4-byte scatter a pair).
Its random stores set its time; stored from the sort's last pass instead,
they made the train step slower (PERF.md).
"""

from __future__ import annotations

import torch

from . import _build, packing


def segment_sum_plain(
    rows: torch.Tensor, pair_slot: torch.Tensor, pair_start: torch.Tensor, n: int
) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of the rows (unpacked first if
    packed) in candidate order over each candidate's Gaussian (on the CPU it
    adds in index order)."""
    if rows.dtype == torch.int32:
        rows = packing.unpack_grad_rows(rows)
    counts = (pair_start[1:] - pair_start[:-1]).long()
    gid = torch.repeat_interleave(
        torch.arange(n, device=rows.device), counts, output_size=pair_slot.shape[0])
    out = torch.zeros((n, rows.shape[1]), dtype=torch.float32, device=rows.device)
    return out.index_add_(0, gid, rows[pair_slot.long()])


def segment_sum(
    rows: torch.Tensor, pair_slot: torch.Tensor, pair_start: torch.Tensor, n: int
) -> torch.Tensor:
    """(n, C) f32 per-Gaussian sums of (P, C) f32 ``rows``, or (n, 9) sums
    of (P, 4) int32 packed gradient words (``packing.pack_grad_rows``).

    Binning's tables: ``pair_slot`` (P,) int32 maps each candidate to its
    row; ``pair_start`` (n+1,) int32 is non-decreasing from 0 to P, Gaussian
    g's candidates being ``[pair_start[g], pair_start[g+1])``. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (which takes
    C = 9).
    """
    if rows.device.type == "cpu":
        return segment_sum_plain(rows, pair_slot, pair_start, n)
    name = "segment_sum"
    packed = rows.dtype == torch.int32
    cols = packing.GRAD_WORDS if packed else 9
    if rows.dim() != 2 or rows.shape[1] != cols or rows.dtype not in (
            torch.float32, torch.int32):
        raise ValueError(f"{name}: rows must be (P, 9) float32 or (P, 4) int32")
    p = rows.shape[0]
    for t, shape in ((pair_slot, (p,)), (pair_start, (n + 1,))):
        if t.dtype != torch.int32 or t.shape != shape:
            raise ValueError(f"{name}: pair_slot must be ({p},) and pair_start "
                             f"({n + 1},) int32")
    _build.require_cuda(name, rows, pair_slot, pair_start)
    lib = _build.build()
    out = torch.empty((n, 9), dtype=torch.float32, device=rows.device)
    err = (lib.gs_segment_sum_packed if packed else lib.gs_segment_sum)(
        out.data_ptr(), rows.data_ptr(), pair_slot.data_ptr(), pair_start.data_ptr(),
        int(n), _build.stream_ptr(rows.device),
    )
    _build.check(err, name)
    _build.launches[name] += 1
    if packed:
        _build.launches[f"{name}/packed"] += 1
    return out


def inverse_permutation_plain(perm: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``index_copy_`` of a ramp."""
    ramp = torch.arange(perm.shape[0], dtype=torch.int32, device=perm.device)
    return torch.empty_like(ramp).index_copy_(0, perm.long(), ramp)


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """(P,) int32 ``out`` with ``out[perm[j]] = j`` for a (P,) int32
    permutation of [0, P). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    if perm.device.type == "cpu":
        return inverse_permutation_plain(perm)
    name = "inverse_permutation"
    if perm.dtype != torch.int32 or perm.dim() != 1:
        raise ValueError(f"{name}: perm must be (P,) int32")
    _build.require_cuda(name, perm)
    lib = _build.build()
    out = torch.empty_like(perm)
    err = lib.gs_inverse_permutation(out.data_ptr(), perm.data_ptr(), perm.shape[0],
                                     _build.stream_ptr(perm.device))
    _build.check(err, name)
    _build.launches[name] += 1
    return out
