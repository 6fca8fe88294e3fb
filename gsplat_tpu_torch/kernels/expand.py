"""Segment expand (port of ``gsplat_tpu/kernels/expand.py::segment_expand``).

``out[:, s] = records[:, g]`` for the ``g`` with
``offsets_ext[g] <= s < offsets_ext[g+1]``. Exact sizing: the output has
``total = offsets_ext[-1]`` slots, and records may have zero counts
anywhere (no sentinel rows). Capped (``capped=True``, binning at fixed
capacities): the output has ``total`` slots, a static width, of which the
first ``min(offsets_ext[-1], total)`` are live; the kernel reads that count
from device memory, so nothing is read back to size the call, and the
slots past it are left unwritten (the plain version zeroes them). CUDA
kernel: ``csrc/expand.cu``, a merge-path load-balanced search: the R run ends and the ``total`` slots are merged,
and each block of the one launch owns ITEMS_PER_BLOCK items of that merged
sequence, so long runs and long stretches of zero counts cost what any
other items do, and no slot searches global memory.
"""

from __future__ import annotations

import torch

from . import _build

# Merged items (run ends + slots) a block owns: mirrors csrc/expand.cu's
# kItems, which sets the launch; chip_smoke.py sizes its edge cases by it.
ITEMS_PER_BLOCK = 2048


def segment_expand_plain(
    records: torch.Tensor, offsets_ext: torch.Tensor, total: int, capped: bool = False
) -> torch.Tensor:
    """Plain PyTorch version: ``repeat_interleave`` by the offset diffs;
    capped, its first ``total`` slots and zeros past the live ones."""
    counts = offsets_ext[1:] - offsets_ext[:-1]
    if not capped:
        return torch.repeat_interleave(
            records, counts.to(torch.int64), dim=1, output_size=total
        )
    out = torch.zeros((records.shape[0], total), dtype=records.dtype, device=records.device)
    live = torch.repeat_interleave(records, counts.to(torch.int64), dim=1)[:, :total]
    out[:, : live.shape[1]] = live
    return out


def segment_expand(
    records: torch.Tensor, offsets_ext: torch.Tensor, total: int, capped: bool = False
) -> torch.Tensor:
    """Expand (C, R) int32/float32 records into (C, total) slots.

    ``offsets_ext`` is (R + 1,) int32: exclusive offsets of each record's
    run plus their total, which is ``total``; or, ``capped``, the
    static width of the output, the live total being on the device. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if records.device.type == "cpu":
        return segment_expand_plain(records, offsets_ext, total, capped)
    name = "segment_expand"
    if records.dim() != 2 or records.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"{name}: records must be (C, R) int32/float32")
    c, r = records.shape
    if offsets_ext.dtype != torch.int32 or offsets_ext.shape != (r + 1,):
        raise ValueError(f"{name}: offsets_ext must be ({r + 1},) int32")
    if total >= 2**31:
        raise ValueError(f"{name}: total {total} exceeds int32")
    _build.require_cuda(name, records, offsets_ext)
    return _launch(records, offsets_ext, int(total), capped)


def _launch(records: torch.Tensor, offsets_ext: torch.Tensor, total: int,
            capped: bool) -> torch.Tensor:
    c, r = records.shape
    lib = _build.build()
    out = torch.empty((c, total), dtype=records.dtype, device=records.device)
    err = lib.gs_segment_expand(
        out.data_ptr(), records.data_ptr(), offsets_ext.data_ptr(), c, r, total,
        int(capped), _build.stream_ptr(records.device),
    )
    _build.check(err, "segment_expand")
    _build.launches["segment_expand"] += 1
    return out
