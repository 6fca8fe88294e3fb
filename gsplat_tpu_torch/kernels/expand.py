"""Segment expand (port of ``gsplat_tpu/kernels/expand.py::segment_expand``).

``out[:, s] = records[:, g]`` for the ``g`` with
``offsets_ext[g] <= s < offsets_ext[g+1]``. Sizing is exact: the output has
``total = offsets_ext[-1]`` slots, and records may have zero counts
anywhere (no sentinel rows). CUDA kernel: ``csrc/expand.cu``, a merge-path
load-balanced search: the R run ends and the ``total`` slots are merged,
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
    records: torch.Tensor, offsets_ext: torch.Tensor, total: int
) -> torch.Tensor:
    """Plain PyTorch version: ``repeat_interleave`` by the offset diffs."""
    counts = offsets_ext[1:] - offsets_ext[:-1]
    return torch.repeat_interleave(
        records, counts.to(torch.int64), dim=1, output_size=total
    )


def segment_expand(
    records: torch.Tensor, offsets_ext: torch.Tensor, total: int
) -> torch.Tensor:
    """Expand (C, R) int32/float32 records into (C, total) slots.

    ``offsets_ext`` is (R + 1,) int32: exclusive offsets of each record's
    run plus the total. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel.
    """
    if records.device.type == "cpu":
        return segment_expand_plain(records, offsets_ext, total)
    name = "segment_expand"
    if records.dim() != 2 or records.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"{name}: records must be (C, R) int32/float32")
    c, r = records.shape
    if offsets_ext.dtype != torch.int32 or offsets_ext.shape != (r + 1,):
        raise ValueError(f"{name}: offsets_ext must be ({r + 1},) int32")
    if total >= 2**31:
        raise ValueError(f"{name}: total {total} exceeds int32")
    _build.require_cuda(name, records, offsets_ext)
    return _launch(records, offsets_ext, int(total))


def _launch(records: torch.Tensor, offsets_ext: torch.Tensor, total: int) -> torch.Tensor:
    c, r = records.shape
    lib = _build.build()
    out = torch.empty((c, total), dtype=records.dtype, device=records.device)
    err = lib.gs_segment_expand(
        out.data_ptr(), records.data_ptr(), offsets_ext.data_ptr(), c, r, total,
        _build.stream_ptr(records.device),
    )
    _build.check(err, "segment_expand")
    _build.launches["segment_expand"] += 1
    return out
