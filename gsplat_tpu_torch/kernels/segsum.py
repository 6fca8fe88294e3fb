"""Segment sum by Gaussian id (port of
``gsplat_tpu/kernels/segsum.py::segment_sum_by_gid``, f32 rows only).

``out[g] = sum(rows[perm[j]] for j with sorted_gid[j] == g)``: the
per-Gaussian sums of the backward rasterizer's per-pair rows, regrouped by
the stable sort ``sorted_gid = splat_gid[perm]``. Row g is zero when
Gaussian g has no pairs. CUDA kernel: ``csrc/segsum.cu`` (one thread per
Gaussian, fixed summation order, deterministic).
"""

from __future__ import annotations

import torch

from . import _build


def segment_sum_plain(
    rows: torch.Tensor, perm: torch.Tensor, sorted_gid: torch.Tensor, n: int
) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of the permuted rows."""
    out = torch.zeros((n, rows.shape[1]), dtype=torch.float32, device=rows.device)
    return out.index_add_(0, sorted_gid.to(torch.int64), rows[perm.to(torch.int64)])


def segment_sum(
    rows: torch.Tensor, perm: torch.Tensor, sorted_gid: torch.Tensor, n: int
) -> torch.Tensor:
    """(n, C) f32 per-Gaussian sums of (P, C) f32 ``rows``.

    ``perm`` (P,) int32 and ``sorted_gid`` (P,) int32 come from the stable
    sort of the pairs' Gaussian ids: ``sorted_gid`` ascending, in [0, n).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (which takes C = 9).
    """
    if rows.device.type == "cpu":
        return segment_sum_plain(rows, perm, sorted_gid, n)
    name = "segment_sum"
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != 9:
        raise ValueError(f"{name}: rows must be (P, 9) float32")
    p = rows.shape[0]
    for t in (perm, sorted_gid):
        if t.dtype != torch.int32 or t.shape != (p,):
            raise ValueError(f"{name}: perm and sorted_gid must be ({p},) int32")
    _build.require_cuda(name, rows, perm, sorted_gid)
    lib = _build.build()
    out = torch.empty((n, 9), dtype=torch.float32, device=rows.device)
    err = lib.gs_segment_sum(
        out.data_ptr(), rows.data_ptr(), perm.data_ptr(), sorted_gid.data_ptr(),
        p, int(n), _build.stream_ptr(rows.device),
    )
    _build.check(err, name)
    _build.launches[name] += 1
    return out
