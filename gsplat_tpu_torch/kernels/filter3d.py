"""Mip-Splatting's 3D filter: the camera sweep (``ops/mip.py::
nearest_depth_plain``) and the filter made from it (``filter_3d_plain``).

A CPU tensor takes the plain versions; CUDA tensors launch
``csrc/filter3d.cu``: the sweep (one thread a few rows, the camera table
staged through shared memory) and, for ``filter_3d_``, the finish in place;
no host read. Bit-equal to the plain versions. Counted as
``_build.launches["filter3d"]``, one a call.
"""

from __future__ import annotations

import math

import torch

from ..ops import mip
from . import _build


def _check(xyz, alive, cameras) -> None:
    name = "filter3d"
    n = xyz.shape[0] if xyz.dim() else -1
    if xyz.dtype != torch.float32 or tuple(xyz.shape) != (n, 3):
        raise ValueError(f"{name}: xyz must be float32 (N, 3), got {xyz.dtype} "
                         f"{tuple(xyz.shape)}")
    if alive.dtype != torch.bool or tuple(alive.shape) != (n,):
        raise ValueError(f"{name}: alive must be bool ({n},), got {alive.dtype} "
                         f"{tuple(alive.shape)}")
    if (cameras.dtype != torch.float32 or cameras.dim() != 2
            or cameras.shape[1] != mip.CAMERA_COLUMNS or cameras.shape[0] < 1):
        raise ValueError(f"{name}: cameras must be float32 (C >= 1, {mip.CAMERA_COLUMNS}), "
                         f"got {cameras.dtype} {tuple(cameras.shape)}")
    for t in (xyz, alive, cameras):
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _launch(fn: str, out, xyz, alive, cameras, *extra) -> None:
    _build.require_cuda(fn, out, xyz, alive, cameras)
    far = torch.empty((1,), dtype=torch.int32, device=xyz.device)
    err = getattr(_build.build(), fn)(
        out.data_ptr(), far.data_ptr(), xyz.data_ptr(), alive.data_ptr(), cameras.data_ptr(),
        xyz.shape[0], cameras.shape[0], *extra, _build.stream_ptr(xyz.device))
    _build.check(err, fn)
    _build.launches["filter3d"] += 1


def nearest_depth(xyz: torch.Tensor, alive: torch.Tensor, cameras: torch.Tensor) -> torch.Tensor:
    """(N,) float32: the depth of each row's nearest seeing camera of the
    sweep table ``cameras`` (``ops/mip.py::camera_table``), for ``xyz``
    (N, 3) float32 and ``alive`` (N,) bool, all contiguous; +inf where none
    sees it and on dead rows."""
    _check(xyz, alive, cameras)
    if xyz.device.type == "cpu":
        return mip.nearest_depth_plain(xyz, alive, cameras)
    depth = torch.empty((xyz.shape[0],), dtype=torch.float32, device=xyz.device)
    _launch("gs_nearest_depth", depth, xyz, alive, cameras)
    return depth


def filter_3d_(out: torch.Tensor, xyz: torch.Tensor, alive: torch.Tensor,
               cameras: torch.Tensor) -> None:
    """Write ``filter_3d_plain(xyz, alive, cameras)`` into ``out`` (N,)
    float32, contiguous, in place."""
    _check(xyz, alive, cameras)
    if out.dtype != torch.float32 or tuple(out.shape) != (xyz.shape[0],):
        raise ValueError(f"filter3d: out must be float32 ({xyz.shape[0]},), got {out.dtype} "
                         f"{tuple(out.shape)}")
    if xyz.device.type == "cpu":
        out.copy_(mip.filter_3d_plain(xyz, alive, cameras))
        return
    _launch("gs_filter_3d", out, xyz, alive, cameras, math.sqrt(mip.FILTER_VARIANCE))
