"""Tile sort (port of ``gsplat_tpu/kernels/sort.py::sample_sort``).

One stable LSD radix sort of non-negative int32 keys that returns the
sorted keys and the stable argsort. The caller gathers its rows with the
permutation instead of carrying payload columns through the sort. CUDA
kernels: ``csrc/sort.cu`` (histogram, scan, scatter; 8 bits a pass).
"""

from __future__ import annotations

import torch

from . import _build

_TILE = 4096  # keys per block in csrc/sort.cu (kThreads * kItems)
_RADIX = 256


def radix_sort_plain(keys: torch.Tensor, key_bits: int):
    """Plain PyTorch version: ``torch.sort(stable=True)``."""
    del key_bits
    out = torch.sort(keys, stable=True)
    return out.values, out.indices.to(torch.int32)


def radix_sort(keys: torch.Tensor, key_bits: int):
    """Stable sort of (P,) int32 keys in [0, 2^key_bits).

    Returns (sorted keys (P,) int32, permutation (P,) int32) with
    ``sorted = keys[perm]`` and equal keys in input order. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernels.
    """
    if keys.device.type == "cpu":
        return radix_sort_plain(keys, key_bits)
    name = "radix_sort"
    if keys.dim() != 1 or keys.dtype != torch.int32:
        raise ValueError(f"{name}: keys must be (P,) int32")
    if not 1 <= key_bits <= 31:
        raise ValueError(f"{name}: key_bits must be in [1, 31], got {key_bits}")
    _build.require_cuda(name, keys)
    n = keys.shape[0]
    lib = _build.build()
    dev = keys.device
    keys_a = torch.empty_like(keys)
    keys_b = torch.empty_like(keys)
    vals_a = torch.empty((n,), dtype=torch.int32, device=dev)
    vals_b = torch.empty((n,), dtype=torch.int32, device=dev)
    num_blocks = max(1, (n + _TILE - 1) // _TILE)
    hist = torch.empty((_RADIX * num_blocks,), dtype=torch.int32, device=dev)
    err = lib.gs_radix_sort(
        keys.data_ptr(), keys_a.data_ptr(), vals_a.data_ptr(),
        keys_b.data_ptr(), vals_b.data_ptr(), hist.data_ptr(),
        n, key_bits, _build.stream_ptr(dev),
    )
    _build.check(err, name)
    _build.launches[name] += 1
    passes = (key_bits + 7) // 8
    return (keys_a, vals_a) if passes % 2 == 1 else (keys_b, vals_b)
