"""Tile sort (port of ``gsplat_tpu/kernels/sort.py::sample_sort``).

One stable LSD radix sort of non-negative int32 keys that returns the
sorted keys and the stable argsort. The caller gathers its rows with the
permutation instead of carrying payload columns through the sort. CUDA
kernels: ``csrc/sort.cu``, a one-sweep radix sort (one histogram kernel
for every pass, then one kernel per pass with decoupled look-back), which
runs the pass plan ``sort_plan`` gives it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

TILE_KEYS = 4096  # keys per block and pass in csrc/sort.cu (kThreads * kItems)
DIGIT_BITS = 8  # the widest digit csrc/sort.cu takes (256 counters a block)
_RADIX = 1 << DIGIT_BITS
_MAX_PASSES = 4
_HEAD_WORDS = _MAX_PASSES * _RADIX + 32  # digit counts, tile counters
MAX_KEYS = (1 << 30) - 1  # a status word keeps a count in 30 bits
SITES = ("tile", "morton")  # binning's tile sort; the density step's re-sort


@dataclasses.dataclass(frozen=True)
class SortPlan:
    """How csrc/sort.cu sorts n keys of key_bits bits: one pass per digit,
    low digit first (``shifts[p]``, ``bits[p]``), ``num_tiles`` blocks of
    TILE_KEYS keys a pass, and ``scratch_words`` uint32 words of scratch.
    The kernel takes the passes from here: this is the only copy."""

    shifts: tuple[int, ...]
    bits: tuple[int, ...]
    num_tiles: int

    @property
    def scratch_words(self) -> int:
        return _HEAD_WORDS + len(self.shifts) * self.num_tiles * _RADIX


def sort_plan(n: int, key_bits: int) -> SortPlan:
    shifts = tuple(range(0, key_bits, DIGIT_BITS))
    bits = tuple(min(DIGIT_BITS, key_bits - s) for s in shifts)
    return SortPlan(shifts, bits, (n + TILE_KEYS - 1) // TILE_KEYS)


def radix_sort_plain(keys: torch.Tensor, key_bits: int):
    """Plain PyTorch version: ``torch.sort(stable=True)``."""
    del key_bits
    out = torch.sort(keys, stable=True)
    return out.values, out.indices.to(torch.int32)


def radix_sort(keys: torch.Tensor, key_bits: int, site: str | None = None):
    """Stable sort of (P,) int32 keys in [0, 2^key_bits), P < 2^30.

    Returns (sorted keys (P,) int32, permutation (P,) int32) with
    ``sorted = keys[perm]`` and equal keys in input order. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernels. ``site``
    names the main path's call site (one of ``SITES``); a launch counts
    under ``radix_sort`` and, given a site, under ``radix_sort/<site>``.
    """
    if keys.device.type == "cpu":
        return radix_sort_plain(keys, key_bits)
    name = "radix_sort"
    if keys.dim() != 1 or keys.dtype != torch.int32:
        raise ValueError(f"{name}: keys must be (P,) int32")
    if not 1 <= key_bits <= 31:
        raise ValueError(f"{name}: key_bits must be in [1, 31], got {key_bits}")
    if keys.shape[0] > MAX_KEYS:
        raise ValueError(f"{name}: at most {MAX_KEYS} keys, got {keys.shape[0]}")
    if site is not None and site not in SITES:
        raise ValueError(f"{name}: site must be one of {SITES}, got {site!r}")
    _build.require_cuda(name, keys)
    return _launch(keys, key_bits, site)


def _launch(keys: torch.Tensor, key_bits: int, site: str | None):
    """Two allocations: the sorted keys and indices, rows of one (2, n)
    tensor as csrc/sort.cu wants them (it also passes pairs through those
    8n bytes), which the caller keeps; and n pairs plus the scratch, freed
    on return."""
    n = keys.shape[0]
    plan = sort_plan(n, key_bits)
    passes = len(plan.shifts)
    plan_arg = (ctypes.c_int * (2 * passes))(
        *(v for sb in zip(plan.shifts, plan.bits) for v in sb))
    lib = _build.build()
    dev = keys.device
    out = torch.empty((2, n), dtype=torch.int32, device=dev)
    tmp = torch.empty((2 * n + plan.scratch_words,), dtype=torch.int32, device=dev)
    o, t = out.data_ptr(), tmp.data_ptr()  # pointers by offset: no view objects
    err = lib.gs_radix_sort(keys.data_ptr(), o, o + 4 * n, t, t + 8 * n, n, passes,
                            ctypes.addressof(plan_arg), _build.stream_ptr(dev))
    _build.check(err, "radix_sort")
    _build.launches["radix_sort"] += 1
    if site is not None:
        _build.launches[f"radix_sort/{site}"] += 1
    return out[0], out[1]
