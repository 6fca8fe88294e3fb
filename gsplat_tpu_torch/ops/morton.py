"""Morton (Z-order) codes for the spatial re-sort after densification
(port of ``gsplat_tpu/ops/morton.py``).

10 bits an axis, interleaved into a 30-bit int32 code; rows outside the
mask get ``0x7FFFFFFF`` so that they sort last. The operations run in the
reference's order, so on the CPU the codes are bit-equal to the JAX ones.
"""

from __future__ import annotations

import torch

BITS = 10
MAXC = (1 << BITS) - 1
KEY_BITS = 31  # the codes and the dead-row key 0x7FFFFFFF fit in 31 bits
DEAD = 0x7FFFFFFF


def _spread_bits_10(n: torch.Tensor) -> torch.Tensor:
    """Insert two zero bits between each of the low 10 bits (int32)."""
    n = n & MAXC
    n = (n | (n << 16)) & 0x030000FF
    n = (n | (n << 8)) & 0x0300F00F
    n = (n | (n << 4)) & 0x030C30C3
    n = (n | (n << 2)) & 0x09249249
    return n


def morton_codes(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N,) int32 codes of (N, 3) float32 positions over the masked rows'
    bounding box; masked-out rows get ``DEAD``."""
    big = torch.tensor(1e30, dtype=torch.float32, device=xyz.device)
    m = mask[:, None]
    lo = torch.where(m, xyz, big).amin(dim=0)
    hi = torch.where(m, xyz, -big).amax(dim=0)
    span = torch.clamp(hi - lo, min=1e-12)
    # Clamped before the cast (the reference clips after it): the same
    # codes for every finite value, and no out-of-range cast on dead rows.
    q = torch.clamp((xyz - lo) * (MAXC / span), 0, MAXC).to(torch.int32)
    code = (
        (_spread_bits_10(q[:, 2]) << 2)
        | (_spread_bits_10(q[:, 1]) << 1)
        | _spread_bits_10(q[:, 0])
    )
    return torch.where(mask, code, torch.full_like(code, DEAD))
