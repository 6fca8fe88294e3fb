"""The packed stream's bit formats: f16 tile-relative offsets, bf16 halves
(round to nearest even), shared-exponent e5s9 colour words, and the
four-word gradient row ``[du|dv, dc00|dc01, dc11|dopa, e5s9(dr, dg, db)]``.
Integer bit math on int64 views of the 32-bit patterns."""

from __future__ import annotations

import torch

RGB_E5_BIAS = 20
GRAD_E5_BIAS = 24
F16_CLAMP = 16384.0
LO32 = 0xFFFFFFFF


def _u32(x):
    if x.dtype == torch.float32:
        x = x.contiguous().view(torch.int32)
    return x.to(torch.int64) & LO32


def _i32(u):
    u = u & LO32
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def _f32(u):
    return _i32(u).view(torch.float32)


def _bits16(x, dtype):
    return x.to(torch.float32).to(dtype).view(torch.int16).to(torch.int64) & 0xFFFF


def bf16_round(x):
    return x.to(torch.bfloat16).to(torch.float32)


def f16_offset(x, origin):
    """x - origin as an f16, decoded with subnormals flushed to +0."""
    h = _bits16(torch.clamp(x - origin, -F16_CLAMP, F16_CLAMP), torch.float16)
    expmant = h & 0x7FFF
    val = _f32(((h & 0x8000) << 16) | ((expmant + (112 << 10)) << 13))
    return torch.where(expmant < (1 << 10), torch.zeros_like(val), val)


def pack_e5(r, g, b, bias):
    amax = torch.maximum(torch.maximum(r.abs(), g.abs()), b.abs()).to(torch.float32)
    e = torch.clamp((_u32(amax) >> 23) - 127 + bias, 0, 31)
    inv_scale = _f32((134 - e + bias) << 23)

    def q(c):
        return torch.clamp(torch.round(c.to(torch.float32) * inv_scale), -255.0, 255.0
                           ).to(torch.int64) + 256

    return _i32((e << 27) | (q(r) << 18) | (q(g) << 9) | q(b))


def unpack_e5(word, bias):
    u = _u32(word)
    scale = _f32((120 + (u >> 27) - bias) << 23)
    return [(((u >> s) & 0x1FF) - 256).to(torch.float32) * scale for s in (18, 9, 0)]


def round_pair_attrs(a, x0, y0):
    """Pair rows (..., 9) as the packed stream carries them, u and v
    relative to their tile's origin (x0, y0)."""
    rgb = unpack_e5(pack_e5(*(bf16_round(a[..., k]) for k in (6, 7, 8)), RGB_E5_BIAS),
                    RGB_E5_BIAS)
    return torch.stack([f16_offset(a[..., 0], x0), f16_offset(a[..., 1], y0),
                        *(bf16_round(a[..., k]) for k in (2, 3, 4, 5)), *rgb], dim=-1)


def round_grad_rows(rows):
    """(P, 9) float32 gradient rows as their packed words decode."""
    cols = []
    for i in (0, 2, 4):
        cols += [bf16_round(rows[:, i]), bf16_round(rows[:, i + 1])]
    cols += unpack_e5(pack_e5(rows[:, 6], rows[:, 7], rows[:, 8], GRAD_E5_BIAS),
                      GRAD_E5_BIAS)
    return torch.stack(cols, dim=1)
