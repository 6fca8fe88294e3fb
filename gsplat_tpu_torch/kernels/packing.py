"""Packed-mode bit formats (port of ``gsplat_tpu/kernels/packing.py`` and of
``pack_grad_rows`` / ``unpack_grad_rows`` of
``gsplat_tpu/kernels/rasterize.py``), in PyTorch.

The reference's default (packed) mode carries a pair's attributes and
its gradient row in 16-bit halves and one shared-exponent word:

- ``u``, ``v`` as IEEE f16 offsets from the tile's origin, clamped to
  +-``F16_CLAMP``; decoding flushes f16 subnormals to 0;
- ``c00 c01 c11 opa`` as bf16 (round to nearest even);
- ``r g b`` rounded to bf16 first, then as one e5s9 word (``pack_rgb_e5``,
  bias ``RGB_E5_BIAS``);
- a gradient row ``[du dv dc00 dc01 dc11 dopa dr dg db]`` as four int32
  words ``[du|dv, dc00|dc01, dc11|dopa, e5s9(dr, dg, db)]`` with the
  gradient bias ``GRAD_E5_BIAS``: a colour gradient triple whose largest
  |value| is below 2^-24 keeps codes of 2^-31, so it loses bits and under
  2^-32 flushes to 0.

Every function here is integer bit math on int64 views of the 32-bit
patterns and gives the reference's bits. The kernels' copies are in
``csrc/packing.cuh``. ``round_pair_attrs`` applies the whole attribute
rounding to gathered pair rows, as the kernels do when they stage a pair.
"""

from __future__ import annotations

import contextlib

import torch

RGB_E5_BIAS = 20
GRAD_E5_BIAS = 24
F16_CLAMP = 16384.0
GRAD_WORDS = 4  # int32 words of one packed gradient row
_LO32 = 0xFFFFFFFF
_packed = True


def packed() -> bool:
    """The package's mode, which ``build_tile_tables`` and ``rasterize``
    read where their caller passes no flag: True (the reference's default
    packed mode), or False inside ``exact_mode()`` (its exact f32 mode)."""
    return _packed


@contextlib.contextmanager
def exact_mode():
    """For a ``with`` block: the package in the reference's exact f32 mode,
    restored on exit (``train.step`` exports it)."""
    global _packed
    saved, _packed = _packed, False
    try:
        yield
    finally:
        _packed = saved


def _u32(x: torch.Tensor) -> torch.Tensor:
    """A float32 or int32 tensor's 32-bit patterns as non-negative int64."""
    if x.dtype == torch.float32:
        x = x.contiguous().view(torch.int32)
    return x.to(torch.int64) & _LO32


def _i32(u: torch.Tensor) -> torch.Tensor:
    """Non-negative int64 32-bit patterns -> int32 (two's complement)."""
    u = u & _LO32
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def _f32(u: torch.Tensor) -> torch.Tensor:
    """Non-negative int64 32-bit patterns -> the float32 they encode."""
    return _i32(u).view(torch.float32)


def _bf16_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def _f16_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF


def pack_bf16_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two float32 tensors -> int32 words of their bf16 halves (rounded to
    nearest even): ``hi`` in the upper 16 bits."""
    return _i32((_bf16_bits(hi) << 16) | _bf16_bits(lo))


def unpack_bf16_pair(word: torch.Tensor):
    """Inverse of ``pack_bf16_pair``: int32 -> (hi, lo) float32."""
    u = _u32(word)
    return _f32(u & 0xFFFF0000), _f32(u << 16)


def pack_f16_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two float32 tensors -> int32 words of their IEEE f16 halves
    (rounded to nearest even; callers keep them within f16 range)."""
    return _i32((_f16_bits(hi) << 16) | _f16_bits(lo))


def unpack_f16_pair(word: torch.Tensor):
    """Inverse of ``pack_f16_pair``: int32 -> (hi, lo) float32, f16
    subnormals kept (``f16_bits_to_f32`` flushes them)."""
    u = _u32(word)

    def half(h):  # 16-bit pattern -> int16 (two's complement) -> f16 -> f32
        h = torch.where(h >= 1 << 15, h - (1 << 16), h)
        return h.to(torch.int16).view(torch.float16).to(torch.float32)

    return half((u >> 16) & 0xFFFF), half(u & 0xFFFF)


def f16_bits_to_f32(h: torch.Tensor) -> torch.Tensor:
    """IEEE f16 bit patterns (the low 16 bits of an integer tensor) ->
    float32: exact for normals, subnormals and zeros flushed to +0."""
    h = h.to(torch.int64) & 0xFFFF
    sign = (h & 0x8000) << 16
    expmant = h & 0x7FFF
    val = _f32(sign | ((expmant + (112 << 10)) << 13))
    return torch.where(expmant < (1 << 10), torch.zeros_like(val), val)


def pack_rgb_e5(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                bias: int = RGB_E5_BIAS) -> torch.Tensor:
    """Three float32 tensors -> int32 shared-exponent words
    ``[e:5 | qr:9 | qg:9 | qb:9]``: e from the bits of the largest |value|
    (0 for a zero triple), each channel a signed 9-bit code (offset 256)
    at scale 2^(e - bias) / 128, ``torch.round`` (half to even)."""
    amax = torch.maximum(torch.maximum(r.abs(), g.abs()), b.abs()).to(torch.float32)
    e = torch.clamp((_u32(amax) >> 23) - 127 + bias, 0, 31)
    inv_scale = _f32((134 - e + bias) << 23)

    def q(c):
        qi = torch.clamp(torch.round(c.to(torch.float32) * inv_scale), -255.0, 255.0)
        return qi.to(torch.int64) + 256

    return _i32((e << 27) | (q(r) << 18) | (q(g) << 9) | q(b))


def unpack_rgb_e5(word: torch.Tensor, bias: int = RGB_E5_BIAS):
    """Inverse of ``pack_rgb_e5``: int32 -> (r, g, b) float32."""
    u = _u32(word)
    scale = _f32((120 + (u >> 27) - bias) << 23)
    return tuple(
        (((u >> shift) & 0x1FF) - 256).to(torch.float32) * scale for shift in (18, 9, 0)
    )


def pack_grad_rows(rows: torch.Tensor) -> torch.Tensor:
    """(P, 9) float32 gradient rows -> (P, 4) int32 words
    ``[du|dv, dc00|dc01, dc11|dopa, e5s9(dr, dg, db)]``."""
    cols = [pack_bf16_pair(rows[:, i], rows[:, i + 1]) for i in (0, 2, 4)]
    cols.append(pack_rgb_e5(rows[:, 6], rows[:, 7], rows[:, 8], bias=GRAD_E5_BIAS))
    return torch.stack(cols, dim=1)


def unpack_grad_rows(words: torch.Tensor) -> torch.Tensor:
    """(P, 4) int32 words -> (P, 9) float32 gradient rows."""
    cols = []
    for i in range(3):
        cols += unpack_bf16_pair(words[:, i])
    cols += unpack_rgb_e5(words[:, 3], bias=GRAD_E5_BIAS)
    return torch.stack(cols, dim=1)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the float32 value of its bf16 (nearest even)."""
    return x.to(torch.bfloat16).to(torch.float32)


def f16_tile_offset(x: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """``x - origin`` in float32, clamped to +-F16_CLAMP, rounded to f16 and
    decoded as the kernels decode it (subnormals flushed)."""
    rel = torch.clamp(x - origin, -F16_CLAMP, F16_CLAMP)
    return f16_bits_to_f32(_f16_bits(rel))


def round_pair_attrs(a: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """Pair attribute rows ``a`` (..., 9) ``[u v c00 c01 c11 opa r g b]``
    rounded as the packed stream carries them, ``u`` and ``v`` relative
    to their tile's pixel origin ``(x0, y0)`` (float32, broadcast against
    ``a[..., 0]``): f16 offsets, bf16 conic and opacity, bf16 then e5s9
    colour."""
    rgb = unpack_rgb_e5(pack_rgb_e5(*(bf16_round(a[..., k]) for k in (6, 7, 8))))
    return torch.stack(
        [f16_tile_offset(a[..., 0], x0), f16_tile_offset(a[..., 1], y0),
         *(bf16_round(a[..., k]) for k in (2, 3, 4, 5)), *rgb],
        dim=-1,
    )
