"""Port parity: the packed-mode bit formats (``gsplat_tpu_torch/kernels/
packing.py``) against ``gsplat_tpu/kernels/packing.py`` and the reference's
``pack_grad_rows`` / ``unpack_grad_rows``, bit for bit, on ~10^5 seeded
values per function plus the edge cases: zeros of both signs, negatives,
ties at the bf16, f16 and e5s9 rounding points, f16 subnormals, values
past the +-16384 clamp of the tile-relative offsets, and the largest
|value| of an e5s9 triple at both ends of each bias window. ``unpack`` of
``pack`` is the identity on values that are already rounded, and ``pack``
of ``unpack`` on words. Plain jnp and torch only: no Pallas kernel is
compiled.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gsplat_tpu.kernels import packing as jpk  # noqa: E402
from gsplat_tpu.kernels import rasterize as j_raster  # noqa: E402
from gsplat_tpu_torch.kernels import packing as tpk  # noqa: E402

N = 100_000


def _bits(x) -> np.ndarray:
    """32-bit patterns of a float32 or int32 array or tensor."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32)


def _same(got, ref, what=""):
    got, ref = _bits(got), _bits(ref)
    bad = np.flatnonzero(got != ref)
    assert bad.size == 0, f"{what}: {bad.size} differ, first at {bad[:4]}"


def _wide(rng, n, lo=-40, hi=20):
    """Signed float32 values spread over exponents 2^lo .. 2^hi."""
    mant = rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
    return (mant * np.exp2(rng.integers(lo, hi, n))).astype(np.float32)


def _bf16_ties(rng, n):
    """Values exactly halfway between two bf16 neighbours (both parities of
    the lower one): bf16 bits [sign | exponent 100..149 | 7 random bits],
    then the half step 0x8000 below them."""
    sign = rng.integers(0, 2, n).astype(np.uint32) << 15
    exp = rng.integers(100, 150, n).astype(np.uint32) << 7
    hi = sign | exp | rng.integers(0, 1 << 7, n).astype(np.uint32)
    return ((hi << 16) | np.uint32(0x8000)).view(np.float32)


def _f16_ties(rng, n):
    """Values halfway between f16 neighbours: normal and subnormal ranges."""
    k = rng.integers(1, 1 << 11, n)
    e = rng.integers(-24, 12, n)  # 2^-24 is the f16 subnormal step
    sign = rng.choice([-1.0, 1.0], n)
    return (sign * (k + 0.5) * np.exp2(e - 10.0)).astype(np.float32)


EDGES = np.array(
    [0.0, -0.0, 1.0, -1.0, 0.5, 65504.0, 65520.0, 1e-5, -6e-5, 6.1e-5, 3e-8, 1e-30,
     1e-40, -1e-40, 2.0**-24, 2.0**-25, 3 * 2.0**-26, 16384.0, 16384.5, -16385.0, 1e6,
     -3e38, 2.0**-14, 2.0**-15, 1.0 + 2.0**-8, 1.0 + 3 * 2.0**-9],
    np.float32)


@pytest.fixture(scope="module")
def values():
    rng = np.random.default_rng(2024)
    vals = np.concatenate([EDGES, _wide(rng, N), _bf16_ties(rng, N // 4), _f16_ties(rng, N // 4)])
    return vals, rng.permutation(vals)


def test_bf16_pair_bit_equal(values):
    a, b = values
    ref = jpk.pack_bf16_pair(jnp.asarray(a), jnp.asarray(b))
    got = tpk.pack_bf16_pair(torch.from_numpy(a), torch.from_numpy(b))
    _same(got, ref, "pack_bf16_pair")
    for g, r, name in zip(tpk.unpack_bf16_pair(got), jpk.unpack_bf16_pair(ref), "hl"):
        _same(g, r, f"unpack_bf16_pair {name}")


def test_f16_pair_and_flush_bit_equal(values):
    # The pack site clamps the tile-relative offsets to +-16384 first.
    a, b = (np.clip(x, -16384.0, 16384.0) for x in values)
    ref = jpk.pack_f16_pair(jnp.asarray(a), jnp.asarray(b))
    got = tpk.pack_f16_pair(torch.from_numpy(a), torch.from_numpy(b))
    _same(got, ref, "pack_f16_pair")
    for g, r, name in zip(tpk.unpack_f16_pair(got), jpk.unpack_f16_pair(ref), "hl"):
        _same(g, r, f"unpack_f16_pair {name}")
    u = jax.lax.bitcast_convert_type(ref, jnp.uint32)
    w = got.to(torch.int64) & 0xFFFFFFFF
    _same(tpk.f16_bits_to_f32(w >> 16), jpk.f16_bits_to_f32(u >> 16), "f16_bits_to_f32 hi")
    _same(tpk.f16_bits_to_f32(w), jpk.f16_bits_to_f32(u & 0xFFFF), "f16_bits_to_f32 lo")
    # subnormal halves decode to 0
    sub = np.abs(np.asarray(jpk.unpack_f16_pair(ref)[0])) < 2.0**-14
    assert sub.any() and (tpk.f16_bits_to_f32(w >> 16).numpy()[sub] == 0).all()


def test_f16_tile_offset_clamps_and_flushes():
    x = torch.tensor([20000.0, -20000.0, 3e-6, 8.0 + 2.0**-12, 100.0], dtype=torch.float32)
    got = tpk.f16_tile_offset(x, torch.tensor(0.0))
    rel = jnp.clip(jnp.asarray(x.numpy()), -16384.0, 16384.0)
    u = jax.lax.bitcast_convert_type(jpk.pack_f16_pair(rel, rel), jnp.uint32)
    _same(got, jpk.f16_bits_to_f32(u >> 16))
    assert got.tolist()[:3] == [16384.0, -16384.0, 0.0]


def _e5_edges(bias):
    """Triples whose largest |value| sits at both ends of the bias window
    [2^-bias, 2^(32-bias)), just outside it, at zero, and at code ties."""
    lo, top = 2.0**-bias, 2.0 ** (32 - bias)
    amax = np.array([0.0, lo * 0.999, lo, lo * 1.001, top * 0.999, top, top * 4, 1.0,
                     lo * 3], np.float64)
    rows = []
    for m in amax:
        rows += [(m, 0.3 * m, -0.7 * m), (-m, m / 300, m / 3e5), (0.0, -m, m)]
    # ties: channel = (k + 0.5) * 2^(e - bias - 7) with the shared exponent
    # set by a first channel of 1.5 * 2^(e - bias)
    for e in (1, 5, 20, 30):
        step = 2.0 ** (e - bias - 7)
        rows += [(1.5 * 2.0 ** (e - bias), (k + 0.5) * step, -(k + 0.5) * step)
                 for k in (0, 1, 2, 127)]
    return np.array(rows, np.float32)


@pytest.mark.parametrize("bias", [jpk._RGB_BIAS, jpk.GRAD_E5_BIAS])
def test_rgb_e5_bit_equal(values, bias):
    assert (tpk.RGB_E5_BIAS, tpk.GRAD_E5_BIAS) == (jpk._RGB_BIAS, jpk.GRAD_E5_BIAS)
    rng = np.random.default_rng(bias)
    a, b = values
    c = rng.permutation(a)
    # spread and skewed triples, and the window's edges
    tri = np.concatenate([np.stack([a, b, c], 1),
                          np.stack([a, b * 1e-3, c * 1e-6], 1),
                          _wide(rng, 3 * (N // 3), -bias - 4, 34 - bias).reshape(-1, 3),
                          _e5_edges(bias)])
    r, g, bb = (np.ascontiguousarray(tri[:, k]) for k in range(3))
    ref = jpk.pack_rgb_e5(jnp.asarray(r), jnp.asarray(g), jnp.asarray(bb), bias=bias)
    got = tpk.pack_rgb_e5(*(torch.from_numpy(x) for x in (r, g, bb)), bias=bias)
    _same(got, ref, "pack_rgb_e5")
    for k, (x, y) in enumerate(zip(tpk.unpack_rgb_e5(got, bias=bias),
                                   jpk.unpack_rgb_e5(ref, bias=bias))):
        _same(x, y, f"unpack_rgb_e5 channel {k}")


def test_grad_rows_bit_equal_to_reference():
    rng = np.random.default_rng(5)
    rows = np.concatenate([
        _wide(rng, 9 * (N // 9), -34, 4).reshape(-1, 9),
        np.zeros((3, 9), np.float32),
        rng.normal(size=(200, 9)).astype(np.float32) * np.exp2(rng.integers(-30, 0, (200, 1))),
    ]).astype(np.float32)
    ref = j_raster.pack_grad_rows(jnp.asarray(rows.T))  # (4, P)
    got = tpk.pack_grad_rows(torch.from_numpy(rows))  # (P, 4)
    assert got.shape == (rows.shape[0], tpk.GRAD_WORDS) and got.dtype == torch.int32
    _same(got.T.contiguous(), ref, "pack_grad_rows")
    _same(tpk.unpack_grad_rows(got).T.contiguous(), j_raster.unpack_grad_rows(ref),
          "unpack_grad_rows")
    # below 2^-24 a colour gradient triple keeps the smallest exponent, so
    # its codes lose bits (2^-26 is 32 codes of 2^-31), and under half a
    # code it flushes to 0
    tiny = torch.zeros((2, 9))
    tiny[0, 6:] = 2.0**-26
    tiny[1, 6:] = 2.0**-33
    back = tpk.unpack_grad_rows(tpk.pack_grad_rows(tiny))
    assert (back[0, 6:] == 2.0**-26).all() and (back[1, 6:] == 0).all()


def test_unpack_pack_round_trips(values):
    a, b = (torch.from_numpy(x) for x in values)
    # bf16 pairs: pack(unpack(w)) == w, and unpack(pack(x)) == x on bf16 values
    w = tpk.pack_bf16_pair(a, b)
    _same(tpk.pack_bf16_pair(*tpk.unpack_bf16_pair(w)), w, "bf16 words")
    hi, lo = tpk.unpack_bf16_pair(w)
    _same(tpk.unpack_bf16_pair(tpk.pack_bf16_pair(hi, lo))[0], hi, "bf16 values")
    # f16 pairs (inside the clamp)
    a16, b16 = (torch.clamp(x, -16384.0, 16384.0) for x in (a, b))
    w = tpk.pack_f16_pair(a16, b16)
    _same(tpk.pack_f16_pair(*tpk.unpack_f16_pair(w)), w, "f16 words")
    # e5s9 at both biases: the words, and the rounded triples
    for bias in (tpk.RGB_E5_BIAS, tpk.GRAD_E5_BIAS):
        w = tpk.pack_rgb_e5(a, b, a * 0.5, bias=bias)
        rgb = tpk.unpack_rgb_e5(w, bias=bias)
        again = tpk.pack_rgb_e5(*rgb, bias=bias)
        _same(tpk.unpack_rgb_e5(again, bias=bias)[0], rgb[0], f"e5s9 values, bias {bias}")
        _same(again, w, f"e5s9 words, bias {bias}")
    rows = torch.from_numpy(_wide(np.random.default_rng(9), 9000, -30, 3).reshape(-1, 9))
    words = tpk.pack_grad_rows(rows)
    _same(tpk.pack_grad_rows(tpk.unpack_grad_rows(words)), words, "gradient words")


def test_round_pair_attrs_is_bf16_then_e5s9_colour():
    # The colour is rounded to bf16 first: packing e5s9 straight from f32
    # differs on some values, and the reference rounds twice.
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.normal(size=(20_000, 9)).astype(np.float32))
    a[:, 0:2] = torch.from_numpy(rng.uniform(-50, 300, (20_000, 2)).astype(np.float32))
    out = tpk.round_pair_attrs(a, torch.tensor(32.0), torch.tensor(48.0))
    twice = tpk.unpack_rgb_e5(tpk.pack_rgb_e5(*(tpk.bf16_round(a[:, k]) for k in (6, 7, 8))))
    once = tpk.unpack_rgb_e5(tpk.pack_rgb_e5(a[:, 6], a[:, 7], a[:, 8]))
    assert all(torch.equal(out[:, 6 + k], twice[k]) for k in range(3))
    assert any(not torch.equal(twice[k], once[k]) for k in range(3))
    assert torch.equal(out[:, 2:6], tpk.bf16_round(a[:, 2:6]))
    assert torch.equal(out[:, 0], tpk.f16_tile_offset(a[:, 0], torch.tensor(32.0)))
