"""Port parity: the plain versions of the port's three kernels.

- segment expand vs ``np.repeat`` and the JAX ``segment_expand`` (interpret
  mode) at the geometry of tests/test_kernels.py: bit-equal; and vs
  ``np.repeat`` on the adversarial counts chip_smoke.py holds the kernel
  to on the card (``expand_edge_counts``);
- radix sort (stable) vs a numpy lexsort on (key, gid): equal;
- segment sum over contiguous per-Gaussian runs vs a numpy oracle of the
  gathered sum it replaces (rows read through the inverse of the tile
  sort's permutation, in run order): bit-equal, with empty runs, a long
  run, packed words and a capped tail;
- forward rasterizer vs the numpy oracle at the tolerances of
  tests/test_render.py (image rtol 2e-4 / atol 2e-5, T_final rtol 1e-3,
  n_splats exact), including the early-termination/saturation case, in
  exact mode (``bf16_colors=False``; the packed mode is held to the JAX
  package in tests/test_torch_packed.py).

The CUDA kernels themselves are compared with these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from chip_smoke import expand_edge_counts  # noqa: E402
from test_render import _make_scene  # noqa: E402

from gsplat_tpu.kernels.expand import segment_expand as j_segment_expand  # noqa: E402
from gsplat_tpu.ops import oracle  # noqa: E402
from gsplat_tpu_torch.kernels import _build, packing  # noqa: E402
from gsplat_tpu_torch.kernels.expand import segment_expand, segment_expand_plain  # noqa: E402
from gsplat_tpu_torch.kernels.rasterize import (  # noqa: E402
    rasterize_backward, rasterize_forward,
)
from gsplat_tpu_torch.kernels.segsum import segment_sum  # noqa: E402
from gsplat_tpu_torch.kernels.sort import radix_sort, radix_sort_plain  # noqa: E402
from gsplat_tpu_torch.ops.binning import build_tile_tables  # noqa: E402
from gsplat_tpu_torch.ops.render import rasterize  # noqa: E402

TILE = 16


def _offsets_ext(counts):
    return torch.from_numpy(
        np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    )


def test_segment_expand_plain_matches_jax_kernel(rng):
    # tests/test_kernels.py::test_segment_expand_matches_numpy_repeat geometry:
    # compacted counts (zeros only at the tail), as the TPU kernel requires.
    n, s_cap = 1900, 4096
    counts = rng.integers(1, 2, n).astype(np.int32)
    counts[np.sort(rng.choice(n - 2, 3, replace=False))] += 11
    counts[-2:] = 0
    off = (np.cumsum(counts) - counts).astype(np.int32)
    total = int(counts.sum())
    vals = rng.standard_normal((3, n)).astype(np.float32)
    rec = np.concatenate([vals, off[None].astype(np.float32)], axis=0)
    off_ext = np.concatenate([off, [total]]).astype(np.int32)
    ref = np.asarray(j_segment_expand(
        jnp.asarray(rec), jnp.asarray(off_ext), jnp.int32(total), s_cap,
        off_row=3, interpret=True,
    ))[:3, :total]
    got = segment_expand_plain(torch.from_numpy(vals), torch.from_numpy(off_ext), total)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), np.repeat(vals, counts, axis=1))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_segment_expand_zero_counts_anywhere(rng, dtype):
    # The port has no sentinel rows: zero counts may sit anywhere.
    n = 257
    counts = rng.integers(0, 4, n).astype(np.int32)
    counts[:3] = 0
    vals = rng.integers(-1000, 1000, (2, n)).astype(np.float32)
    rec = torch.from_numpy(vals).to(dtype)
    before = dict(_build.launches)
    got = segment_expand(rec, _offsets_ext(counts), int(counts.sum()))
    assert got.dtype == dtype and got.shape == (2, int(counts.sum()))
    np.testing.assert_array_equal(
        got.numpy(), np.repeat(rec.numpy(), counts, axis=1)
    )
    assert _build.launches == before  # the CPU path launches no kernel


def test_wrappers_raise_off_cpu_instead_of_falling_back():
    # Any non-CPU tensor must reach the kernel path, never the plain one.
    rec = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    off = torch.zeros((5,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        segment_expand(rec, off, 0)
    with pytest.raises(ValueError, match="CUDA"):
        radix_sort(torch.zeros((8,), dtype=torch.int32, device="meta"), 8)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32, device="meta")  # noqa: E731
    f32 = lambda *s: torch.zeros(s, dtype=torch.float32, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        rasterize_forward(f32(4, 9), i32(3), i32(2), i32(2), 0.0, num_tiles_x=2)
    with pytest.raises(ValueError, match="CUDA"):
        rasterize_backward(f32(4, 9), i32(3), i32(2), i32(2), f32(2, 5, 256),
                           f32(2, 3, 256), 0.0, pair_cand=i32(3), num_tiles_x=2,
                           num_tiles_y=1)
    with pytest.raises(ValueError, match="CUDA"):
        segment_sum(f32(3, 9), i32(5), 4)
    assert _build.launches == dict.fromkeys(_build.launches, 0)


def _gathered_sums(sorted_rows, perm, counts):
    """The numpy oracle of the sum the port no longer makes: each
    candidate's row gathered from the sorted-order rows through the inverse
    of the tile sort's permutation, added in float32 in run order."""
    slot = np.empty(len(perm), np.int64)
    slot[perm] = np.arange(len(perm))
    out = np.zeros((len(counts), sorted_rows.shape[1]), np.float32)
    c = 0
    for g, k in enumerate(counts):
        for _ in range(k):
            out[g] += sorted_rows[slot[c]]
            c += 1
    return out


@pytest.mark.parametrize("case", ["empty runs", "long run", "packed words", "capped tail"])
def test_segment_sum_plain_sums_contiguous_runs(rng, case):
    # Rows in sorted-pair order, stored at their candidate (the tile sort's
    # permutation) as the backward stores them: the sums over contiguous
    # runs are the gathered sums, bit for bit.
    n = 300
    counts = rng.integers(0, 12, n)
    if case == "empty runs":
        counts[rng.random(n) < 0.6] = 0
        counts[:5] = counts[-5:] = 0
    if case == "long run":
        counts[7] = 2000  # past a CUDA block's 256 Gaussians' worth of rows
    p = int(counts.sum())
    tiles = np.concatenate([np.sort(rng.choice(4096, k, replace=False)) for k in counts])
    perm = np.argsort(tiles, kind="stable").astype(np.int32)
    sorted_rows = (rng.standard_normal((p, 9)) * np.exp2(rng.integers(-20, 8, (p, 1))))
    sorted_rows = sorted_rows.astype(np.float32)
    if case == "packed words":
        words = packing.pack_grad_rows(torch.from_numpy(sorted_rows))
        sorted_rows = packing.unpack_grad_rows(words).numpy()
        stored = torch.empty_like(words)
        stored[torch.from_numpy(perm).long()] = words
    else:
        stored = torch.empty((p, 9), dtype=torch.float32)
        stored[torch.from_numpy(perm).long()] = torch.from_numpy(sorted_rows)
    pair_start = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    if case == "capped tail":  # rows past pair_start[n] are never read
        stored = torch.cat([stored, torch.full((512, 9), float("nan"))])
    got = segment_sum(stored, pair_start, n)
    assert got.dtype == torch.float32 and got.shape == (n, 9)
    np.testing.assert_array_equal(got.numpy(), _gathered_sums(sorted_rows, perm, counts))
    assert (got.numpy()[counts == 0] == 0).all()


@pytest.mark.parametrize("case", [name for name, _ in expand_edge_counts()])
def test_segment_expand_plain_on_edge_counts(case):
    # The counts the kernel is held to on the card: runs past many blocks'
    # shares, stretches of zeros, everything in the last record, ...
    counts = dict(expand_edge_counts())[case]
    rec = torch.from_numpy(
        np.random.default_rng(3).integers(-2**31, 2**31, (2, counts.shape[0]),
                                          dtype=np.int64).astype(np.int32))
    total = int(counts.sum())
    got = segment_expand(rec, _offsets_ext(counts), total)
    assert got.shape == (2, total)
    np.testing.assert_array_equal(got.numpy(), np.repeat(rec.numpy(), counts, axis=1))


@pytest.mark.parametrize("key_bits", [8, 20, 29])
def test_radix_sort_plain_is_stable_lexsort(rng, key_bits):
    # Gaussian-major candidates (gid non-decreasing, at most one pair per
    # (gid, tile)): a stable sort on the key alone must equal the
    # lexicographic (key, gid) order.
    n_gauss, per = 400, 24
    gid = np.repeat(np.arange(n_gauss), per).astype(np.int32)
    tiles = np.stack([rng.choice(64, per, replace=False) for _ in range(n_gauss)])
    qd_bits = key_bits - 6
    qd = rng.integers(0, 4, n_gauss)  # few depth buckets: many key ties
    keys = ((tiles << qd_bits) | qd[:, None]).ravel().astype(np.int32)
    s_keys, perm = radix_sort(torch.from_numpy(keys), key_bits)
    order = np.lexsort((gid, keys))
    np.testing.assert_array_equal(perm.numpy(), order)
    np.testing.assert_array_equal(s_keys.numpy(), keys[order])
    np.testing.assert_array_equal(gid[perm.numpy()], gid[order])
    s2, p2 = radix_sort_plain(torch.from_numpy(keys), key_bits)
    assert torch.equal(s2, s_keys) and torch.equal(p2, perm)


def _port_tables(uv, z, radius, mask, width, height):
    ntx = (width + TILE - 1) // TILE
    nty = (height + TILE - 1) // TILE
    tables = build_tile_tables(
        torch.from_numpy(uv), torch.from_numpy(z), torch.from_numpy(radius),
        torch.from_numpy(mask), num_tiles_x=ntx, num_tiles_y=nty, tile_size=TILE,
        bf16_colors=False,
    )
    gid = tables.splat_gid.numpy()
    start, count = tables.tile_start.numpy(), tables.tile_count.numpy()
    lists = [gid[start[t]: start[t] + count[t]].tolist() for t in range(ntx * nty)]
    return tables, lists, ntx, nty


def _crop(x, ntx, nty, width, height):
    x = x.numpy().reshape(nty, ntx, TILE, TILE).transpose(0, 2, 1, 3)
    return x.reshape(nty * TILE, ntx * TILE)[:height, :width]


def _render_vs_oracle(uv, conic, radius, z, opa, rgb, width, height, bg,
                      img_tol=(2e-4, 2e-5)):
    mask = np.ones(uv.shape[0], bool)
    tables, lists, ntx, nty = _port_tables(uv, z, radius, mask, width, height)
    out = rasterize(
        torch.from_numpy(uv), torch.from_numpy(conic), torch.from_numpy(rgb),
        torch.from_numpy(opa), tables, bg, width=width, height=height, tile=TILE,
    )
    ref_img, ref_t, ref_n = oracle.oracle_render_forward(
        uv, opa, conic, rgb, lists, width, height, TILE, bg
    )
    np.testing.assert_allclose(out.image.numpy(), ref_img,
                               rtol=img_tol[0], atol=img_tol[1])
    # Chunked cumulative products (plain version) vs sequential products
    # (oracle): f32 rounding differs by ~1e-4 relative.
    np.testing.assert_allclose(_crop(out.t_final, ntx, nty, width, height), ref_t,
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(
        _crop(out.n_splats, ntx, nty, width, height).astype(np.int32), ref_n
    )
    return ref_n


@pytest.mark.parametrize("bg", [0.0, 0.6])
def test_rasterize_plain_matches_oracle(rng, bg):
    # tests/test_render.py::test_forward_matches_oracle geometry.
    width, height, n = 48, 32, 40
    uv, conic, radius, z, opa, rgb = _make_scene(rng, n, width, height)
    _render_vs_oracle(uv, conic, radius, z, opa, rgb, width, height, bg)


def test_rasterize_plain_early_termination_and_saturation(rng):
    # tests/test_render.py::test_forward_early_termination_and_saturation.
    width = height = 16
    n = 64
    uv = np.full((n, 2), 8.0, np.float32) + rng.normal(size=(n, 2)) * 0.5
    uv = uv.astype(np.float32)
    conic = np.tile(np.array([[0.5, 0.0, 0.5]], np.float32), (n, 1))
    radius = np.tile(np.array([[6.0, 6.0, 0.0, 1.0]], np.float32), (n, 1))
    z = np.arange(1, n + 1, dtype=np.float32)
    opa = np.full((n,), 4.0, np.float32)  # sigmoid ~ 0.982
    rgb = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    ref_n = _render_vs_oracle(uv, conic, radius, z, opa, rgb, width, height, 1.0,
                              img_tol=(3e-4, 3e-5))
    assert ref_n[8, 8] < n  # the centre pixels stopped early


def test_rasterize_forward_output_layout(rng):
    # Rows [r g b T_final n_splats]; an empty tile is pure background.
    attrs = torch.zeros((1, 9), dtype=torch.float32)
    out = rasterize_forward(
        attrs, torch.zeros((0,), dtype=torch.int32),
        torch.zeros((2,), dtype=torch.int32), torch.zeros((2,), dtype=torch.int32),
        0.25, num_tiles_x=2,
    )
    assert out.shape == (2, 5, 256)
    np.testing.assert_array_equal(out[:, :3].numpy(), 0.25)
    np.testing.assert_array_equal(out[:, 3].numpy(), 1.0)
    np.testing.assert_array_equal(out[:, 4].numpy(), 0.0)
