"""Port parity: the backward rasterizer and the segment sum.

- ``rasterize_backward_plain`` summed per Gaussian over binning's runs by
  ``segment_sum_plain`` against the numpy oracle
  ``oracle_render_backward``, at the geometry and tolerances of
  tests/test_render.py::test_backward_matches_oracle;
- rows past every pixel's n_splats are written, as exact zeros (the
  saturated tile of tests/test_render.py's early-termination test);
- ``rasterize_backward_plain``'s rows are the sorted-order rows (an
  identity ``pair_cand``) stored at binning's ``pair_cand``, in both modes;
- ``segment_sum_plain`` against the JAX ``segment_sum_by_gid`` (f32 rows,
  interpret mode) fed the same rows sorted by Gaussian id, on
  Gaussian-major candidates in a stable tile order; against a numpy oracle
  of the gathered sum over contiguous runs (empty runs, a long run, packed
  words); and, over rows the backward stores at ``pair_cand``, bit-equal
  to a stable sort of ``splat_gid`` followed by ``index_add_`` (the
  regroup the reference makes, which the port leaves out);
- the port's differentiable ``rasterize(bf16_grads=False)`` on exact-mode
  tables against ``jax.vjp`` of the JAX ``rasterize(bf16_grads=False)`` on
  the same tile tables, at a height that is not a multiple of 16 (so the
  padded-grid uv scale shows).

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_render import _make_scene, _tables  # noqa: E402

from gsplat_tpu.kernels.segsum import segment_sum_by_gid  # noqa: E402
from gsplat_tpu.ops import oracle  # noqa: E402
from gsplat_tpu.ops.render import rasterize as j_rasterize  # noqa: E402
from gsplat_tpu_torch.kernels import _build, packing  # noqa: E402
from gsplat_tpu_torch.kernels.rasterize import (  # noqa: E402
    grad_scales, rasterize_backward, rasterize_backward_plain, rasterize_forward,
)
from gsplat_tpu_torch.kernels.segsum import segment_sum, segment_sum_plain  # noqa: E402
from gsplat_tpu_torch.ops.binning import TileTables, build_tile_tables  # noqa: E402
from gsplat_tpu_torch.ops.render import pack_attrs, rasterize  # noqa: E402

TILE = 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _image_to_tiles(img, ntx, nty):
    """(H, W, 3) -> (T, 3, PIX), zero on the padded pixels."""
    h, w, _ = img.shape
    pad = np.zeros((nty * TILE, ntx * TILE, 3), np.float32)
    pad[:h, :w] = img
    x = pad.reshape(nty, TILE, ntx, TILE, 3).transpose(0, 2, 4, 1, 3)
    return _t(x.reshape(ntx * nty, 3, TILE * TILE))


def _port_backward(uv, conic, opa, rgb, tables, d_img, bg, ntx, nty):
    """Per-Gaussian (N, 9) sums of the plain backward's pair rows (the
    rows in candidate order, as the backward stores them)."""
    attrs = pack_attrs(_t(uv), _t(conic), _t(rgb), _t(opa))
    args = (attrs, tables.splat_gid, tables.tile_start, tables.tile_count)
    out = rasterize_forward(*args, bg, num_tiles_x=ntx)
    rows = rasterize_backward_plain(*args, out, _image_to_tiles(d_img, ntx, nty), bg,
                                    pair_cand=tables.pair_cand, num_tiles_x=ntx,
                                    num_tiles_y=nty)
    n = uv.shape[0]
    sums = segment_sum_plain(rows, tables.pair_start, n)
    return rows, sums.numpy(), out


def test_backward_plain_matches_oracle(rng):
    # tests/test_render.py::test_backward_matches_oracle: scene, bg and
    # tolerances (the oracle accumulates in float64, sequentially).
    width, height, n = 32, 16, 16
    uv, conic, radius, z, opa, rgb = _make_scene(rng, n, width, height)
    ntx, nty = width // TILE, height // TILE
    tables = build_tile_tables(_t(uv), _t(z), _t(radius), torch.ones(n, dtype=torch.bool),
                               num_tiles_x=ntx, num_tiles_y=nty, tile_size=TILE)
    bg = 0.4
    grad_image = rng.normal(size=(height, width, 3)).astype(np.float32)
    _, d_attrs, _ = _port_backward(uv, conic, opa, rgb, tables, grad_image, bg, ntx, nty)

    gid, start, count = (x.numpy() for x in tables[:3])
    lists = [gid[start[t]: start[t] + count[t]].tolist() for t in range(ntx * nty)]
    _, ref_t, ref_n = oracle.oracle_render_forward(
        uv, opa, conic, rgb, lists, width, height, TILE, bg)
    o_rgb, o_opa, o_uv, o_conic = oracle.oracle_render_backward(
        uv, opa, conic, rgb, lists, width, height, TILE, bg, ref_t, ref_n,
        grad_image, n)
    sig = 1.0 / (1.0 + np.exp(-opa.astype(np.float64)))
    g_opa_logit = d_attrs[:, 5] * sig * (1.0 - sig)  # the sigmoid chain of pack_attrs
    assert np.abs(o_uv).max() > 1.0  # the scene exercises every family
    np.testing.assert_allclose(d_attrs[:, 6:9], o_rgb, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(g_opa_logit, o_opa, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(d_attrs[:, 0:2], o_uv, rtol=2e-3, atol=3e-3)
    np.testing.assert_allclose(d_attrs[:, 2:5], o_conic, rtol=2e-3, atol=3e-3)


def test_backward_rows_past_every_pixel_are_zero(rng):
    # The stack of tests/test_render.py's early-termination test, with wide
    # Gaussians: 64 opaque splats cover the whole 16x16 tile, so every pixel
    # saturates long before the last pair.
    n = 64
    uv = (np.full((n, 2), 8.0) + rng.normal(size=(n, 2)) * 0.5).astype(np.float32)
    conic = np.tile(np.array([[0.01, 0.0, 0.01]], np.float32), (n, 1))
    radius = np.tile(np.array([[30.0, 30.0, 0.0, 1.0]], np.float32), (n, 1))
    z = np.arange(1, n + 1, dtype=np.float32)
    opa = np.full((n,), 4.0, np.float32)
    rgb = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    tables = build_tile_tables(_t(uv), _t(z), _t(radius), torch.ones(n, dtype=torch.bool),
                               num_tiles_x=1, num_tiles_y=1, tile_size=TILE)
    d_img = rng.normal(size=(16, 16, 3)).astype(np.float32)
    before = dict(_build.launches)
    rows, d_attrs, out = _port_backward(uv, conic, opa, rgb, tables, d_img, 1.0, 1, 1)
    assert _build.launches == before  # CPU: the plain versions ran
    maxn = int(out[:, 4].max())
    assert rows.shape == (tables.num_pairs, 9) == (n, 9)
    assert maxn < n  # the tile saturated before its last pair
    rows = rows[tables.pair_cand.long()]  # sorted pair j's row
    assert (rows[:maxn].abs().sum(dim=1) > 0).any()
    assert torch.equal(rows[maxn:], torch.zeros_like(rows[maxn:]))
    np.testing.assert_array_equal(d_attrs[tables.splat_gid[maxn:].long()], 0.0)


@pytest.mark.parametrize("scene", ["oracle", "wide"])
def test_backward_plain_rows_land_at_pair_cand(rng, scene):
    # The rows the backward stores at binning's pair_cand are its rows in
    # sorted-pair order (an identity pair_cand), permuted: sorted pair j's
    # row is row pair_cand[j], for every row of every tile.
    width, height, n = (32, 16, 16) if scene == "oracle" else (96, 64, 180)
    uv, conic, radius, z, opa, rgb = _make_scene(rng, n, width, height)
    ntx, nty = width // TILE, height // TILE
    tables = build_tile_tables(_t(uv), _t(z), _t(radius), torch.ones(n, dtype=torch.bool),
                               num_tiles_x=ntx, num_tiles_y=nty, tile_size=TILE)
    attrs = pack_attrs(_t(uv), _t(conic), _t(rgb), _t(opa))
    args = (attrs, tables.splat_gid, tables.tile_start, tables.tile_count)
    out = rasterize_forward(*args, 0.4, num_tiles_x=ntx)
    d_tiles = _image_to_tiles(rng.normal(size=(height, width, 3)).astype(np.float32), ntx, nty)
    kw = dict(num_tiles_x=ntx, num_tiles_y=nty)
    p = tables.num_pairs
    ident = torch.arange(p, dtype=torch.int32)
    assert not torch.equal(tables.pair_cand, ident)
    rows = rasterize_backward_plain(*args, out, d_tiles, 0.4, pair_cand=tables.pair_cand, **kw)
    in_order = rasterize_backward_plain(*args, out, d_tiles, 0.4, pair_cand=ident, **kw)
    assert rows.shape == in_order.shape == (p, 9)
    assert (in_order != 0).any(dim=1).sum() > p // 2  # most pairs reach a pixel
    assert torch.equal(rows[tables.pair_cand.long()], in_order)
    assert torch.equal(rows, _stored(in_order, tables.pair_cand))


def _runs(counts, rng, num_tiles=64, qd_bits=4):
    """Gaussian-major candidates, each Gaussian's in ascending tile order
    (as binning emits them), put in a random stable (tile, depth) order:
    (pair_cand, pair_start, splat_gid) as binning's tables hold them."""
    n = len(counts)
    tiles = [np.sort(rng.choice(num_tiles, c, replace=False)) for c in counts]
    qd = rng.integers(0, 1 << qd_bits, n)  # few depth buckets: many key ties
    keys = np.concatenate([(t << qd_bits) | qd[g] for g, t in enumerate(tiles)] + [[]])
    cand_gid = np.repeat(np.arange(n), counts).astype(np.int32)
    perm = np.argsort(keys.astype(np.int64), kind="stable").astype(np.int32)
    pair_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return _t(perm), _t(pair_start), _t(cand_gid[perm])


def _stored(sorted_rows, pair_cand):
    """The rows as the backward stores them: sorted pair j's at
    ``pair_cand[j]``."""
    out = torch.empty_like(sorted_rows)
    out[pair_cand.long()] = sorted_rows
    return out


def _regroup_sums(rows, splat_gid, n):
    """The reference's regroup: a stable sort of the pairs by Gaussian id,
    then the rows added in that order (index_add_ adds in index order on
    the CPU)."""
    order = torch.sort(splat_gid, stable=True)
    out = torch.zeros((n, rows.shape[1]), dtype=torch.float32)
    return out.index_add_(0, order.values.long(), rows[order.indices])


@pytest.mark.parametrize("case", ["runs", "empty frame"])
def test_segment_sum_plain_matches_jax_kernel(rng, case):
    # tests/test_kernels.py::test_segment_sum_by_gid_f32_and_packed sizes:
    # Gaussians without pairs, one with hundreds, rows in pair (tile) order.
    n = 700
    counts = rng.integers(0, 10, n)
    counts[counts < 3] = 0
    counts[3] = 0 if case == "empty frame" else 300
    if case == "empty frame":
        counts[:] = 0
    pair_cand, pair_start, splat_gid = _runs(counts, rng, num_tiles=400)
    p = int(counts.sum())
    rows = rng.standard_normal((p, 9)).astype(np.float32)  # in candidate order
    got = segment_sum(_t(rows), pair_start, n)
    assert torch.equal(got, segment_sum_plain(_t(rows), pair_start, n))
    # JAX takes the rows sorted by Gaussian id (candidate order is such an
    # order); an empty stream is one sentinel slot (id n), never summed.
    cand_gid = np.repeat(np.arange(n), counts).astype(np.int32)
    values, ids = rows.T, cand_gid
    if p == 0:
        values, ids = np.ones((9, 1), np.float32), np.full((1,), n, np.int32)
    ref = np.asarray(segment_sum_by_gid(
        jnp.asarray(values), jnp.asarray(ids), n, interpret=True))[:, :n].T
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    assert got.shape == (n, 9) and (got.numpy()[counts == 0] == 0).all()
    assert torch.equal(splat_gid, _t(cand_gid)[pair_cand.long()])


def test_segment_sum_equals_the_regroup_bit_for_bit(rng):
    # Random runs, and the binned scene of test_backward_plain_matches_oracle:
    # rows in sorted-pair order, stored at pair_cand as the backward stores
    # them, are summed over each Gaussian's run in the order a stable sort
    # of splat_gid gives them, so the sums are the same floats.
    counts = rng.integers(0, 40, 500)
    pair_cand, pair_start, splat_gid = _runs(counts, rng, num_tiles=256, qd_bits=2)
    rows = _t(rng.standard_normal((int(counts.sum()), 9)).astype(np.float32))
    got = segment_sum(_stored(rows, pair_cand), pair_start, 500)
    assert torch.equal(got, _regroup_sums(rows, splat_gid, 500))

    width, height, n = 96, 64, 180
    uv, conic, radius, z, opa, rgb = _make_scene(rng, n, width, height)
    tables = build_tile_tables(_t(uv), _t(z), _t(radius), torch.ones(n, dtype=torch.bool),
                               num_tiles_x=width // TILE, num_tiles_y=height // TILE,
                               tile_size=TILE)
    rows = _t(rng.standard_normal((tables.num_pairs, 9)).astype(np.float32) * 1e3)
    got = segment_sum(_stored(rows, tables.pair_cand), tables.pair_start, n)
    assert torch.equal(got, _regroup_sums(rows, tables.splat_gid, n))


def test_rasterize_vjp_matches_jax(rng):
    # 48x40: a height that is not a multiple of 16, so the uv-gradient scale
    # is 0.5 * 48 (padded grid), not 0.5 * 40 (image).
    width, height, n = 48, 40, 40
    uv, conic, radius, z, opa, rgb = _make_scene(rng, n, width, height)
    mask = np.ones(n, bool)
    j_tables, ntx, nty = _tables(uv, z, radius, mask, width, height, conic, opa, rgb)
    assert grad_scales(ntx, nty) == (24.0, 24.0)
    bg = 0.3
    d_img = rng.normal(size=(height, width, 3)).astype(np.float32)

    def j_image(uv_, conic_, rgb_, opa_):
        return j_rasterize(uv_, conic_, rgb_, opa_, j_tables, jnp.float32(bg),
                           width=width, height=height, tile=TILE, chunk=128,
                           interpret=True, bf16_grads=False).image

    j_img, vjp = jax.vjp(j_image, *(jnp.asarray(x) for x in (uv, conic, rgb, opa)))
    j_grads = vjp(jnp.asarray(d_img))

    num_pairs = int(j_tables.num_pairs)
    splat_gid = _t(np.asarray(j_tables.splat_gid)[:num_pairs])
    # Per-Gaussian runs of the reference's pair list: its slots by Gaussian,
    # ascending, are the candidates; each pair's candidate is its place in
    # that order (what the port's binning derives without a second sort).
    order = torch.sort(splat_gid, stable=True)
    counts = torch.bincount(splat_gid.long(), minlength=n)
    pair_cand = torch.empty(num_pairs, dtype=torch.int32)
    pair_cand[order.indices] = torch.arange(num_pairs, dtype=torch.int32)
    tables = TileTables(
        splat_gid=splat_gid,
        tile_start=_t(np.asarray(j_tables.tile_start)),
        tile_count=_t(np.asarray(j_tables.tile_count)),
        pair_cand=pair_cand,
        pair_start=torch.cat([torch.zeros(1, dtype=torch.int64),
                              torch.cumsum(counts, 0)]).to(torch.int32),
        num_pairs=num_pairs,
        bf16_colors=False,
    )
    leaves = [_t(x).requires_grad_(True) for x in (uv, conic, rgb, opa)]
    out = rasterize(*leaves, tables, bg, width=width, height=height, tile=TILE,
                    bf16_grads=False)
    np.testing.assert_allclose(out.image.detach().numpy(), np.asarray(j_img),
                               rtol=2e-4, atol=2e-5)
    grads = torch.autograd.grad(out.image, leaves, grad_outputs=_t(d_img))
    # Both run the chunked back-to-front replay in f32 (chunks of 64 here,
    # 128 there) and sum pixels in another order: rounding only.
    for name, got, ref in zip(("uv", "conic", "rgb", "opacity"), grads, j_grads):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4,
                                   atol=2e-5 * np.abs(ref).max(), err_msg=name)


def test_rasterize_backward_rejects_bad_shapes():
    attrs = torch.zeros((4, 9), device="meta")
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32, device="meta")  # noqa: E731
    out = torch.zeros((2, 5, 256), device="meta")
    d_tiles = torch.zeros((2, 3, 256), device="meta")
    with pytest.raises(ValueError, match="tiles"):
        rasterize_backward(attrs, i32(3), i32(2), i32(2), out, d_tiles, 0.0,
                           pair_cand=i32(3), num_tiles_x=1, num_tiles_y=1)
    with pytest.raises(ValueError, match=r"\(2, 3, 256\)"):
        rasterize_backward(attrs, i32(3), i32(2), i32(2), out, torch.zeros((2, 4, 256)),
                           0.0, pair_cand=i32(3), num_tiles_x=2, num_tiles_y=1)
    for cand in (i32(4), i32(3).to(torch.int64)):
        with pytest.raises(ValueError, match="pair_cand"):
            rasterize_backward(attrs, i32(3), i32(2), i32(2), out, d_tiles, 0.0,
                               pair_cand=cand, num_tiles_x=2, num_tiles_y=1)
