"""Port parity: exact tile binning vs the JAX ``build_tile_tables``.

The port (plain versions of segment expand and radix sort on the CPU) and
the reference in exact mode (``bf16_colors=False``, Pallas in interpret
mode) bin the same scenes of tests/test_render.py. ``tile_start``,
``tile_count``, ``num_pairs`` and every tile's ordered Gaussian list must be
equal.

One hazard is allowed for, and only in the ORDER of a tile's list:
``quantize_depth`` floors ``2048 * log2(z / 1e-4)``, and torch's and XLA's
``log2`` differ in the last bit on some f32 inputs, so a depth right at a
bucket boundary can land in the neighbouring bucket. Where two lists differ,
the sets must still be equal, the differing Gaussians' buckets must differ
by exactly one between the two packages, and both orders must ascend in
depth.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_render import _make_scene  # noqa: E402

from gsplat_tpu.ops import binning as j_binning  # noqa: E402
from gsplat_tpu.ops import covariance as j_cov  # noqa: E402
from gsplat_tpu.ops import projection as j_proj  # noqa: E402
from gsplat_tpu.ops.render import pack_attrs as j_pack_attrs  # noqa: E402
from gsplat_tpu_torch.ops import binning  # noqa: E402
from gsplat_tpu_torch.kernels.expand import segment_expand  # noqa: E402

TILE = 16


def _jax_tables(uv, z, radius, mask, conic, opa, rgb, ntx, nty, pair_cap=4096):
    attrs = j_pack_attrs(jnp.asarray(uv), jnp.asarray(conic), jnp.asarray(rgb),
                         jnp.asarray(opa))
    return j_binning.build_tile_tables(
        jnp.asarray(uv), jnp.asarray(z), jnp.asarray(radius), jnp.asarray(mask),
        attrs=attrs, num_tiles_x=ntx, num_tiles_y=nty, tile_size=TILE,
        pair_cap=pair_cap, chunk_size=128, bf16_colors=False, interpret=True,
    )


def _lists(gid, start, count):
    return [gid[s: s + c].tolist() for s, c in zip(start, count)]


def assert_same_tables(port, ref, z, num_tiles):
    """Equal ranges and lists, up to the documented log2 bucket hazard."""
    np.testing.assert_array_equal(port.tile_start.numpy(), np.asarray(ref.tile_start))
    np.testing.assert_array_equal(port.tile_count.numpy(), np.asarray(ref.tile_count))
    assert port.num_pairs == int(ref.num_pairs)
    p_lists = _lists(port.splat_gid.numpy(), port.tile_start.numpy(),
                     port.tile_count.numpy())
    r_lists = _lists(np.asarray(ref.splat_gid), np.asarray(ref.tile_start),
                     np.asarray(ref.tile_count))
    qd_bits = j_binning.depth_key_bits(num_tiles)
    qd_port = binning.quantize_depth(torch.from_numpy(z), qd_bits).numpy()
    qd_ref = np.asarray(j_binning.quantize_depth(jnp.asarray(z), qd_bits))
    for t, (pl, rl) in enumerate(zip(p_lists, r_lists)):
        if pl == rl:
            continue
        assert sorted(pl) == sorted(rl), f"tile {t}: pair sets differ"
        moved = [g for g, h in zip(pl, rl) if g != h]
        assert all(abs(int(qd_port[g]) - int(qd_ref[g])) == 1 for g in moved), t
        assert np.all(np.diff(qd_port[pl]) >= 0) and np.all(np.diff(qd_ref[rl]) >= 0)


def _port_tables(uv, z, radius, mask, ntx, nty):
    return binning.build_tile_tables(
        torch.from_numpy(uv), torch.from_numpy(z), torch.from_numpy(radius),
        torch.from_numpy(mask), num_tiles_x=ntx, num_tiles_y=nty, tile_size=TILE,
    )


@pytest.mark.parametrize(
    "width,height,n,masked",
    [
        (64, 64, 30, False),  # test_binning_membership_and_depth_order
        (32, 32, 10, True),  # test_binning_mask_and_overflow
        (96, 64, 180, False),  # test_bf16_packed_path_close_to_exact
    ],
)
def test_binning_matches_jax_exact_mode(rng, width, height, n, masked):
    uv, conic, radius, z, opa, rgb = _make_scene(rng, n, width, height)
    mask = np.ones(n, bool)
    if masked:
        mask[1::2] = False
    ntx, nty = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    ref = _jax_tables(uv, z, radius, mask, conic, opa, rgb, ntx, nty)
    port = _port_tables(uv, z, radius, mask, ntx, nty)
    assert port.splat_gid.dtype == torch.int32
    assert port.splat_gid.shape == (port.num_pairs,) and port.num_pairs > 0
    assert_same_tables(port, ref, z, ntx * nty)
    if masked:
        assert set(port.splat_gid.tolist()) <= set(range(0, n, 2))


@pytest.mark.parametrize(
    "width,height,n,masked",
    [(64, 64, 30, False), (32, 32, 10, True), (96, 64, 180, False)],
)
def test_pair_runs_match_brute_force(rng, width, height, n, masked):
    """``pair_cand`` and ``pair_start`` on the scenes above: ``pair_cand``
    is a permutation, ``pair_start`` ends at the pair count, and Gaussian
    g's run of candidates holds exactly the slots of the sorted pair list
    that hold g, in ascending slot (so ascending tile) order."""
    uv, conic, radius, z, opa, rgb = _make_scene(rng, n, width, height)
    mask = np.ones(n, bool)
    if masked:
        mask[1::2] = False
    ntx, nty = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    port = _port_tables(uv, z, radius, mask, ntx, nty)
    gid, cand, start = (t.numpy() for t in (port.splat_gid, port.pair_cand,
                                            port.pair_start))
    assert cand.dtype == start.dtype == np.int32
    assert start.shape == (n + 1,) and start[0] == 0 and start[-1] == port.num_pairs
    np.testing.assert_array_equal(np.sort(cand), np.arange(port.num_pairs))
    slot = np.argsort(cand)  # each candidate's slot in the sorted pair list
    tile_of_slot = np.repeat(np.arange(ntx * nty), port.tile_count.numpy())
    for g in range(n):
        run = slot[start[g]: start[g + 1]]
        np.testing.assert_array_equal(run, np.flatnonzero(gid == g))
        assert np.all(np.diff(tile_of_slot[run]) > 0), g
    cand_gid = np.repeat(np.arange(n), np.diff(start))
    np.testing.assert_array_equal(gid[slot], cand_gid)  # candidate c's Gaussian
    assert (np.diff(start)[~mask] == 0).all() and np.diff(start).max() > 1


def _sort_keys(uv, z, radius, mask, ntx, nty):
    """The tile sort's keys and the candidates' Gaussian ids, stage by stage."""
    geom, rec1, off1, total_rows = binning.row_expand_inputs(
        torch.from_numpy(uv), torch.from_numpy(z), torch.from_numpy(radius),
        torch.from_numpy(mask), num_tiles_x=ntx, num_tiles_y=nty, tile_size=TILE,
    )
    rows = segment_expand(rec1, off1, total_rows)
    rec2, off2, total_pairs = binning.pair_expand_inputs(
        geom, rows, num_tiles_x=ntx, tile_size=TILE
    )
    keys, gid = binning.pair_keys(geom, segment_expand(rec2, off2, total_pairs),
                                  binning.depth_key_bits(ntx * nty))
    return keys.numpy(), gid.numpy()


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize(
    "width,height,n,masked",
    [(64, 64, 30, False), (32, 32, 10, True), (96, 64, 180, False)],
)
def test_pair_cand_is_the_stable_argsort_of_the_tile_keys(rng, width, height, n, masked,
                                                          capped):
    """``pair_cand`` is the stable argsort of the tile sort's keys, and
    ``splat_gid`` the candidates' Gaussians in that order. At a pair cap
    (no pair dropped) the keys past the live pairs are the largest key,
    so the stable sort leaves the tail behind every pair: ``pair_cand[j]``
    is a live candidate exactly for a live ``j``, and the tail maps onto
    the tail in order."""
    uv, conic, radius, z, opa, rgb = _make_scene(rng, n, width, height)
    mask = np.ones(n, bool)
    if masked:
        mask[1::2] = False
    ntx, nty = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    keys, gid = _sort_keys(uv, z, radius, mask, ntx, nty)
    p = len(keys)
    caps = {}
    if capped:
        caps = dict(pair_cap=(p // 512 + 2) * 512)
        key_bits = binning.sort_key_bits(ntx * nty, binning.depth_key_bits(ntx * nty))
        keys = np.concatenate([keys, np.full(caps["pair_cap"] - p, (1 << key_bits) - 1,
                                             np.int32)])
        gid = np.concatenate([gid, np.zeros(caps["pair_cap"] - p, np.int32)])
    perm = np.argsort(keys, kind="stable").astype(np.int32)
    port = binning.build_tile_tables(
        torch.from_numpy(uv), torch.from_numpy(z), torch.from_numpy(radius),
        torch.from_numpy(mask), num_tiles_x=ntx, num_tiles_y=nty, tile_size=TILE, **caps)
    cand = port.pair_cand.numpy()
    assert cand.dtype == np.int32 and int(port.num_pairs) == p > 0
    np.testing.assert_array_equal(cand, perm)
    np.testing.assert_array_equal(port.splat_gid.numpy()[:p], gid[perm][:p])
    live = np.arange(len(cand)) < p
    np.testing.assert_array_equal(cand < p, live)
    np.testing.assert_array_equal(cand[~live], np.arange(p, len(cand)))
    assert int(port.pair_start[-1]) == p


def test_binning_ellipse_records_match_jax(rng):
    """5-column radius records (the opacity-aware ellipse cut), from the
    covariance op as in test_ellipse_cut_is_pixel_exact_and_subset."""
    width = height = 64
    n = 80
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    scale = np.log(rng.uniform(0.05, 0.4, (n, 3))).astype(np.float32)
    xyz_c = rng.uniform([-2, -2, 2], [2, 2, 8], (n, 3)).astype(np.float32)
    opa = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    jac = j_proj.projection_jacobian(jnp.asarray(xyz_c), 50.0, 50.0, 1.0, 1.0)
    sigma = j_cov.sigma_from_quat_scale(jnp.asarray(quat), jnp.asarray(scale))
    uv = rng.uniform(0, [width, height], (n, 2)).astype(np.float32)
    conic, rad = j_cov.conic_and_radius(
        sigma, jac, jnp.eye(4, dtype=jnp.float32), 3.0, opacity_logit=jnp.asarray(opa)
    )
    conic, rad = np.array(conic), np.array(rad)
    assert rad.shape[1] == 5
    z = xyz_c[:, 2]
    mask = np.ones(n, bool)
    ntx = nty = width // TILE
    ref = _jax_tables(uv, z, rad, mask, conic, opa, rgb, ntx, nty)
    port = _port_tables(uv, z, rad, mask, ntx, nty)
    assert_same_tables(port, ref, z, ntx * nty)


def test_stable_key_sort_reproduces_key_gid_order(rng):
    """The port sorts on the key alone (stable). That equals the
    reference's (key, gid) order only because candidates come out
    Gaussian-major with at most one pair per (Gaussian, tile): assert both
    premises and the resulting order."""
    width, height, n = 96, 64, 180
    uv, conic, radius, z, opa, rgb = _make_scene(rng, n, width, height)
    z[: n // 3] = z[0]  # many equal depth buckets: ties broken by gid
    ntx, nty = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    qd_bits = binning.depth_key_bits(ntx * nty)
    mask = np.ones(n, bool)
    keys, gid = _sort_keys(uv, z, radius, mask, ntx, nty)
    assert np.all(np.diff(gid) >= 0), "candidates are not Gaussian-major"
    tile = keys >> qd_bits
    assert len(set(zip(gid.tolist(), tile.tolist()))) == len(gid)
    port = _port_tables(uv, z, radius, mask, ntx, nty)
    order = np.lexsort((gid, keys))
    np.testing.assert_array_equal(port.splat_gid.numpy(), gid[order])
    # Ties really occurred, so the test exercises the gid tiebreak.
    assert len(np.unique(keys)) < len(keys)


@pytest.mark.parametrize("num_tiles", [12, 4293, 1 << 14])
def test_depth_key_bits_match_jax(num_tiles):
    qd = binning.depth_key_bits(num_tiles)
    assert qd == j_binning.depth_key_bits(num_tiles)
    assert binning.sort_key_bits(num_tiles, qd) <= 30
    assert binning.sort_key_bits(4293, 16) == 29  # 1296x840 at tile 16


# ------------------------------------------------ exact-ordering mode (depth_rank)


def _rank_scene(rng):
    """tests/test_render.py::test_depth_rank_exact_ordering's scene: 150
    Gaussians at 64x64, half of them at one depth, and their dense rank."""
    n = 150
    uv, conic, radius, z, opa, rgb = _make_scene(rng, n, 64, 64)
    z[: n // 2] = z[0]
    rank = np.zeros(n, np.int32)
    rank[np.argsort(z, kind="stable")] = np.arange(n, dtype=np.int32)
    return uv, conic, radius, z, opa, rgb, np.ones(n, bool), rank


def _port_rank_tables(uv, z, radius, mask, rank, ntx=4, nty=4):
    return binning.build_tile_tables(
        torch.from_numpy(uv), torch.from_numpy(z), torch.from_numpy(radius),
        torch.from_numpy(mask), num_tiles_x=ntx, num_tiles_y=nty, tile_size=TILE,
        depth_rank=torch.from_numpy(rank),
    )


def test_depth_rank_tables_equal_jax(rng):
    """Under a rank the sort key has no rounding, so R6 cannot swap two
    splats: the port's tables equal JAX's exactly, order included, and
    each tile lists its splats in strictly ascending rank."""
    uv, conic, radius, z, opa, rgb, mask, rank = _rank_scene(rng)
    attrs = j_pack_attrs(jnp.asarray(uv), jnp.asarray(conic), jnp.asarray(rgb),
                         jnp.asarray(opa))
    ref = j_binning.build_tile_tables(
        jnp.asarray(uv), jnp.asarray(z), jnp.asarray(radius), jnp.asarray(mask),
        attrs=attrs, num_tiles_x=4, num_tiles_y=4, tile_size=TILE, pair_cap=2048,
        chunk_size=128, row_cap=1024, interpret=True, depth_rank=jnp.asarray(rank),
    )
    port = _port_rank_tables(uv, z, radius, mask, rank)
    assert port.num_pairs == int(ref.num_pairs) > 0
    np.testing.assert_array_equal(port.tile_start.numpy(), np.asarray(ref.tile_start))
    np.testing.assert_array_equal(port.tile_count.numpy(), np.asarray(ref.tile_count))
    np.testing.assert_array_equal(port.splat_gid.numpy(),
                                  np.asarray(ref.splat_gid)[: port.num_pairs])
    for gids in _lists(port.splat_gid.numpy(), port.tile_start.numpy(),
                       port.tile_count.numpy()):
        assert np.all(np.diff(rank[gids]) > 0)


def test_depth_rank_pair_set_equals_default_mode(rng):
    """The rank changes only the order within a tile: the ranges and each
    tile's set of splats equal the default mode's, and the per-Gaussian
    runs still invert the tile sort."""
    uv, conic, radius, z, opa, rgb, mask, rank = _rank_scene(rng)
    port = _port_rank_tables(uv, z, radius, mask, rank)
    dflt = _port_tables(uv, z, radius, mask, 4, 4)
    np.testing.assert_array_equal(port.tile_start.numpy(), dflt.tile_start.numpy())
    np.testing.assert_array_equal(port.tile_count.numpy(), dflt.tile_count.numpy())
    lists = _lists(port.splat_gid.numpy(), port.tile_start.numpy(), port.tile_count.numpy())
    d_lists = _lists(dflt.splat_gid.numpy(), dflt.tile_start.numpy(),
                     dflt.tile_count.numpy())
    assert [sorted(a) for a in lists] == [sorted(b) for b in d_lists]
    gid, cand, start = (t.numpy() for t in (port.splat_gid, port.pair_cand, port.pair_start))
    np.testing.assert_array_equal(gid, np.repeat(np.arange(len(z)), np.diff(start))[cand])


def test_depth_rank_key_budget():
    """bitlen(tiles) + bitlen(N - 1) <= 30: 1296x840 at tile 16 (4,293
    tiles, 13 bits) takes a capacity of 2^17 (17 bits) exactly, and 2^17 + 1
    raises the reference's ValueError in both packages."""
    ntx, nty = 81, 53
    assert binning.sort_key_bits(ntx * nty, 17) == 30
    for n in (1 << 17, (1 << 17) + 1):
        uv = np.zeros((n, 2), np.float32)
        z = np.ones(n, np.float32)
        radius = np.zeros((n, 4), np.float32)
        mask = np.zeros(n, bool)
        rank = np.arange(n, dtype=np.int32)
        if n == 1 << 17:
            port = _port_rank_tables(uv, z, radius, mask, rank, ntx, nty)
            assert port.num_pairs == 0 and int(port.tile_count.sum()) == 0
            continue
        with pytest.raises(ValueError, match="depth-rank"):
            _port_rank_tables(uv, z, radius, mask, rank, ntx, nty)
        with pytest.raises(ValueError, match="depth-rank"):
            j_binning.build_tile_tables(
                jnp.asarray(uv), jnp.asarray(z), jnp.asarray(radius), jnp.asarray(mask),
                attrs=jnp.zeros((n, 9), jnp.float32), num_tiles_x=ntx, num_tiles_y=nty,
                tile_size=TILE, pair_cap=4096, chunk_size=128, interpret=True,
                depth_rank=jnp.asarray(rank),
            )
