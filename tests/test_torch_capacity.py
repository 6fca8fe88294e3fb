"""Port parity: binning at fixed capacities, the monitored step and the
trainer's capacity growth, against the JAX package.

- ``build_tile_tables(pair_cap=, row_cap=)`` against the reference's at
  the same caps (exact mode, Pallas in interpret mode): with room to spare,
  with too small a pair cap, and with both caps too small (4,000 wide
  Gaussians, whose rows pass the reference's smallest row capacity).
  ``num_pairs``, ``overflow``, ``row_overflow``, the tile ranges and every
  tile's Gaussian list must be equal (up to tests/test_torch_binning.py's
  documented log2 bucket hazard, in the order of a list only);
- the live part of capped tables bit-equal to the exactly sized tables,
  which report the same requirements;
- the capped tail is never read: ``pair_cand[j]`` is a live candidate
  exactly for a live ``j``, so the backward stores no row past the live
  candidates and the segment sum, which stops at ``pair_start[N]``, sums
  the live rows as the reference's regroup would;
- ``round_pair_cap`` and ``round_row_cap`` equal to the reference's;
- three ``get_monitored_train_step`` calls at a pair cap on the CPU
  against the reference's ``get_monitored_train_step`` (its default packed
  mode, so tests/test_torch_packed.py's train-step bound on the loss): the
  monitor equal, then bit-equal to the port's exactly sized step;
- a ``Trainer`` whose first pair cap overflows grows its caps by the
  reference's rule, and its steps bin at the grown caps;
- a checkpoint's ``_pair_cap`` and ``_row_cap`` crossing both ways.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_render import _make_scene  # noqa: E402
from test_torch_binning import TILE, _lists, assert_same_tables  # noqa: E402
from test_torch_packed import BG, PAIR_CAP, _scene, _t  # noqa: E402

from gsplat_tpu.ops import binning as j_binning  # noqa: E402
from gsplat_tpu.ops.render import pack_attrs as j_pack_attrs  # noqa: E402
from gsplat_tpu.train import state as j_state  # noqa: E402
from gsplat_tpu.train import step as j_step  # noqa: E402
from gsplat_tpu.utils import checkpoint as j_checkpoint  # noqa: E402
from gsplat_tpu_torch.kernels.rasterize import (  # noqa: E402
    rasterize_backward_plain, rasterize_forward)
from gsplat_tpu_torch.kernels.segsum import segment_sum  # noqa: E402
from gsplat_tpu_torch.ops import binning  # noqa: E402
from gsplat_tpu_torch.ops.render import pack_attrs  # noqa: E402
from gsplat_tpu_torch.train import state as t_state  # noqa: E402
from gsplat_tpu_torch.train import step as t_step  # noqa: E402
from gsplat_tpu_torch.utils import checkpoint as t_checkpoint  # noqa: E402

NAMES = list(t_state.PARAM_DIMS)


@pytest.fixture
def two_threads():
    """Two intra-op threads: the test shares the host with the other test
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)

# (width, height, n, pair_cap, row_cap, widen): tests/test_torch_binning.py's
# third scene with room to spare and with a pair cap too small (derived row
# cap), then 4,000 Gaussians four times as wide, whose 14,089 rows pass the
# reference's smallest row capacity (12,288) and whose pairs pass 16,384.
CASES = [
    (96, 64, 180, 4096, None, 1.0),
    (96, 64, 180, 512, None, 1.0),
    (64, 64, 4000, 16384, 1, 4.0),
]


def _inputs(case):
    width, height, n, _, _, widen = case
    uv, conic, radius, z, opa, rgb = _make_scene(np.random.default_rng(0), n, width, height)
    radius[:, :2] *= widen
    mask = np.ones(n, bool)
    mask[::7] = False
    return uv, conic, radius, z, opa, rgb, mask


def _jax_tables(uv, z, radius, mask, conic, opa, rgb, ntx, nty, pair_cap, row_cap):
    """tests/test_torch_binning.py's reference tables, at a row cap too."""
    attrs = j_pack_attrs(jnp.asarray(uv), jnp.asarray(conic), jnp.asarray(rgb),
                         jnp.asarray(opa))
    return j_binning.build_tile_tables(
        jnp.asarray(uv), jnp.asarray(z), jnp.asarray(radius), jnp.asarray(mask),
        attrs=attrs, num_tiles_x=ntx, num_tiles_y=nty, tile_size=TILE,
        pair_cap=pair_cap, row_cap=row_cap, chunk_size=128, bf16_colors=False,
        interpret=True,
    )


def _port(uv, z, radius, mask, ntx, nty, **caps):
    return binning.build_tile_tables(
        torch.from_numpy(uv), torch.from_numpy(z), torch.from_numpy(radius),
        torch.from_numpy(mask), num_tiles_x=ntx, num_tiles_y=nty, tile_size=TILE, **caps)


@pytest.mark.parametrize("case", CASES)
def test_capped_binning_matches_jax(case):
    width, height, n, pair_cap, row_cap, _ = case
    uv, conic, radius, z, opa, rgb, mask = _inputs(case)
    ntx, nty = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    ref = _jax_tables(uv, z, radius, mask, conic, opa, rgb, ntx, nty, pair_cap=pair_cap,
                      row_cap=row_cap)
    port = _port(uv, z, radius, mask, ntx, nty, pair_cap=pair_cap, row_cap=row_cap)
    assert port.splat_gid.shape == (pair_cap,) and port.pair_cand.shape == (pair_cap,)
    for name in ("num_pairs", "overflow", "row_overflow"):
        got = getattr(port, name)
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == int(getattr(ref, name)), name
    assert_same_tables(port, ref, z, ntx * nty)
    num_pairs = int(port.num_pairs)
    np.testing.assert_array_equal(port.splat_gid.numpy()[num_pairs:], -1)
    overflow, row_overflow = int(port.overflow), int(port.row_overflow)
    row_cap_used, _ = binning.resolve_row_cap(pair_cap, row_cap)
    if case is CASES[0]:
        assert overflow <= pair_cap and row_overflow <= row_cap_used
    else:
        assert overflow > pair_cap and num_pairs <= pair_cap
    if case is CASES[2]:
        assert row_overflow > row_cap_used


@pytest.mark.parametrize("case", CASES)
def test_capped_tables_live_part_equals_exact(case):
    """The exact tables hold the same requirements; without overflow the
    capped tables' live part is bit-equal to them, and with overflow each
    kept pair is one of theirs, in their order within its tile."""
    width, height, n, pair_cap, row_cap, _ = case
    uv, conic, radius, z, opa, rgb, mask = _inputs(case)
    ntx, nty = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    exact = _port(uv, z, radius, mask, ntx, nty)
    capped = _port(uv, z, radius, mask, ntx, nty, pair_cap=pair_cap, row_cap=row_cap)
    _, derived = binning.resolve_row_cap(pair_cap, row_cap)
    want = int(exact.overflow)
    if derived:
        want = max(want, 2 * int(exact.row_overflow))
    if case is not CASES[2]:  # there the rows past the row cap hold no candidate
        assert int(capped.overflow) == want
    assert int(capped.row_overflow) == int(exact.row_overflow)
    num_pairs = int(capped.num_pairs)
    if case is CASES[0]:
        assert num_pairs == exact.num_pairs
        assert torch.equal(capped.splat_gid[:num_pairs], exact.splat_gid)
        assert torch.equal(capped.pair_cand[:num_pairs], exact.pair_cand)
        for name in ("tile_start", "tile_count", "pair_start"):
            assert torch.equal(getattr(capped, name), getattr(exact, name)), name
        return
    assert num_pairs < exact.num_pairs
    ex_lists = _lists(exact.splat_gid.numpy(), exact.tile_start.numpy(),
                      exact.tile_count.numpy())
    cap_lists = _lists(capped.splat_gid.numpy(), capped.tile_start.numpy(),
                       capped.tile_count.numpy())
    for kept, full in zip(cap_lists, ex_lists):
        assert kept == [g for g in full if g in set(kept)]


@pytest.mark.parametrize("case", CASES)
def test_capped_tail_is_never_read(case):
    width, height, n, pair_cap, row_cap, _ = case
    uv, conic, radius, z, opa, rgb, mask = _inputs(case)
    ntx, nty = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    tables = _port(uv, z, radius, mask, ntx, nty, pair_cap=pair_cap, row_cap=row_cap)
    p = int(tables.num_pairs)
    cand = tables.pair_cand.numpy()
    assert cand.shape == (pair_cap,) and 0 < p <= pair_cap
    np.testing.assert_array_equal(cand < p, np.arange(pair_cap) < p)
    assert int(tables.pair_start[-1]) == p
    attrs = pack_attrs(*(_t(x) for x in (uv, conic, rgb, opa)))
    args = (attrs, tables.splat_gid, tables.tile_start, tables.tile_count)
    out = rasterize_forward(*args, BG, num_tiles_x=ntx)
    d_tiles = _t(np.random.default_rng(1).normal(size=(ntx * nty, 3, 256)).astype(np.float32))
    rows = rasterize_backward_plain(*args, out, d_tiles, BG, pair_cand=tables.pair_cand,
                                    num_tiles_x=ntx, num_tiles_y=nty)
    assert rows.shape == (pair_cap, 9) and (rows[:p] != 0).any()
    assert torch.equal(rows[p:], torch.zeros_like(rows[p:]))  # no row stored there
    rows[p:] = float("nan")  # what a kernel's unwritten tail may hold
    sums = segment_sum(rows, tables.pair_start, n)
    # The reference's regroup of the live sorted rows: a stable sort by
    # Gaussian id, then the rows added in that order.
    sorted_rows = rows[tables.pair_cand[:p].long()]
    order = torch.sort(tables.splat_gid[:p], stable=True)
    ref = torch.zeros((n, 9)).index_add_(0, order.values.long(), sorted_rows[order.indices])
    assert torch.equal(sums, ref)


def test_round_caps_match_jax():
    sizes = sorted({0, 1, 511, 512, 513, 2047, 2048, 2049, 4096, 100_000, (1 << 18) - 1,
                    1 << 18, (1 << 18) + 1, (1 << 19) - 1, 1 << 19, (1 << 19) + 1,
                    3_000_000, 5_400_000, 1 << 24, (1 << 26) - 7}
                   | set(np.random.default_rng(1).integers(0, 1 << 24, 40).tolist()))
    for n in sizes:
        for minimum in (512, 2048, 1 << 20):
            assert t_state.round_pair_cap(n, minimum) == j_state.round_pair_cap(n, minimum)
        assert t_state.round_pair_cap(n) == j_state.round_pair_cap(n)
        for minimum in (0, 2048, 12_288):
            assert t_state.round_row_cap(n, minimum) == j_state.round_row_cap(n, minimum)
        assert t_state.round_row_cap(n) == j_state.round_row_cap(n)


@pytest.fixture(scope="module")
def monitored():
    """3 monitored steps of the reference's factory and of the port's, at
    the reference's pair cap, from tests/test_torch_packed.py's start; and
    the port's monitored exactly sized steps."""
    params, alive, cm, j_st, t_st, rng = _scene(64, 40, 300, 320)
    gt, _ = t_step.render_image(t_state.params_from_jax(params, alive, "cpu"),
                                cm.view, cm.proj, cm.campos, BG, t_st)
    gt = gt.numpy()
    start = dict(params, rgb=params["rgb"] + 0.3 * rng.normal(size=(320, 3)).astype(np.float32),
                 opacity=params["opacity"] - 0.5)
    zeros = lambda: {k: jnp.zeros_like(jnp.asarray(v)) for k, v in start.items()}  # noqa: E731
    js = j_state.TrainState(
        params={k: jnp.asarray(v) for k, v in start.items()}, adam_m=zeros(), adam_v=zeros(),
        alive=jnp.asarray(alive), uv_grad_accum=jnp.zeros((320,), jnp.float32),
        accum_dur=jnp.zeros((320,), jnp.int32))
    j_fn = j_step.get_monitored_train_step(j_st)
    j_mon = j_step.fresh_monitor()
    runs = {}
    for label, st in (("capped", dataclasses.replace(t_st, pair_cap=PAIR_CAP)),
                      ("exact", t_st)):
        fn = t_step.get_monitored_train_step(st)
        ts = t_state.init_state(t_state.params_from_jax(start, alive, "cpu"))
        mon = t_step.fresh_monitor("cpu")
        runs[label] = []
        for it in range(3):
            ts, tm, mon = fn(ts, cm.view, cm.proj, cm.campos, _t(gt), BG, it, mon)
            runs[label].append((float(tm.loss), mon.numpy().copy(), int(tm.num_pairs),
                                int(tm.overflow), int(tm.row_overflow),
                                t_state.state_to_numpy(ts)))
    ref = []
    for it in range(3):
        js, jm, j_mon = j_fn(js, *(jnp.asarray(x) for x in (cm.view, cm.proj, cm.campos, gt)),
                             jnp.float32(BG), jnp.int32(it), j_mon)
        ref.append((float(jm.loss), np.asarray(j_mon).copy(), int(jm.num_pairs),
                    int(jm.overflow), int(jm.row_overflow)))
    return runs, ref


@pytest.mark.parametrize("steps", [1, 3])
def test_monitored_step_matches_jax(monitored, steps):
    runs, ref = monitored
    loss, mon, pairs, overflow, row_overflow, _ = runs["capped"][steps - 1]
    j_loss, j_mon, j_pairs, j_overflow, j_row_overflow = ref[steps - 1]
    np.testing.assert_array_equal(mon, j_mon)
    assert (pairs, overflow, row_overflow) == (j_pairs, j_overflow, j_row_overflow)
    assert j_overflow <= PAIR_CAP and mon[2] == 1.0 and pairs > 200
    # tests/test_torch_packed.py's bound on the packed train step's loss
    # (the reference's factory runs its default packed mode).
    np.testing.assert_allclose(loss, j_loss, rtol=1e-3)


def test_capped_step_bit_equal_to_exact(monitored):
    """With room to spare, the step at a pair cap is the exactly sized
    step: losses, monitors and every tensor of the state bit-equal."""
    runs, _ = monitored
    for capped, exact in zip(runs["capped"], runs["exact"]):
        assert capped[0] == exact[0]
        # The pair requirement of a row cap derived from the pair cap also
        # covers twice the rows, as the reference's does.
        assert capped[3] == max(exact[3], 2 * exact[4]) and capped[4] == exact[4]
        assert capped[2] == exact[2] and tuple(capped[1]) == (
            max(exact[1][0], 2 * exact[1][1]), exact[1][1], exact[1][2])
        for group in ("params", "adam_m", "adam_v"):
            for name in NAMES:
                np.testing.assert_array_equal(capped[5][group][name], exact[5][group][name])
        for name in ("alive", "uv_grad_accum", "accum_dur"):
            np.testing.assert_array_equal(capped[5][name], exact[5][name])


def _small_trainer(tmp_path):
    from test_torch_trainer import _write_config

    from gsplat_tpu_torch import config as t_config
    from gsplat_tpu_torch.io import colmap as t_colmap
    from gsplat_tpu_torch.tools.synthetic import write_synthetic_dataset
    from gsplat_tpu_torch.train import init as t_init
    from gsplat_tpu_torch.train import trainer as t_trainer

    root = tmp_path / "data"
    write_synthetic_dataset(root, name="scene", n_views=3, width=64, height=48,
                            n_gaussians=200, n_points=400, device="cpu")
    conf = t_config.parse_config(_write_config(
        tmp_path / "c.yaml", output_dir=str(tmp_path / "out"), print_interval=2,
        adaptive_control_start=10**9, max_gaussians=4096, num_iters=7, pair_cap=512))
    sparse = root / "scene" / "sparse" / "0"
    cams = t_colmap.read_cameras_binary(sparse / "cameras.bin", 1)
    imgs = t_colmap.read_images_binary(sparse / "images.bin", str(root / "scene") + "/", 1)
    pts = t_colmap.read_points3d_binary(sparse / "points3D.bin")
    xyz = np.stack([p.xyz for p in pts.values()])
    rgb = np.stack([p.rgb for p in pts.values()])
    return t_trainer, t_trainer.Trainer(conf, t_init.initialize_gaussians(xyz, rgb, conf),
                                        imgs, cams, device="cpu")


def test_trainer_grows_caps_by_the_reference_rule(tmp_path, monkeypatch, two_threads):
    t_trainer, tr = _small_trainer(tmp_path)
    assert tr.pair_cap == 512 and tr.row_cap == 2048  # the config's, and its half
    grows, caps_seen = [], []
    real_grow, real_get = tr._grow_caps, t_trainer.get_monitored_train_step

    def grow(overflow, row_overflow):
        before = (tr.pair_cap, tr.row_cap)
        real_grow(overflow, row_overflow)
        grows.append((tr.iter, overflow, row_overflow, before, (tr.pair_cap, tr.row_cap)))

    def get_step(st):
        caps_seen.append((st.pair_cap, st.row_cap))
        return real_get(st)

    monkeypatch.setattr(tr, "_grow_caps", grow)
    monkeypatch.setattr(t_trainer, "get_monitored_train_step", get_step)
    tr.train(verbose=False)
    assert [g[0] for g in grows] == [0, 2, 4, 6]
    assert grows[0][1] > 512  # the first window overflowed its pair cap
    c = tr.config
    pair_cap, row_cap = 512, 2048
    for it, overflow, row_overflow, before, after in grows:
        assert before == (pair_cap, row_cap)
        shift = 2 if it < c.adaptive_control_end else 4
        if overflow > pair_cap:
            pair_cap = j_state.round_pair_cap(overflow + (overflow >> shift),
                                              minimum=tr.pair_cap_minimum)
        if row_overflow > row_cap:
            row_cap = j_state.round_row_cap(row_overflow + (row_overflow >> shift))
        assert after == (pair_cap, row_cap)
    assert pair_cap > 512
    # Each step bins at the caps of the boundary before it.
    assert caps_seen[0] == (512, 2048) and caps_seen[1] == grows[0][4]
    assert caps_seen[-1] == (tr.pair_cap, tr.row_cap)


def test_checkpoint_caps_cross_both_ways(tmp_path):
    params, alive, *_ = _scene(64, 40, 30, 32)
    ts = t_state.init_state(t_state.params_from_jax(params, alive, "cpu"))
    t_checkpoint.save_checkpoint(tmp_path / "port.npz", ts, 5, 1, cfg_hash="abc",
                                 pair_cap=1 << 20, row_cap=786_432)
    ck = j_checkpoint.load_checkpoint(tmp_path / "port.npz")
    assert (ck.pair_cap, ck.row_cap, ck.iteration, ck.l_max) == (1 << 20, 786_432, 5, 1)
    j_checkpoint.save_checkpoint(tmp_path / "jax.npz", ck.state, 7, 2, pair_cap=1_572_864,
                                 cfg_hash="abc", row_cap=524_288)
    back = t_checkpoint.load_checkpoint(tmp_path / "jax.npz", "cpu")
    assert (back.pair_cap, back.row_cap, back.iteration, back.l_max) == (
        1_572_864, 524_288, 7, 2)
    t_checkpoint.save_checkpoint(tmp_path / "none.npz", ts, 0, 0)
    assert j_checkpoint.load_checkpoint(tmp_path / "none.npz").pair_cap == 0


def test_trainer_checkpoint_keeps_caps(tmp_path, two_threads):
    _, tr = _small_trainer(tmp_path)
    tr.pair_cap, tr.row_cap = 1536, 4096
    tr.save_checkpoint(tmp_path / "ck.npz")
    _, fresh = _small_trainer(tmp_path / "again")
    fresh.load_checkpoint(tmp_path / "ck.npz")
    assert (fresh.pair_cap, fresh.row_cap) == (1536, 4096)
    t_checkpoint.save_checkpoint(tmp_path / "old.npz", tr.state, 0, 0, pair_cap=2048)
    fresh.load_checkpoint(tmp_path / "old.npz")  # no row cap: half the pair cap
    assert (fresh.pair_cap, fresh.row_cap) == (2048, 2048)
