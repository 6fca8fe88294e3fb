"""Port parity: multi-device training (``gsplat_tpu_torch/parallel``).

Ranks are processes joined over gloo on the CPU (``parallel.launch.spawn``:
a free localhost port, a process-group timeout of RANK_TIMEOUT_S and a
join timeout of JOIN_TIMEOUT_S, so a hang fails instead of stalling the
suite). The module imports JAX only inside the tests that use it: each
spawned rank imports this module to find its function.

- ``apply_adam``'s batch accumulators (``visible_count``, ``g_norm``)
  against JAX's ``apply_adam`` (plain jnp);
- binning's ``row_limit``: strips of 2 and 3 ranks at 48x40 enumerate
  the full frame's rows, pair sets and per-tile order; ``_span_y`` with a
  row limit against JAX's;
- ``rasterize(grad_scale_wh=)``: the u and v gradient rows scale by
  W / W_pad and H / H_pad, the other columns do not move (exact mode);
- dp on two identical cameras is bit-equal to one ``train_step``, its
  accumulators twice the step's;
- dp on 2 ranks against JAX's ``dp_train_step`` on 2 virtual devices, two
  distinct cameras at tests/test_train.py's 48x32 geometry. The JAX step's
  ``compute_loss_and_grads`` is replaced, in this test only, by the same
  function in exact mode (``bf16_colors=False``, ``bf16_grads=False``),
  and the port's ranks are bound to it (``train.step.exact_mode``), the
  mode the port is held to (tests/test_torch_train.py);
- with no flags, dp and tp run the rasterizers in the packed mode, the
  JAX package's default, as ``train_step`` does;
- tp on 2 and 3 ranks at 48x32 against one ``train_step``; at 48x40
  (R10) tp's uv gradient is the step's with its v column x 40/48; both in
  exact mode, where the strips' pairs round as the frame's (the packed
  mode rounds ``v - y_off`` before its tile offset, as the reference does);
- the dp trainer's per-rank (bucket, image) draws against the JAX
  Trainer's on a scene with two camera geometries;
- ``Trainer(dp=2)`` and ``Trainer(tp=2)`` through a density step and an
  opacity reset keep the replicas bit-identical, and only rank 0 writes;
- ``cli.main(..., "--dp"/"--tp", "2", device="cpu")`` writes trained.ply;
- ``initialize_multihost(backend="nccl")`` on the second of two hosts of 8
  cards (the device count, ``set_device`` and the process group stood in):
  rank 9 of 16 at local rank 1 joins on device 1; local rank 8 raises.
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gsplat_tpu_torch.train.step import exact_mode  # noqa: E402
from gsplat_tpu_torch import cli  # noqa: E402
from gsplat_tpu_torch import config as t_config  # noqa: E402
from gsplat_tpu_torch import parallel  # noqa: E402
from gsplat_tpu_torch.io import colmap as t_colmap  # noqa: E402
from gsplat_tpu_torch.io.ply import load_ply  # noqa: E402
from gsplat_tpu_torch.ops import binning  # noqa: E402
from gsplat_tpu_torch.ops.camera import build_camera_matrices  # noqa: E402
from gsplat_tpu_torch.ops.render import rasterize  # noqa: E402
from gsplat_tpu_torch.parallel.data_parallel import dp_train_step  # noqa: E402
from gsplat_tpu_torch.parallel import launch  # noqa: E402
from gsplat_tpu_torch.parallel.launch import spawn  # noqa: E402
from gsplat_tpu_torch.parallel.tile_parallel import (  # noqa: E402
    strip_rows, tp_loss_and_grads, tp_train_step)
from gsplat_tpu_torch.train import state as t_state  # noqa: E402
from gsplat_tpu_torch.train import step as t_step  # noqa: E402
from gsplat_tpu_torch.train import trainer as t_trainer  # noqa: E402

RANK_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 120
W, H, FOCAL, N, N_CAP = 48, 32, 40.0, 24, 64  # tests/test_train.py's geometry
BG = 0.25
NAMES = list(t_state.PARAM_DIMS)
STATICS = dict(
    tile=16, l_max=0, near_thresh=0.3, mh_dist=3.0, cull_padding=100, ssim_frac=0.2,
    base_lr=1e-3, xyz_lr_init=0.16, xyz_lr_final=0.0016, quat_lr=1.0, scale_lr=5.0,
    opacity_lr=25.0, rgb_lr=2.5, sh_lr=0.125, scene_extent=2.0, num_iters=200,
)  # tests/test_train.py::_statics


def _run(fn, world, *args):
    return spawn(fn, world, args, backend="gloo", timeout=RANK_TIMEOUT_S,
                 join_timeout=JOIN_TIMEOUT_S)


def _rank_setup():
    torch.set_num_threads(2)  # ranks share the suite's cores


def _camera(i, width=W, height=H):
    """Camera i: the identity pose (0) or a small rotation and shift."""
    q = [np.array([1.0, 0, 0, 0]), np.array([0.998, 0.03, -0.05, 0.01])][i]
    t = [np.zeros(3), np.array([0.1, -0.05, 0.2])][i]
    return build_camera_matrices(q / np.linalg.norm(q), t, width, height, FOCAL, FOCAL)


def _statics(width=W, height=H):
    cm = _camera(0, width, height)
    return t_step.StepStatics(width=width, height=height, focal_x=cm.focal_x,
                              focal_y=cm.focal_y, tan_fovx=cm.tan_fovx,
                              tan_fovy=cm.tan_fovy, **STATICS)


def _scene(seed=0, n=N, n_cap=N_CAP):
    """tests/test_train.py::_synthetic_gaussians in ``n_cap`` rows, as host
    arrays (params dict, alive)."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)) * [1.2, 0.8, 0.3] + [0, 0, 4.0]
    cols = dict(
        xyz=xyz, rgb=rng.normal(size=(n, 3)), opacity=rng.uniform(0.5, 2.0, size=n),
        scale=np.log(rng.uniform(0.05, 0.25, size=(n, 3))),
        quat=np.concatenate([np.ones((n, 1)), 0.2 * rng.normal(size=(n, 3))], axis=1),
        sh=np.zeros((n, 15, 3)),
    )
    params = {k: np.concatenate([v, np.zeros((n_cap - n,) + v.shape[1:])]).astype(np.float32)
              for k, v in cols.items()}
    return params, np.arange(n_cap) < n


def _gts(k=2, width=W, height=H):
    rng = np.random.default_rng(42)
    return [rng.uniform(0, 1, (height, width, 3)).astype(np.float32) for _ in range(k)]


def _state(params, alive):
    return t_state.init_state(t_state.params_from_jax(params, alive, "cpu"))


def _same_state(a, b, msg=""):
    for f in ("alive", "uv_grad_accum", "accum_dur"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{msg} {f}")
    for f in ("params", "adam_m", "adam_v"):
        for name in NAMES:
            np.testing.assert_array_equal(a[f][name], b[f][name], err_msg=f"{msg} {f}.{name}")


# ------------------------------------------------------------ apply_adam


@pytest.mark.parametrize("l_max", [0, 3])
def test_apply_adam_batch_accumulators_match_jax(l_max):
    import jax.numpy as jnp

    from gsplat_tpu.train import state as j_state
    from gsplat_tpu.train import step as j_step

    rng = np.random.default_rng(3 + l_max)
    n = 64
    pick = {name: {k: rng.normal(size=t_state._param_shape(name, n)).astype(np.float32)
                   for k in "pgm"} for name in NAMES}
    for name in NAMES:
        pick[name]["v"] = np.abs(pick[name]["m"])
        pick[name]["g"][rng.uniform(size=pick[name]["g"].shape) < 0.1] = np.nan
    visible_count = rng.integers(0, 3, n).astype(np.int32)
    mask = visible_count > 0
    g_uv = rng.normal(size=(n, 2)).astype(np.float32)
    g_norm = rng.uniform(0, 2, n).astype(np.float32)
    acc = rng.uniform(0, 3, n).astype(np.float32)
    dur = rng.integers(0, 9, n).astype(np.int32)
    group = lambda k: {name: pick[name][k] for name in NAMES}  # noqa: E731
    st = dataclasses.replace(_statics(), l_max=l_max)
    j_st = j_step.StepStatics(chunk=128, **dict(dataclasses.asdict(st), pair_cap=2048))
    to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    ref = j_step.apply_adam(
        j_state.TrainState(to_j(group("p")), to_j(group("m")), to_j(group("v")),
                           jnp.ones(n, bool), jnp.asarray(acc), jnp.asarray(dur)),
        to_j(group("g")), jnp.asarray(g_uv), jnp.asarray(mask), jnp.int32(7), j_st,
        visible_count=jnp.asarray(visible_count), g_norm=jnp.asarray(g_norm))
    state = t_state.state_from_jax(group("p"), group("m"), group("v"), np.ones(n, bool),
                                   acc, dur, "cpu")
    t_step.apply_adam(state, {k: torch.from_numpy(v) for k, v in group("g").items()},
                      torch.from_numpy(g_uv), torch.from_numpy(mask), 7, st,
                      visible_count=torch.from_numpy(visible_count),
                      g_norm=torch.from_numpy(g_norm))
    got = t_state.state_to_numpy(state)
    for f in ("params", "adam_m", "adam_v"):
        for name in NAMES:
            np.testing.assert_allclose(got[f][name], np.asarray(getattr(ref, f)[name]),
                                       rtol=2e-6, atol=1e-7, err_msg=f"{f}.{name}")
    np.testing.assert_allclose(got["uv_grad_accum"], np.asarray(ref.uv_grad_accum), rtol=1e-6)
    np.testing.assert_array_equal(got["accum_dur"], np.asarray(ref.accum_dur))
    np.testing.assert_array_equal(got["accum_dur"], dur + visible_count)
    # The defaults are one camera's: mask and |g_uv|, bit for bit.
    a = t_state.state_from_jax(group("p"), group("m"), group("v"), np.ones(n, bool),
                               acc, dur, "cpu")
    b = t_state.state_from_jax(group("p"), group("m"), group("v"), np.ones(n, bool),
                               acc, dur, "cpu")
    args = ({k: torch.from_numpy(v) for k, v in group("g").items()},
            torch.from_numpy(g_uv), torch.from_numpy(mask), 7, st)
    t_step.apply_adam(a, *args)
    t_step.apply_adam(b, *args, visible_count=torch.from_numpy(mask.astype(np.int32)),
                      g_norm=torch.sqrt(torch.sum(torch.from_numpy(g_uv) ** 2, dim=1)))
    _same_state(t_state.state_to_numpy(a), t_state.state_to_numpy(b))


# ------------------------------------------------------------ row_limit


def _tile_lists(t):
    gid, start, count = (x.numpy() for x in (t.splat_gid, t.tile_start, t.tile_count))
    return [gid[s:s + c].tolist() for s, c in zip(start, count)]


@pytest.mark.parametrize("n_ranks", [2, 3])
def test_row_limit_strips_match_full_frame(n_ranks):
    from test_render import _make_scene

    width, height, tile = 48, 40, 16  # 3 tile rows: the last strip is padded
    uv, _, radius, z, _, _ = _make_scene(np.random.default_rng(8), 60, width, height)
    ntx, nty = 3, 3
    uv, z, radius = (torch.from_numpy(x) for x in (uv, z, radius))
    mask = torch.ones(uv.shape[0], dtype=torch.bool)
    full = binning.build_tile_tables(uv, z, radius, mask, num_tiles_x=ntx, num_tiles_y=nty,
                                     tile_size=tile)
    full_lists = _tile_lists(full)
    rows = (nty + n_ranks - 1) // n_ranks
    pairs = 0
    for d in range(n_ranks):
        limit = min(max(nty - d * rows, 0), rows)
        uv_l = uv - torch.tensor([0.0, float(d * rows * tile)])
        strip = binning.build_tile_tables(uv_l, z, radius, mask, num_tiles_x=ntx,
                                          num_tiles_y=rows, tile_size=tile, row_limit=limit)
        lists = _tile_lists(strip)
        assert lists[:limit * ntx] == full_lists[d * rows * ntx:(d * rows + limit) * ntx], d
        assert not any(lists[limit * ntx:]), d  # padding rows: no pairs
        pairs += strip.num_pairs
        # without the limit the padding rows would take pairs
        if limit < rows:
            free = binning.build_tile_tables(uv_l, z, radius, mask, num_tiles_x=ntx,
                                             num_tiles_y=rows, tile_size=tile)
            assert free.num_pairs > strip.num_pairs
    assert pairs == full.num_pairs > 0


def test_span_y_row_limit_matches_jax():
    import jax.numpy as jnp

    from gsplat_tpu.ops import binning as j_binning

    rng = np.random.default_rng(5)
    n = 400
    v = rng.uniform(-40, 90, n).astype(np.float32)
    a1y, a2y = (rng.normal(0, 12, n).astype(np.float32) for _ in range(2))
    s_e = rng.uniform(1.0, 2.0, n).astype(np.float32)
    for limit in (0, 1, 2, 3):
        got = binning._span_y(*(torch.from_numpy(x) for x in (v, a1y, a2y, s_e)), 16, limit)
        ref = j_binning._span_y(*(jnp.asarray(x) for x in (v, a1y, a2y, s_e)), 16, limit)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert int(got[1].max()) <= limit


# ------------------------------------------------------------ grad_scale_wh


def test_grad_scale_wh_scales_only_uv_rows():
    from test_render import _make_scene

    width, height, tile = 40, 24, 16  # pads to 48 x 32
    uv, conic, radius, z, opa, rgb = (torch.from_numpy(x) for x in _make_scene(
        np.random.default_rng(11), 50, width, height))
    tables = binning.build_tile_tables(uv, z, radius, torch.ones(50, dtype=torch.bool),
                                       num_tiles_x=3, num_tiles_y=2, tile_size=tile,
                                       bf16_colors=False)
    cot = torch.from_numpy(np.random.default_rng(12).normal(
        size=(height, width, 3)).astype(np.float32))
    out = []
    for wh in (None, (width, height)):
        leaves = [x.clone().requires_grad_(True) for x in (uv, conic, rgb, opa)]
        img = rasterize(*leaves, tables, BG, width=width, height=height, tile=tile,
                        grad_scale_wh=wh, bf16_grads=False).image
        out.append(torch.autograd.grad(img, leaves, grad_outputs=cot))
    (d_uv, *rest), (s_uv, *s_rest) = out
    assert tables.num_pairs > 100 and d_uv.abs().max() > 0
    for a, b in zip(rest, s_rest):
        assert torch.equal(a, b)
    for col, ratio in ((0, width / 48), (1, height / 32)):
        np.testing.assert_allclose(s_uv[:, col].numpy(), d_uv[:, col].numpy() * ratio,
                                   rtol=1e-6, atol=1e-7 * float(d_uv.abs().max()))


# ------------------------------------------------------------ dp / tp steps


def _rank_dp_identical(rank, params, alive, gt):
    _rank_setup()
    st, cm = _statics(), _camera(0)
    single, dp = _state(params, alive), _state(params, alive)
    gt = torch.from_numpy(gt)
    _, m1 = t_step.train_step(single, cm.view, cm.proj, cm.campos, gt, BG, 3, st)
    _, m2 = dp_train_step(dp, cm.view, cm.proj, cm.campos, gt, BG, 3, st)
    return (t_state.state_to_numpy(single), t_state.state_to_numpy(dp),
            (float(m1.loss), float(m2.loss)), (m1.num_pairs, m2.num_pairs))


def test_dp_identical_cameras_bit_equal_to_single_step():
    params, alive = _scene()
    outs = _run(_rank_dp_identical, 2, params, alive, _gts(1)[0])
    for single, dp, (l1, l2), (p1, p2) in outs:
        assert l1 == l2 and p1 == p2 > 0
        for f in ("params", "adam_m", "adam_v"):
            for name in NAMES:
                np.testing.assert_array_equal(dp[f][name], single[f][name], err_msg=name)
        assert single["accum_dur"].max() == 1
        np.testing.assert_array_equal(dp["accum_dur"], 2 * single["accum_dur"])
        np.testing.assert_array_equal(dp["uv_grad_accum"], 2 * single["uv_grad_accum"])
    _same_state(outs[0][1], outs[1][1], "replicas")


def _moments_match(got, ref):
    """Adam's moments against JAX's, rtol 1e-4 and an atol of 1e-5 of each
    moment's largest value. After one step the parameters hardly depend on
    the gradients' scale; the moments (0.1 g, 0.001 g^2) do, so a factor
    in the reduced gradients shows here."""
    for f in ("adam_m", "adam_v"):
        top = max(float(np.abs(ref[f][name]).max()) for name in NAMES)
        assert top > 0, f
        for name in NAMES:
            np.testing.assert_allclose(got[f][name], ref[f][name], rtol=1e-4, atol=1e-5 * top,
                                       err_msg=f"{f}.{name}")


def _jax_exact_loss_and_grads(params, alive, view, proj, campos, gt_image, bg, st):
    """``gsplat_tpu.train.step.compute_loss_and_grads`` in exact mode."""
    import jax

    from gsplat_tpu.ops.binning import build_tile_tables
    from gsplat_tpu.ops.loss import fused_loss
    from gsplat_tpu.ops.render import pack_attrs, rasterize as j_rasterize
    from gsplat_tpu.train.step import _per_gaussian

    def loss_fn(p, uv_probe):
        uv, conic, rgb, mask, radius, z = _per_gaussian(p, alive, view, proj, campos, st)
        uv = uv + uv_probe
        sg = jax.lax.stop_gradient
        tables = build_tile_tables(
            sg(uv), sg(z), radius, mask, attrs=sg(pack_attrs(uv, conic, rgb, p["opacity"])),
            num_tiles_x=st.num_tiles_x, num_tiles_y=st.num_tiles_y, tile_size=st.tile,
            pair_cap=st.pair_cap, chunk_size=st.chunk, bf16_colors=False,
            interpret=st.interpret)
        out = j_rasterize(uv, conic, rgb, p["opacity"], tables, bg, width=st.width,
                          height=st.height, tile=st.tile, chunk=st.chunk,
                          interpret=st.interpret, bf16_grads=False)
        return fused_loss(out.image, gt_image, st.ssim_frac), (out.image, mask, tables)

    probe = jax.numpy.zeros((alive.shape[0], 2), jax.numpy.float32)
    (loss, (image, mask, tables)), (grads, g_uv) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(params, probe)
    return loss, image, mask, tables, grads, g_uv


def _rank_dp_two_cameras(rank, params, alive, gts):
    _rank_setup()
    st, cm = _statics(), _camera(rank)
    state = _state(params, alive)
    with exact_mode():
        _, m = dp_train_step(state, cm.view, cm.proj, cm.campos,
                             torch.from_numpy(gts[rank]), BG, 3, st)
    return t_state.state_to_numpy(state), float(m.loss)


def test_dp_matches_jax_dp_train_step(monkeypatch):
    import jax
    import jax.numpy as jnp

    from gsplat_tpu.parallel import data_parallel as j_dp
    from gsplat_tpu.train import state as j_state
    from gsplat_tpu.train import step as j_step

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    params, alive = _scene()
    gts = _gts(2)
    outs = _run(_rank_dp_two_cameras, 2, params, alive, gts)
    monkeypatch.setattr(j_dp, "compute_loss_and_grads", _jax_exact_loss_and_grads)
    st = _statics()
    j_st = j_step.StepStatics(chunk=128, **dict(dataclasses.asdict(st), pair_cap=2048))
    zeros = {k: jnp.zeros_like(jnp.asarray(v)) for k, v in params.items()}
    state = j_state.TrainState({k: jnp.asarray(v) for k, v in params.items()}, zeros, zeros,
                               jnp.asarray(alive), jnp.zeros(N_CAP, jnp.float32),
                               jnp.zeros(N_CAP, jnp.int32))
    cams = [_camera(i) for i in range(2)]
    stack = lambda f: jnp.asarray(np.stack([getattr(c, f) for c in cams]))  # noqa: E731
    ref, m = j_dp.dp_train_step(
        state, stack("view"), stack("proj"), stack("campos"), jnp.asarray(np.stack(gts)),
        jnp.full((2,), BG, jnp.float32), jnp.int32(3), j_st,
        j_dp.make_mesh(jax.devices()[:2]))
    ref = {f: jax.tree.map(np.asarray, getattr(ref, f)) for f in ref._fields}
    (s0, l0), (s1, l1) = outs
    _same_state(s0, s1, "replicas")
    assert l0 == l1 == pytest.approx(float(m["loss"]), rel=1e-5)
    for name in NAMES:
        np.testing.assert_allclose(s0["params"][name], ref["params"][name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    _moments_match(s0, ref)
    np.testing.assert_array_equal(s0["accum_dur"], ref["accum_dur"])
    assert s0["accum_dur"].max() == 2  # a Gaussian both cameras see
    np.testing.assert_allclose(s0["uv_grad_accum"], ref["uv_grad_accum"], rtol=1e-3)


def _rank_default_modes(rank, params, alive, gt):
    """The (kernel, packed, pack_grads) of each rasterizer call that one dp
    and one tp step make with no flags."""
    from gsplat_tpu_torch.ops import render as t_render

    _rank_setup()
    st, cm = _statics(), _camera(0)
    calls, real = [], (t_render.rasterize_forward, t_render.rasterize_backward)

    def spy(fn):
        def run(*a, **k):
            calls.append((fn.__name__, k.get("packed"), k.get("pack_grads")))
            return fn(*a, **k)
        return run

    t_render.rasterize_forward, t_render.rasterize_backward = map(spy, real)
    try:
        out = {}
        for name, step in (("dp", dp_train_step), ("tp", tp_train_step)):
            calls.clear()
            step(_state(params, alive), cm.view, cm.proj, cm.campos, torch.from_numpy(gt), BG,
                 0, st)
            out[name] = list(calls)
    finally:
        t_render.rasterize_forward, t_render.rasterize_backward = real
    return out


def test_dp_and_tp_steps_default_to_packed():
    params, alive = _scene()
    outs = _run(_rank_default_modes, 2, params, alive, _gts(1)[0])
    for o in outs:
        for name in ("dp", "tp"):
            assert o[name] == [("rasterize_forward", True, None),
                               ("rasterize_backward", True, True)], (name, o[name])


def _rank_tp(rank, params, alive, gt, height):
    _rank_setup()
    st, cm = _statics(height=height), _camera(0, height=height)
    gt = torch.from_numpy(gt)
    single, tp = _state(params, alive), _state(params, alive)
    with exact_mode():
        grads = [t_step.compute_loss_and_grads(single.params, cm.view, cm.proj, cm.campos,
                                               gt, BG, st),
                 tp_loss_and_grads(tp.params, cm.view, cm.proj, cm.campos, gt, BG, st)]
        (_, image, _, _, _, g_uv), r = grads
        _, m1 = t_step.train_step(single, cm.view, cm.proj, cm.campos, gt, BG, 0, st)
        _, m2 = tp_train_step(tp, cm.view, cm.proj, cm.campos, gt, BG, 0, st)
    return dict(single=t_state.state_to_numpy(single), tp=t_state.state_to_numpy(tp),
                loss=(float(m1.loss), float(m2.loss), float(r.loss)),
                pairs=(m1.num_pairs, m2.num_pairs), g_uv=(g_uv.numpy(), r.g_uv.numpy()),
                image=float((r.image - image).abs().max()))


@pytest.mark.parametrize("n_ranks", [2, 3])
def test_tp_matches_single_step(n_ranks):
    params, alive = _scene()
    outs = _run(_rank_tp, n_ranks, params, alive, _gts(1)[0], H)
    assert strip_rows(_statics(), n_ranks) == (2 + n_ranks - 1) // n_ranks
    for o in outs:
        l_single, l_tp, _ = o["loss"]
        assert abs(l_tp - l_single) <= 1e-6
        assert o["pairs"][0] == o["pairs"][1] > 0
        for name in NAMES:
            np.testing.assert_allclose(o["tp"]["params"][name], o["single"]["params"][name],
                                       rtol=0, atol=2e-5, err_msg=name)
        np.testing.assert_array_equal(o["tp"]["accum_dur"], o["single"]["accum_dur"])
    for o in outs[1:]:
        _same_state(outs[0]["tp"], o["tp"], "replicas")


def test_tp_r10_scales_v_gradient_by_unpadded_height():
    """R10: at 48x40 the single step scales uv gradients by the padded
    grid's 0.5 x 48 rows, the tile-sharded step by the image's 0.5 x 40."""
    params, alive = _scene()
    height = 40
    outs = _run(_rank_tp, 2, params, alive, _gts(1, height=height)[0], height)
    for o in outs:
        l_single, _, l_tp = o["loss"]
        assert abs(l_tp - l_single) <= 1e-6
        assert o["image"] == 0.0
        single, tp = o["g_uv"]
        scale = float(np.nanmax(np.abs(single)))
        assert scale > 0
        np.testing.assert_allclose(tp[:, 0], single[:, 0], rtol=1e-5, atol=1e-6 * scale)
        np.testing.assert_allclose(tp[:, 1], single[:, 1] * (height / 48), rtol=1e-5,
                                   atol=1e-6 * scale)
        # ... and the v column is not the single step's
        assert not np.allclose(tp[:, 1], single[:, 1], rtol=1e-3, atol=1e-6 * scale)


# ------------------------------------------------------------ trainer, CLI

SCHEDULE = dict(
    dataset_path="scene", downsample_factor=1, num_iters=10, print_interval=4,
    test_eval_interval=10**9, test_split_ratio=4, adaptive_control_start=2,
    adaptive_control_interval=5, adaptive_control_end=8, reset_opacity_start=3,
    reset_opacity_interval=7, reset_opacity_end=9, max_sh_band=2, add_sh_band_interval=3,
    max_gaussians=5000, use_background="false", strict_reference="false",
    uv_grad_threshold=1e-5,
)  # tests/test_torch_trainer.py's, with an opacity reset at 7 and dumps at 0, 4, 8
DATASET = dict(name="scene", n_views=3, width=48, height=32, n_gaussians=60,
               n_points=80)  # tests/test_cli.py's


def _write_config(path: Path, **over) -> Path:
    over = {**SCHEDULE, **over}
    base = Path(__file__).resolve().parents[1] / "configs" / "base.yaml"
    lines = [line for line in base.read_text().splitlines() if line.split(":")[0] not in over]
    path.write_text("\n".join(lines + [f"{k}: {v}" for k, v in over.items()]) + "\n")
    return path


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from gsplat_tpu_torch.tools.synthetic import write_synthetic_dataset

    root = tmp_path_factory.mktemp("parallel_dataset")
    write_synthetic_dataset(root, **DATASET, device="cpu")
    return root


def _read(root, two_geometries=False):
    sparse = root / "scene" / "sparse" / "0"
    cams = t_colmap.read_cameras_binary(sparse / "cameras.bin", 1)
    imgs = t_colmap.read_images_binary(sparse / "images.bin", str(root / "scene") + "/", 1)
    if two_geometries:  # tests/test_multichip.py's second camera: focal x 1.1
        cams, imgs = _second_geometry(cams, imgs)
    pts = t_colmap.read_points3d_binary(sparse / "points3D.bin")
    return (cams, imgs, np.stack([p.xyz for p in pts.values()]),
            np.stack([p.rgb for p in pts.values()]))


def _second_geometry(cams, imgs):
    (cid,) = cams
    cam = cams[cid]
    cams = {**cams, cid + 1: dataclasses.replace(
        cam, id=cid + 1, params=cam.params * np.array([1.1, 1.1, 1.0, 1.0][:len(cam.params)]))}
    imgs = {k: dataclasses.replace(im, camera_id=cid + 1) if i % 2 else im
            for i, (k, im) in enumerate(sorted(imgs.items(), key=lambda kv: str(kv[0])))}
    return cams, imgs


def _rank_trainer(rank, cfg_path, root, mode, out_base, num_iters=None, record=False):
    from gsplat_tpu_torch.train.init import initialize_gaussians

    _rank_setup()
    conf = t_config.parse_config(cfg_path)
    conf = dataclasses.replace(conf, output_dir=str(Path(out_base) / f"rank{rank}"))
    cams, imgs, xyz, rgb = _read(Path(root), two_geometries=record)
    tr = t_trainer.Trainer(conf, initialize_gaussians(xyz, rgb, conf), imgs, cams,
                           device="cpu", **{mode: 2})
    events = {"density": [], "reset": [], "draws": []}
    real_density, real_reset = tr._density_step, t_trainer.reset_opacity

    def density():
        events["density"].append((tr.iter, real_density().applied))

    def reset(state, value):
        events["reset"].append(tr.iter)
        return real_reset(state, value)

    def draw(img, gt, monitor):  # record the image drawn, skip the step
        events["draws"].append((Path(img.name).name, gt.numpy().copy()))
        zero = torch.zeros(())
        return tr.state, t_step.StepMetrics(zero, zero, zero, 0), monitor

    tr._density_step, t_trainer.reset_opacity = density, reset
    if record:
        tr._step = draw
    tr.train(max_iters=num_iters, verbose=False)
    tr.save_to_ply(Path(conf.output_dir) / "trained.ply")
    tr.save_checkpoint(Path(conf.output_dir) / "checkpoint.npz")
    return dict(state=t_state.state_to_numpy(tr.state), iter=tr.iter, l_max=tr.l_max,
                events=events, buckets=tr._dp_buckets() if record else None)


@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_trainer_replicas_stay_bit_identical(dataset, tmp_path, mode):
    cfg = _write_config(tmp_path / "c.yaml")
    outs = _run(_rank_trainer, 2, cfg, dataset, mode, tmp_path / "out")
    a, b = outs
    assert a["iter"] == b["iter"] == 10 and a["l_max"] == b["l_max"] == 2
    assert a["events"] == b["events"]
    assert a["events"]["density"] == [(5, True)] and a["events"]["reset"] == [7]
    assert int(a["state"]["alive"].sum()) != DATASET["n_points"]  # the density step
    _same_state(a["state"], b["state"], "replicas")
    out0, out1 = tmp_path / "out" / "rank0", tmp_path / "out" / "rank1"
    assert sorted(p.name for p in out0.iterdir()) == [
        "checkpoint.npz", "rendered_image_0.png", "rendered_image_4.png",
        "rendered_image_8.png", "trained.ply"]
    assert not out1.exists() or not any(out1.iterdir())
    assert load_ply(out0 / "trained.ply")["xyz"].shape[0] == int(a["state"]["alive"].sum())


def test_dp_draws_match_jax_trainer(dataset, tmp_path, monkeypatch):
    """Per rank, the (bucket, image) sequence of ``Trainer(dp=2)`` equals
    the images the JAX Trainer gives device r, on two camera geometries
    (``_dp_bucket_choice``, a loader per bucket with seed ``seed +
    1_000_003 * bucket`` and start ``consumed * dp``)."""
    import jax
    import jax.numpy as jnp

    from gsplat_tpu import config as j_config
    from gsplat_tpu.io import colmap as j_colmap
    from gsplat_tpu.parallel import data_parallel as j_dp
    from gsplat_tpu.train import init as j_init
    from gsplat_tpu.train import trainer as j_trainer
    from gsplat_tpu.train.step import fresh_monitor

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    iters = 12
    cfg = _write_config(tmp_path / "c.yaml", adaptive_control_start=10**9,
                        reset_opacity_start=10**9, num_iters=iters, seed=5)
    outs = _run(_rank_trainer, 2, cfg, dataset, "dp", tmp_path / "out", iters, True)
    # The JAX Trainer's own loop, its step replaced by a recorder.
    sparse = dataset / "scene" / "sparse" / "0"
    conf = j_config.parse_config(cfg)
    cams = j_colmap.read_cameras_binary(sparse / "cameras.bin", 1)
    imgs = j_colmap.read_images_binary(sparse / "images.bin", str(dataset / "scene") + "/", 1)
    cams, imgs = _second_geometry(cams, imgs)
    _, _, xyz, rgb = _read(dataset)
    ref = j_trainer.Trainer(conf, j_init.initialize_gaussians(xyz, rgb, conf), imgs, cams,
                            dp=2)
    seen = []

    def get_step(st, devices):
        def step(state, views, projs, campos, gts, bgs, iteration, monitor):
            seen.append((np.asarray(views), np.asarray(gts)))
            return state, {"loss": jnp.float32(0.0)}, fresh_monitor()
        return step

    monkeypatch.setattr(j_dp, "get_monitored_dp_train_step", get_step)
    monkeypatch.setattr(ref, "_dump_image", lambda *a: None)
    monkeypatch.setattr(ref, "evaluate", lambda **k: None)
    ref.train(verbose=False)
    assert len(seen) == iters
    buckets = outs[0]["buckets"]
    assert len(buckets) == 2
    names = {im.id: Path(im.name).name for im in ref.train_images}
    view_of = {names[im.id]: ref._matrices(im).view for im in ref.train_images}
    for k, (views, gts) in enumerate(seen):
        bucket = ref._dp_bucket_choice(k, buckets)
        for r in range(2):
            name, img = outs[r]["events"]["draws"][k]
            np.testing.assert_array_equal(views[r], view_of[name], err_msg=f"{k} {r}")
            np.testing.assert_array_equal(gts[r], img, err_msg=f"{k} {r}")
            pos = next(p for p, im in enumerate(ref.train_images) if names[im.id] == name)
            assert pos in buckets[bucket]
    assert len({d[0] for o in outs for d in o["events"]["draws"]}) > 1


@pytest.mark.parametrize("flag", ["--dp", "--tp"])
def test_cli_parallel_writes_ply(dataset, tmp_path, flag, monkeypatch):
    out = tmp_path / "out"
    cfg = _write_config(tmp_path / "c.yaml", output_dir=str(out), num_iters=6)
    monkeypatch.setattr(launch, "spawn", functools.partial(
        spawn, timeout=RANK_TIMEOUT_S, join_timeout=JOIN_TIMEOUT_S))
    assert cli.main([str(cfg), str(dataset), flag, "2"], device="cpu") == 0
    data = load_ply(out / "trained.ply")
    with np.load(out / "checkpoint.npz") as ck:
        assert int(ck["_iter"]) == 6
        assert data["xyz"].shape[0] == int(ck["alive"].sum()) > 0


def test_process_group_checks():
    parallel.initialize_multihost()  # one process, no coordinator: no-op
    with pytest.raises(ValueError, match="backend"):
        parallel.initialize_multihost("127.0.0.1:1", 2, 0, backend="mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="exceed the available devices"):
            parallel.initialize_multihost("127.0.0.1:1", 2, 0, backend="nccl")
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["cfg.yaml", "root", "--dp", "2"])
    with pytest.raises(ValueError, match="process group has 1"):
        parallel.require_world(2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        t_trainer.Trainer(None, None, {}, {}, device="cpu", dp=2, tp=2)


def test_nccl_rank_on_second_host(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("device", d)))
    monkeypatch.setattr(parallel.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    parallel.initialize_multihost("10.0.0.1:29500", 16, 9, backend="nccl", local_rank=1)
    assert calls[0] == ("device", 1)
    backend, kw = calls[1]
    assert (backend, kw["init_method"], kw["world_size"], kw["rank"]) == (
        "nccl", "tcp://10.0.0.1:29500", 16, 9)
    calls.clear()
    with pytest.raises(RuntimeError, match="exceed the available devices"):
        parallel.initialize_multihost("10.0.0.1:29500", 16, 9, backend="nccl",
                                      local_rank=8)
    with pytest.raises(RuntimeError, match="exceed the available devices"):
        parallel.initialize_multihost("10.0.0.1:29500", 16, 9, backend="nccl")
    assert calls == []
    parallel.initialize_multihost("10.0.0.1:29500", 8, 3, backend="nccl")
    assert calls[0] == ("device", 3) and calls[1][1]["rank"] == 3
