"""Port parity: density control, the Morton re-sort and the state helpers.

The same state goes through the JAX density functions (jitted XLA; they
reach no Pallas kernel) and the port's, carried across with
``state_from_jax``; the port's split noise is JAX's own draws
(``jax.random.split(key)`` then ``jax.random.normal(k, (n_cap, 3))``).

Tolerances: ``alive``, the row layout, every parameter of every row that
is not a split child, the split children's other parameters, the moments,
the accumulators and ``DensityInfo`` must be exact. Split children's xyz
and scale pass through rsqrt, exp and log, where XLA and torch may differ
in the last bits (ROADMAP R8): within ``CHILD_ULPS`` units in the last
place of the largest |value| of their column.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gsplat_tpu.ops import morton as j_morton  # noqa: E402
from gsplat_tpu.train import density as j_density  # noqa: E402
from gsplat_tpu.train import init as j_init  # noqa: E402
from gsplat_tpu.train import state as j_state  # noqa: E402
from gsplat_tpu_torch.ops import morton as t_morton  # noqa: E402
from gsplat_tpu_torch.train import density as t_density  # noqa: E402
from gsplat_tpu_torch.train import init as t_init  # noqa: E402
from gsplat_tpu_torch.train import state as t_state  # noqa: E402

NAMES = list(t_state.PARAM_DIMS)
CHILD_ULPS = 4


def _gaussians(rng, n, module=j_init):
    """A random scene in front of the origin camera."""
    xyz = rng.normal(size=(n, 3)) * [1.2, 0.8, 0.3] + [0, 0, 4.0]
    return module.GaussianData(
        xyz=xyz.astype(np.float32),
        rgb=rng.normal(size=(n, 3)).astype(np.float32),
        opacity=rng.uniform(0.5, 2.0, size=n).astype(np.float32),
        scale=np.log(rng.uniform(0.05, 0.25, size=(n, 3))).astype(np.float32),
        quaternion=np.concatenate([np.ones((n, 1)), 0.2 * rng.normal(size=(n, 3))],
                                  axis=1).astype(np.float32),
    )


def _host(js):
    return {f: jax.tree.map(np.asarray, getattr(js, f)) for f in js._fields}


def _to_port(js):
    return t_state.state_from_jax(**_host(js), device="cpu")


def _statics(**kw):
    args = dict(scene_extent=2.0, uv_grad_threshold=0.1, delete_opacity_threshold=0.02,
                split_scale_factor=1.6, max_gaussians=1000)
    args.update(kw)
    return j_density.DensityStatics(**args), t_density.DensityStatics(**args)


def _jax_noise(seed, n_cap):
    k1, k2 = jax.random.split(jax.random.key(seed))
    return tuple(torch.from_numpy(np.array(jax.random.normal(k, (n_cap, 3))))
                 for k in (k1, k2))


def _run_both(js, seed, **kw):
    """The JAX step and the port's on the same state and draws:
    (JAX state, JAX info, port state, port info)."""
    j_ds, t_ds = _statics(**kw)
    j_step, _ = j_density.get_density_fns(j_ds)
    j_new, j_info = j_step(js, jax.random.key(seed))
    t_new, t_info = t_density.adaptive_density_step(_to_port(js), t_ds,
                                                     *_jax_noise(seed, js.capacity))
    return j_new, j_info, t_new, t_info


def _assert_info_equal(t_info, j_info):
    assert t_info._asdict() == {k: type(getattr(t_info, k))(np.asarray(v))
                                for k, v in j_info._asdict().items()}


def _assert_states_equal(t_new, j_new, children=slice(0, 0)):
    """Exact, except split children's xyz and scale (``children`` rows)."""
    got, ref = t_state.state_to_numpy(t_new), _host(j_new)
    for field in ("alive", "uv_grad_accum", "accum_dur"):
        np.testing.assert_array_equal(got[field], ref[field], err_msg=field)
    for field in ("params", "adam_m", "adam_v"):
        for name in NAMES:
            a, b = got[field][name], ref[field][name]
            if field == "params" and name in ("xyz", "scale"):
                a, b = a.copy(), b.copy()
                ca, cb = a[children], b[children]
                tol = CHILD_ULPS * np.spacing(np.abs(cb).max(axis=0, initial=0.0))
                assert (np.abs(ca - cb) <= tol).all(), (f"split children {name}", ca, cb)
                a[children] = b[children]
            np.testing.assert_array_equal(a, b, err_msg=f"{field}.{name}")


def _children(info):
    return slice(int(info.new_total) - 2 * int(info.num_split), int(info.new_total))


# ------------------------------------------------------------- the step


def _marked_state(rng):
    """16 Gaussians in 64 rows: 0 prunes (low opacity), 1 clones (small
    scale, high gradient), 2 splits (large scale, high gradient); the
    cases of tests/test_train.py."""
    n = 16
    js = j_state.init_state(_gaussians(rng, n), n_cap=64)
    op = np.array(js.params["opacity"])
    op[0] = -6.0
    sc = np.array(js.params["scale"])
    sc[:] = np.log(0.05)
    sc[1] = np.log(0.005)
    sc[2] = np.log(0.3)
    accum = np.zeros(64, np.float32)
    accum[1] = accum[2] = 5.0
    dur = np.zeros(64, np.int32)
    dur[:n] = 10
    adam = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
            for k, v in js.adam_m.items()}
    return js._replace(params={**js.params, "opacity": jnp.asarray(op),
                               "scale": jnp.asarray(sc)},
                       adam_m=adam, adam_v=jax.tree.map(jnp.abs, adam),
                       uv_grad_accum=jnp.asarray(accum), accum_dur=jnp.asarray(dur))


def test_clone_split_prune_matches_jax():
    js = _marked_state(np.random.default_rng(0))
    j_new, j_info, t_new, t_info = _run_both(js, 0)
    _assert_info_equal(t_info, j_info)
    assert t_info == (17, 1, 1, 1, True, False)
    _assert_states_equal(t_new, j_new, _children(t_info))
    # moments move with kept rows only; the accumulators reset
    assert not t_new.adam_m["xyz"][14:].any() and not t_new.uv_grad_accum.any()


def test_capacity_skip_matches_jax():
    rng = np.random.default_rng(1)
    js = j_state.init_state(_gaussians(rng, 8), n_cap=16)
    js = js._replace(uv_grad_accum=jnp.ones(16) * 10.0, accum_dur=jnp.ones(16, jnp.int32))
    before = _to_port(js)
    j_new, j_info, t_new, t_info = _run_both(js, 1, max_gaussians=9)
    _assert_info_equal(t_info, j_info)
    assert not t_info.applied and t_info.new_total == 8
    _assert_states_equal(t_new, j_new)
    np.testing.assert_array_equal(t_new.params.xyz.detach().numpy(),
                                  before.params.xyz.detach().numpy())


def _random_state(seed, n_cap=64):
    """Mixed thresholds: opacities around the prune logit, scales around
    the clone, split and prune scales, gradients around the threshold,
    dead rows among the alive ones in the first 5/8 of the rows, random
    moments."""
    rng = np.random.default_rng(seed)
    js = j_state.init_state(_gaussians(rng, n_cap), n_cap=n_cap)
    alive = (rng.uniform(size=n_cap) < 0.8) & (np.arange(n_cap) < n_cap * 5 // 8)
    op = rng.uniform(-5.0, 1.0, n_cap).astype(np.float32)
    sc = np.log(rng.choice([0.005, 0.015, 0.03, 0.15, 0.25, 0.4], size=(n_cap, 3))
                * rng.uniform(0.9, 1.1, (n_cap, 3))).astype(np.float32)
    dur = rng.integers(0, 5, n_cap).astype(np.int32)
    accum = (rng.uniform(0.0, 0.2, n_cap) * dur).astype(np.float32)
    adam = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
            for k, v in js.adam_m.items()}
    return js._replace(params={**js.params, "opacity": jnp.asarray(op),
                               "scale": jnp.asarray(sc)},
                       alive=jnp.asarray(alive), adam_m=adam,
                       adam_v=jax.tree.map(jnp.abs, adam),
                       uv_grad_accum=jnp.asarray(accum), accum_dur=jnp.asarray(dur))


@pytest.mark.parametrize("flags", [{}, {"use_clone": False}, {"use_delete": False},
                                   {"use_split": False}])
def test_random_state_matches_jax(flags):
    js = _random_state(3)
    j_new, j_info, t_new, t_info = _run_both(js, 5, max_gaussians=200, **flags)
    _assert_info_equal(t_info, j_info)
    assert t_info.applied
    assert t_info.num_pruned > 0 or flags.get("use_delete") is False
    assert t_info.num_split > 0 or flags.get("use_split") is False
    assert t_info.num_cloned > 0 or flags.get("use_clone") is False
    _assert_states_equal(t_new, j_new, _children(t_info))


def test_needs_grow_then_rerun_matches_jax():
    # 60 of 64 rows split: 120 children do not fit, so the step changes
    # nothing but the returned accumulators; grown to 128 rows it applies.
    rng = np.random.default_rng(4)
    js = j_state.init_state(_gaussians(rng, 60), n_cap=64)
    js = js._replace(params={**js.params, "scale": jnp.full((64, 3), np.log(0.1),
                                                             jnp.float32)},
                     uv_grad_accum=jnp.full((64,), 5.0), accum_dur=jnp.ones(64, jnp.int32))
    port = _to_port(js)
    j_new, j_info, t_new, t_info = _run_both(js, 7)
    _assert_info_equal(t_info, j_info)
    assert t_info.needs_grow and not t_info.applied and t_info.new_total == 60
    _assert_states_equal(t_new, j_new)
    j_ds, t_ds = _statics()
    j_grown = j_state.grow_state(js, 128)
    t_grown = t_state.grow_state(port, 128)
    _assert_states_equal(t_grown, j_grown)
    j_step, _ = j_density.get_density_fns(j_ds)
    j_new, j_info = j_step(j_grown, jax.random.key(7))
    t_new, t_info = t_density.adaptive_density_step(t_grown, t_ds, *_jax_noise(7, 128))
    _assert_info_equal(t_info, j_info)
    assert t_info.applied and t_info.new_total == 120 and t_new.capacity == 128
    _assert_states_equal(t_new, j_new, _children(t_info))


def test_split_children_statistics_from_torch_generator():
    """Children get the parent's opacity and scale log(exp(s)/1.6), and
    their centres are N(parent, R S^2 R^T) under the port's own noise
    (``split_noise``), as tests/test_golden.py checks for the reference."""
    scale = np.log(np.array([0.4, 0.2, 0.1], np.float32))
    axis = np.array([1.0, 2.0, 2.0]) / 3.0
    half = np.deg2rad(30.0)
    quat = np.concatenate([[np.cos(half)], np.sin(half) * axis]).astype(np.float32)
    parent = np.array([0.5, -1.0, 4.0], np.float32)
    g = t_init.GaussianData(xyz=parent[None], rgb=np.zeros((1, 3), np.float32),
                            opacity=np.array([0.8], np.float32), scale=scale[None],
                            quaternion=quat[None])
    _, ds = _statics(scene_extent=8.0, delete_opacity_threshold=0.01, max_gaussians=100)
    children = []
    for trial in range(400):
        state = t_state.state_from_gaussians(g, "cpu", n_cap=16)
        state.uv_grad_accum.fill_(10.0)
        state.accum_dur.fill_(1)
        state, info = t_density.adaptive_density_step(
            state, ds, *t_density.split_noise(state, seed=3, iteration=trial))
        assert info.num_split == 1
        children.append(state.params.xyz[:2].detach().numpy().copy())
        if trial == 0:
            np.testing.assert_allclose(state.params.scale[:2].detach().numpy(),
                                       np.log(np.exp(scale) / 1.6)[None].repeat(2, 0),
                                       rtol=1e-5)
            np.testing.assert_allclose(state.params.opacity[:2].detach().numpy(),
                                       [0.8, 0.8], rtol=1e-6)
    pts = np.concatenate(children, axis=0)
    np.testing.assert_allclose(pts.mean(axis=0), parent, atol=0.05)
    w, x, y, z = quat
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    sigma = R @ np.diag(np.exp(scale) ** 2) @ R.T
    np.testing.assert_allclose(np.cov(pts.T), sigma, atol=0.03 * sigma.max() + 0.003)


def test_split_noise_is_seeded_by_seed_and_iteration():
    state = t_state.state_from_gaussians(_gaussians(np.random.default_rng(0), 5, t_init),
                                         "cpu", n_cap=32)
    a = t_density.split_noise(state, 2, 10)
    b = t_density.split_noise(state, 2, 10)
    c = t_density.split_noise(state, 2, 11)
    assert a[0].shape == (32, 3) and torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], c[0])


# ------------------------------------------------------------- Morton sort


def test_morton_codes_bit_equal_to_jax():
    rng = np.random.default_rng(8)
    xyz = (rng.normal(size=(5000, 3)) * [3.0, 0.5, 2.0] + [1.0, -2.0, 6.0]).astype(np.float32)
    mask = rng.uniform(size=5000) < 0.9
    xyz[~mask] = rng.normal(size=(int((~mask).sum()), 3)) * 100  # dead rows anywhere
    ref = np.asarray(j_morton.morton_codes(jnp.asarray(xyz), jnp.asarray(mask)))
    got = t_morton.morton_codes(torch.from_numpy(xyz), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert (got[~mask] == 0x7FFFFFFF).all() and got[mask].max() < 1 << 30


def test_morton_sort_matches_jax():
    js = _random_state(9, n_cap=256)
    j_sorted = jax.jit(j_density.morton_sort)(js)
    t_sorted = t_density.morton_sort(_to_port(js))
    _assert_states_equal(t_sorted, j_sorted)
    alive = t_sorted.alive.numpy()
    n = int(alive.sum())
    assert alive[:n].all() and not alive[n:].any()


# ------------------------------------------------------------- the rest


def test_reset_opacity_matches_jax():
    js = _random_state(10)
    j_out = jax.jit(j_density.reset_opacity, static_argnums=1)(js, 0.05)
    t_out = t_density.reset_opacity(_to_port(js), 0.05)
    _assert_states_equal(t_out, j_out)
    alive = t_out.alive.numpy()
    assert (t_out.params.opacity.detach().numpy()[alive]
            == np.float32(np.log(0.05) - np.log(0.95))).all()


def test_zero_sh_matches_jax():
    js = _random_state(11)
    js = js._replace(params={**js.params, "sh": jnp.ones_like(js.params["sh"])})
    _assert_states_equal(t_density.zero_sh(_to_port(js)), j_density.zero_sh(js))


@pytest.mark.parametrize("l_max", [0, 1, 3])
def test_to_gaussian_data_matches_jax(l_max):
    js = _random_state(12)
    js = js._replace(params={**js.params, "sh": jnp.asarray(
        np.random.default_rng(1).normal(size=(64, 15, 3)).astype(np.float32))})
    ref = j_state.to_gaussian_data(js, l_max)
    got = t_state.to_gaussian_data(_to_port(js), l_max)
    assert t_state.num_active(_to_port(js)) == j_state.num_active(js)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if b is None:
            assert a is None, f.name
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("n,kw", [(100, {}), (5000, {}), (5000, {"max_gaussians": 3000}),
                                  (40, {"n_cap": 64})])
def test_state_from_gaussians_matches_init_state(n, kw):
    g = _gaussians(np.random.default_rng(n), n)
    g.sh = np.random.default_rng(2).normal(size=(n, 15, 3)).astype(np.float32)
    if "max_gaussians" in kw:  # capped capacity: the Gaussians must fit
        g = g.filter(np.arange(n) < 2000)
    js = j_state.init_state(g, **kw)
    port = t_state.state_from_gaussians(t_init.GaussianData(**dataclasses.asdict(g)),
                                        "cpu", **kw)
    assert port.capacity == js.capacity
    _assert_states_equal(port, js)
