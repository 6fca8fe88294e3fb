"""Port parity: the loss, Adam, the train state and the training step.

Same numpy inputs through the JAX package and the port, at f32:

- ``fused_loss`` value and gradient (the reference's non-adjoint,
  zero-padded backward) on images whose edges carry structure;
- ``masked_adam_update`` and ``apply_adam`` on identical inputs, with NaN
  gradients, half the rows masked, ``l_max`` 0 and 3;
- the port's in-place update ``kernels/adam.py::masked_adam_update_`` on
  CPU tensors (the plain update written back, no kernel launch), its
  argument checks and its kernel's f32 constants;
- the per-Gaussian chain's autograd gradients against ``jax.vjp`` of
  ``gsplat_tpu.train.step._per_gaussian``;
- ``state_from_jax`` -> ``state_to_numpy`` keeps a JAX ``TrainState``;
- one and three ``train_step``s, bound to exact mode
  (``train.step.exact_mode``), against a JAX exact-mode step built from the
  package's public pieces (``_per_gaussian``, ``pack_attrs``,
  ``build_tile_tables(bf16_colors=False)``, ``rasterize(bf16_grads=False)``,
  ``fused_loss``, ``jax.value_and_grad`` with the uv probe, ``apply_adam``),
  at 64x40 (a height that is not a multiple of 16) with ~300 Gaussians,
  SH degree 3, dead rows and capacity padding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from gsplat_tpu_torch.train.step import exact_mode  # noqa: E402

from gsplat_tpu.ops import adam as j_adam  # noqa: E402
from gsplat_tpu.ops.binning import build_tile_tables as j_build_tile_tables  # noqa: E402
from gsplat_tpu.ops.camera import build_camera_matrices  # noqa: E402
from gsplat_tpu.ops.loss import fused_loss as j_fused_loss  # noqa: E402
from gsplat_tpu.ops.render import pack_attrs as j_pack_attrs  # noqa: E402
from gsplat_tpu.ops.render import rasterize as j_rasterize  # noqa: E402
from gsplat_tpu.train import state as j_state  # noqa: E402
from gsplat_tpu.train import step as j_step  # noqa: E402
from gsplat_tpu_torch.kernels import _build  # noqa: E402
from gsplat_tpu_torch.kernels import adam as k_adam  # noqa: E402
from gsplat_tpu_torch.ops import adam as t_adam  # noqa: E402
from gsplat_tpu_torch.ops import loss as t_loss  # noqa: E402
from gsplat_tpu_torch.train import state as t_state  # noqa: E402
from gsplat_tpu_torch.train import step as t_step  # noqa: E402

W, H, N, N_CAP = 64, 40, 300, 320
BG = 0.2
PAIR_CAP = 8192
NAMES = list(t_state.PARAM_DIMS)
COMMON = dict(
    width=W, height=H, tile=16, l_max=3, near_thresh=0.3, mh_dist=3.0,
    cull_padding=100, ssim_frac=0.2, base_lr=1e-3, xyz_lr_init=0.16,
    xyz_lr_final=0.0016, quat_lr=1.0, scale_lr=5.0, opacity_lr=25.0,
    rgb_lr=2.5, sh_lr=0.125, scene_extent=4.0, num_iters=7000,
)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, rtol, atol_rel, err_msg=""):
    """assert_allclose with atol = atol_rel * max |ref| over finite entries;
    NaN must sit in the same places."""
    got, ref = _np(got), _np(ref)
    scale = float(np.abs(ref[np.isfinite(ref)]).max(initial=0.0))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_rel * max(scale, 1e-30),
                               err_msg=err_msg)


# ---------------------------------------------------------------- loss


def _edge_images():
    rng = np.random.default_rng(21)
    gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    pred = np.clip(gt + 0.2 * rng.normal(size=gt.shape), 0, 1).astype(np.float32)
    # a bright frame and a step at the border: structure the zero-padded
    # backward and the edge-clamped forward treat differently
    pred[:3] += 0.5
    pred[:, -2:] -= 0.4
    return pred, gt


@pytest.mark.parametrize("ssim_weight", [0.2, 1.0])
def test_fused_loss_matches_jax(ssim_weight):
    pred, gt = _edge_images()
    j_val, j_grad = jax.value_and_grad(j_fused_loss)(jnp.asarray(pred), jnp.asarray(gt),
                                                     ssim_weight)
    p = _t(pred).requires_grad_(True)
    val = t_loss.fused_loss(p, _t(gt), ssim_weight)
    (grad,) = torch.autograd.grad(val, p)
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-5)
    # Same formulas; the convolutions sum taps in another order.
    _close(grad, j_grad, rtol=1e-4, atol_rel=1e-5)
    # Not the adjoint of the forward: autograd through it differs at the edges.
    p2 = _t(pred).requires_grad_(True)
    pc, gc = p2.permute(2, 0, 1), _t(gt).permute(2, 0, 1)
    (adjoint,) = torch.autograd.grad(t_loss._fused_loss_fwd(pc, gc, ssim_weight)[0], p2)
    assert not np.allclose(_np(adjoint)[0], _np(grad)[0], rtol=1e-3, atol=0)


# ---------------------------------------------------------------- Adam


def _adam_inputs(seed, n=64):
    rng = np.random.default_rng(seed)
    out = {}
    for name in NAMES:
        shape = t_state._param_shape(name, n)
        g = rng.normal(size=shape).astype(np.float32)
        g[rng.uniform(size=shape) < 0.1] = np.nan
        out[name] = dict(
            p=rng.normal(size=shape).astype(np.float32), g=g,
            m=(0.1 * rng.normal(size=shape)).astype(np.float32),
            v=rng.uniform(0, 0.1, size=shape).astype(np.float32),
        )
    mask = np.zeros(n, bool)
    mask[::2] = True
    return out, mask


def test_masked_adam_update_matches_jax():
    data, mask = _adam_inputs(1)
    for name, d in data.items():
        ref = j_adam.masked_adam_update(
            *(jnp.asarray(d[k]) for k in "pgmv"), jnp.asarray(mask),
            jnp.float32(0.01), jnp.float32(0.271), jnp.float32(0.00299))
        got = t_adam.masked_adam_update(
            *(_t(d[k]) for k in "pgmv"), _t(mask), 0.01,
            torch.tensor(0.271), torch.tensor(0.00299))
        for g, r, k in zip(got, ref, "pmv"):
            _close(g, r, rtol=1e-6, atol_rel=1e-7, err_msg=f"{name}.{k}")
        # masked-out rows are unchanged, bit for bit
        for g, k in zip(got, "pmv"):
            np.testing.assert_array_equal(_np(g)[~mask], d[k][~mask])
        assert np.isfinite(_np(got[0])).all()  # NaN gradients became 0


@pytest.mark.parametrize("l_max", [0, 3])
@pytest.mark.parametrize("iteration", [0, 5000])
def test_apply_adam_matches_jax(l_max, iteration):
    data, mask = _adam_inputs(2 + l_max)
    n = mask.shape[0]
    rng = np.random.default_rng(9)
    g_uv = rng.normal(size=(n, 2)).astype(np.float32)
    acc = rng.uniform(0, 3, n).astype(np.float32)
    dur = rng.integers(0, 9, n).astype(np.int32)
    alive = np.ones(n, bool)
    pick = lambda k: {name: d[k] for name, d in data.items()}  # noqa: E731
    j_st = j_step.StepStatics(chunk=128, pair_cap=PAIR_CAP, focal_x=1.0, focal_y=1.0,
                              tan_fovx=1.0, tan_fovy=1.0, **{**COMMON, "l_max": l_max})
    t_st = t_step.StepStatics(focal_x=1.0, focal_y=1.0, tan_fovx=1.0, tan_fovy=1.0,
                              **{**COMMON, "l_max": l_max})
    to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    j_new = j_step.apply_adam(
        j_state.TrainState(to_j(pick("p")), to_j(pick("m")), to_j(pick("v")),
                           jnp.asarray(alive), jnp.asarray(acc), jnp.asarray(dur)),
        to_j(pick("g")), jnp.asarray(g_uv), jnp.asarray(mask), jnp.int32(iteration), j_st)
    state = t_state.state_from_jax(pick("p"), pick("m"), pick("v"), alive, acc, dur, "cpu")
    t_step.apply_adam(state, {k: _t(v) for k, v in pick("g").items()}, _t(g_uv),
                      _t(mask), iteration, t_st)
    got = t_state.state_to_numpy(state)
    for field in ("params", "adam_m", "adam_v"):
        for name in NAMES:
            _close(got[field][name], getattr(j_new, field)[name], rtol=2e-6,
                   atol_rel=1e-7, err_msg=f"{field}.{name}")
    if l_max == 0:
        np.testing.assert_array_equal(got["params"]["sh"], data["sh"]["p"])
    _close(got["uv_grad_accum"], j_new.uv_grad_accum, rtol=1e-6, atol_rel=0)
    np.testing.assert_array_equal(got["accum_dur"], np.asarray(j_new.accum_dur))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("lr", [0.01, "tensor"])
def test_masked_adam_update_in_place_on_cpu_is_plain(name, lr):
    # The in-place wrapper on CPU tensors: the plain update and its copies,
    # bit for bit, and no kernel launch.
    data, mask = _adam_inputs(11)
    d = {k: _t(v) for k, v in data[name].items()}
    lr = torch.tensor(0.01) if lr == "tensor" else lr
    bias1, bias2 = torch.tensor(0.271), torch.tensor(0.00299)
    want = t_adam.masked_adam_update(d["p"], d["g"], d["m"], d["v"], _t(mask), lr, bias1, bias2)
    before = dict(_build.launches)
    ptrs = [d[k].data_ptr() for k in "pmv"]
    k_adam.masked_adam_update_(d["p"], d["g"], d["m"], d["v"], _t(mask), lr, bias1, bias2)
    assert _build.launches == before and _build.launches["masked_adam"] == 0
    assert [d[k].data_ptr() for k in "pmv"] == ptrs  # written in place
    for got, ref in zip((d["p"], d["m"], d["v"]), want):
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_masked_adam_kernel_constants_are_f32_roundings():
    # The kernel's B1, 1 - B1, B2, 1 - B2 and EPS: the float32 roundings of
    # the Python doubles that torch's scalar path rounds in the plain update.
    doubles = (t_adam.B1, 1.0 - t_adam.B1, t_adam.B2, 1.0 - t_adam.B2, t_adam.EPS)
    assert [c.value for c in k_adam._CONSTANTS] == [float(np.float32(d)) for d in doubles]


def _bad_adam_args(case):
    p, g, m, v = (torch.zeros(8, 3) for _ in range(4))
    mask, lr, b1, b2 = torch.ones(8, dtype=torch.bool), 0.01, torch.tensor(0.1), torch.tensor(0.2)
    if case == "grad shape":
        g = torch.zeros(8, 4)
    elif case == "mask shape":
        mask = torch.ones(9, dtype=torch.bool)
    elif case == "float64 moment":
        m = torch.zeros(8, 3, dtype=torch.float64)
    elif case == "float64 bias":
        b2 = torch.tensor(0.2, dtype=torch.float64)
    elif case == "int mask":
        mask = torch.ones(8, dtype=torch.int32)
    elif case == "non-contiguous param":
        p = torch.zeros(3, 8).t()
    elif case == "non-contiguous grad":
        g = torch.zeros(8, 6)[:, ::2]
    return p, g, m, v, mask, lr, b1, b2


@pytest.mark.parametrize("case", [
    "grad shape", "mask shape", "float64 moment", "float64 bias", "int mask",
    "non-contiguous param", "non-contiguous grad"])
def test_masked_adam_update_rejects_bad_arguments(case):
    args = _bad_adam_args(case)
    before = [t.clone() for t in args[:4]]
    with pytest.raises(ValueError, match="masked_adam"):
        k_adam.masked_adam_update_(*args)
    for t, b in zip(args[:4], before):  # nothing was written
        assert torch.equal(t, b)


# ---------------------------------------------------------------- scene


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(7)
    params = dict(
        xyz=(rng.normal(size=(N, 3)) * [1.0, 0.7, 0.6] + [0, 0, 4.0]),
        rgb=rng.normal(size=(N, 3)),
        opacity=rng.uniform(-1.0, 2.0, N),
        scale=np.log(rng.uniform(0.02, 0.15, (N, 3))),
        quat=np.concatenate([np.ones((N, 1)), 0.3 * rng.normal(size=(N, 3))], axis=1),
        sh=0.1 * rng.normal(size=(N, 15, 3)),
    )
    # capacity padding: zero rows (xyz = 0, quat = 0), not alive
    params = {k: np.concatenate([v, np.zeros((N_CAP - N,) + v.shape[1:])]).astype(np.float32)
              for k, v in params.items()}
    alive = np.arange(N_CAP) < N
    alive[::17] = False
    cm = build_camera_matrices(np.array([0.999, 0.02, -0.03, 0.01]),
                               np.array([0.05, -0.02, 0.1]), W, H, W * 0.85, W * 0.85)
    intr = dict(focal_x=cm.focal_x, focal_y=cm.focal_y, tan_fovx=cm.tan_fovx,
                tan_fovy=cm.tan_fovy)
    j_st = j_step.StepStatics(chunk=128, pair_cap=PAIR_CAP, interpret=True, **COMMON, **intr)
    t_st = t_step.StepStatics(**COMMON, **intr)
    with exact_mode():
        gt, _ = t_step.render_image(t_state.params_from_jax(params, alive, "cpu"),
                                    cm.view, cm.proj, cm.campos, BG, t_st)
    # train a perturbed copy towards the scene's own render
    start = dict(params, rgb=params["rgb"] + 0.3 * rng.normal(size=(N_CAP, 3)).astype(np.float32),
                 opacity=params["opacity"] - 0.5)
    return start, alive, cm, j_st, t_st, gt.numpy()


def test_per_gaussian_grads_match_jax(scene):
    params, alive, cm, j_st, t_st, _ = scene
    rng = np.random.default_rng(4)
    cots = [rng.normal(size=s).astype(np.float32) for s in ((N_CAP, 2), (N_CAP, 3), (N_CAP, 3))]
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def j_fn(p):
        uv, conic, rgb, *_ = j_step._per_gaussian(
            p, jnp.asarray(alive), jnp.asarray(cm.view), jnp.asarray(cm.proj),
            jnp.asarray(cm.campos), j_st)
        return uv, conic, rgb

    j_out, vjp = jax.vjp(j_fn, jp)
    (j_grads,) = vjp(tuple(jnp.asarray(c) for c in cots))
    gp = t_state.params_from_jax(params, alive, "cpu")
    uv, conic, rgb, *_ = t_step._per_gaussian(gp, _t(cm.view), _t(cm.proj), _t(cm.campos), t_st)
    for got, ref in zip((uv, conic, rgb), j_out):
        _close(got, ref, rtol=1e-5, atol_rel=1e-6)
    leaves = [getattr(gp, k) for k in NAMES]
    grads = torch.autograd.grad((uv, conic, rgb), leaves, grad_outputs=[_t(c) for c in cots],
                                allow_unused=True)
    for name, got in zip(NAMES, grads):
        got = torch.zeros_like(leaves[NAMES.index(name)]) if got is None else got
        assert np.isnan(_np(got)[N:]).any() == np.isnan(np.asarray(j_grads[name])[N:]).any()
        _close(got, j_grads[name], rtol=1e-4, atol_rel=1e-5, err_msg=name)


def test_state_from_jax_roundtrip():
    rng = np.random.default_rng(12)
    n = 48
    group = lambda: {k: rng.normal(size=t_state._param_shape(k, n)).astype(np.float32)  # noqa: E731
                     for k in NAMES}
    js = j_state.TrainState(
        params=group(), adam_m=group(), adam_v=group(), alive=rng.uniform(size=n) < 0.6,
        uv_grad_accum=rng.uniform(0, 5, n).astype(np.float32),
        accum_dur=rng.integers(0, 100, n).astype(np.int32),
    )
    js = jax.tree.map(jnp.asarray, js)
    host = {f: jax.tree.map(np.asarray, getattr(js, f)) for f in js._fields}
    state = t_state.state_from_jax(**host, device="cpu")
    back = t_state.state_to_numpy(state)
    assert set(back) == set(js._fields)
    for f in js._fields:
        for ours, theirs in zip(jax.tree.leaves(back[f]), jax.tree.leaves(host[f])):
            assert ours.dtype == theirs.dtype
            np.testing.assert_array_equal(ours, theirs)
    assert state.alive is state.params.alive and state.capacity == n


# ---------------------------------------------------------------- train step


def _jax_trajectory(start, alive, cm, j_st, gt, steps):
    """``steps`` JAX exact-mode train steps; per step (loss, grads, g_uv,
    state after the step), all on the host."""

    def loss_fn(p, uv_probe):
        uv, conic, rgb, mask, radius, z = j_step._per_gaussian(
            p, jnp.asarray(alive), jnp.asarray(cm.view), jnp.asarray(cm.proj),
            jnp.asarray(cm.campos), j_st)
        uv = uv + uv_probe
        sg = jax.lax.stop_gradient
        attrs = j_pack_attrs(uv, conic, rgb, p["opacity"])
        tables = j_build_tile_tables(
            sg(uv), sg(z), radius, mask, attrs=sg(attrs), num_tiles_x=j_st.num_tiles_x,
            num_tiles_y=j_st.num_tiles_y, tile_size=16, pair_cap=PAIR_CAP, chunk_size=128,
            bf16_colors=False, interpret=True)
        out = j_rasterize(uv, conic, rgb, p["opacity"], tables, jnp.float32(BG),
                          width=W, height=H, tile=16, chunk=128, interpret=True,
                          bf16_grads=False)
        return j_fused_loss(out.image, jnp.asarray(gt), j_st.ssim_frac), mask

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))
    adam = jax.jit(j_step.apply_adam, static_argnums=(5,))
    zeros = lambda: {k: jnp.zeros_like(jnp.asarray(v)) for k, v in start.items()}  # noqa: E731
    state = j_state.TrainState(
        params={k: jnp.asarray(v) for k, v in start.items()}, adam_m=zeros(), adam_v=zeros(),
        alive=jnp.asarray(alive), uv_grad_accum=jnp.zeros((N_CAP,), jnp.float32),
        accum_dur=jnp.zeros((N_CAP,), jnp.int32))
    out = []
    for it in range(steps):
        (loss, mask), (grads, g_uv) = grad_fn(state.params, jnp.zeros((N_CAP, 2), jnp.float32))
        state = adam(state, grads, g_uv, mask, jnp.int32(it), j_st)
        out.append(jax.tree.map(np.asarray, (loss, grads, g_uv, state._asdict())))
    return out


def _port_trajectory(start, alive, cm, t_st, gt, steps):
    state = t_state.init_state(t_state.params_from_jax(start, alive, "cpu"))
    out = []
    for it in range(steps):
        with exact_mode():
            loss, _, mask, tables, grads, g_uv = t_step.compute_loss_and_grads(
                state.params, cm.view, cm.proj, cm.campos, _t(gt), BG, t_st)
        t_step.apply_adam(state, grads, g_uv, mask, it, t_st)
        out.append((float(loss), {k: _np(v) for k, v in grads.items()}, _np(g_uv),
                    t_state.state_to_numpy(state), tables.num_pairs))
    return out


@pytest.fixture(scope="module")
def trajectories(scene):
    start, alive, cm, j_st, t_st, gt = scene
    return (_jax_trajectory(start, alive, cm, j_st, gt, 3),
            _port_trajectory(start, alive, cm, t_st, gt, 3))


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_jax_exact(scene, trajectories, steps):
    start = scene[0]
    j_traj, t_traj = trajectories
    j_loss, j_grads, j_guv, j_state_ = j_traj[steps - 1]
    loss, grads, g_uv, state, num_pairs = t_traj[steps - 1]
    assert num_pairs > 200
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
    # Gradients, moments and the uv statistics: f32 rounding of other
    # summation orders (pixels within a pair, pairs within a Gaussian, the
    # chunked replay) carried through the per-Gaussian chain, and after 3
    # steps through Adam's +-lr moves. Measured up to 1.1e-5 of each
    # tensor's largest value; the bound is 1e-4. NaN (dead capacity rows)
    # must sit in the same places.
    for name in NAMES:
        _close(grads[name], j_grads[name], rtol=1e-4, atol_rel=1e-4, err_msg=name)
        _close(state["adam_m"][name], j_state_["adam_m"][name], rtol=1e-4, atol_rel=1e-4)
        _close(state["adam_v"][name], j_state_["adam_v"][name], rtol=2e-4, atol_rel=2e-4)
    _close(g_uv, j_guv, rtol=1e-4, atol_rel=1e-4)
    _close(state["uv_grad_accum"], j_state_["uv_grad_accum"], rtol=1e-4, atol_rel=1e-4)
    np.testing.assert_array_equal(state["accum_dur"], j_state_["accum_dur"])
    assert state["accum_dur"].max() == steps
    # Parameters where the first step's gradient is well above rounding:
    # Adam moves them by ~lr * sign(g) per step, the same way in both.
    g0 = t_traj[0][1]
    for name in NAMES:
        big = np.abs(g0[name]) > 1e-2 * np.nanmax(np.abs(g0[name]))
        assert big.any(), name
        moved = np.abs(state["params"][name] - start[name])[big]
        assert moved.max() > 0, name
        np.testing.assert_allclose(state["params"][name][big], j_state_["params"][name][big],
                                   rtol=1e-5, atol=1e-2 * moved.max(), err_msg=name)


def test_train_step_with_nothing_visible(scene):
    # Every Gaussian behind the camera: no pairs, a background image, zero
    # gradients, and no row steps or accumulates.
    start, alive, cm, _, t_st, gt = scene
    params = dict(start, xyz=start["xyz"] * np.array([1, 1, -1], np.float32))
    state = t_state.init_state(t_state.params_from_jax(params, alive, "cpu"))
    before = t_state.state_to_numpy(state)
    state, metrics = t_step.train_step(state, cm.view, cm.proj, cm.campos, _t(gt), BG, 0, t_st)
    assert metrics.num_pairs == 0 and int(metrics.num_visible) == 0
    assert np.isfinite(float(metrics.loss))
    after = t_state.state_to_numpy(state)
    for field in ("params", "adam_m", "adam_v"):
        for name in NAMES:
            np.testing.assert_array_equal(after[field][name], before[field][name])
    np.testing.assert_array_equal(after["accum_dur"], 0)
    np.testing.assert_array_equal(after["uv_grad_accum"], 0.0)
