"""Port parity: the data-parallel step against the JAX package's own.

The port's ``dp_train_step`` on 2 gloo ranks against JAX's
``dp_train_step`` on 2 virtual devices, two distinct cameras at
tests/test_train.py's 48x32 geometry. The JAX step's
``compute_loss_and_grads`` is replaced, in this test only, by the same
function in exact mode (``bf16_colors=False``, ``bf16_grads=False``), and
the port's ranks are bound to it (``train.step.exact_mode``), the mode the
port is held to (tests/test_torch_train.py).

A file of its own, so that its interpret-mode compile runs beside
tests/test_torch_parallel.py's under ``--dist loadfile``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel import (  # noqa: E402
    BG, N_CAP, NAMES, _camera, _gts, _jax_exact_loss_and_grads, _moments_match,
    _rank_dp_two_cameras, _run, _same_state, _scene, _statics)


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
