"""Port parity: the monitored data-parallel step at a pair cap that drops
pairs, against the JAX package's own.

The port's ``get_monitored_dp_train_step`` on 2 gloo ranks against JAX's
``get_monitored_dp_train_step`` on 2 virtual devices, 2 steps of two
distinct cameras (rank r takes camera (r + k) % 2 at step k), on
tests/test_torch_parallel.py's scene with 300 Gaussians in 320 rows at
48x40, pair cap 512: each camera's frame needs ~1,000 slots, so both
sides drop pairs, as the reference drops them. Both sides are bound to
exact mode as tests/test_torch_parallel.py's dp parity binds them (JAX's
``compute_loss_and_grads`` replaced, in this test only, by its exact-mode
twin; the port's ranks under ``train.step.exact_mode``).

Exact: the monitor, ``num_pairs``, ``overflow`` and ``row_overflow`` of
every step. Within the existing parity tests' tolerances: the loss,
parameters, both Adam moments, ``uv_grad_accum``; ``accum_dur`` exact.

A file of its own, so that its interpret-mode compile runs beside the
other parity files' under ``--dist loadfile``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel import (  # noqa: E402
    BG, NAMES, _camera, _gts, _jax_exact_loss_and_grads, _moments_match, _rank_setup, _run,
    _same_state, _scene, _state, _statics)

from gsplat_tpu_torch.train import state as t_state  # noqa: E402
from gsplat_tpu_torch.train import step as t_step  # noqa: E402

HEIGHT, N, N_CAP, PAIR_CAP, STEPS = 40, 300, 320, 512, 2


def caps_statics():
    return dataclasses.replace(_statics(height=HEIGHT), pair_cap=PAIR_CAP)


def _rank_monitored(rank, kind, params, alive, gts, steps):
    """``steps`` monitored dp or tp steps from (params, alive), in exact
    mode: the state, and each step's (loss, num_pairs, overflow,
    row_overflow, monitor)."""
    from gsplat_tpu_torch.parallel import (
        get_monitored_dp_train_step, get_monitored_tp_train_step)

    _rank_setup()
    st = caps_statics()
    get = get_monitored_dp_train_step if kind == "dp" else get_monitored_tp_train_step
    fn, state, monitor, out = get(st), _state(params, alive), t_step.fresh_monitor("cpu"), []
    with t_step.exact_mode():
        for k in range(steps):
            c = (rank + k) % 2 if kind == "dp" else k % 2
            cm = _camera(c, height=HEIGHT)
            state, m, monitor = fn(state, cm.view, cm.proj, cm.campos,
                                   torch.from_numpy(gts[c]), BG, k, monitor)
            out.append((float(m.loss), int(m.num_pairs), int(m.overflow),
                        int(m.row_overflow), monitor.numpy().copy()))
    return t_state.state_to_numpy(state), out


def jax_start(params, alive):
    import jax.numpy as jnp

    from gsplat_tpu.train import state as j_state

    zeros = lambda: {k: jnp.zeros_like(jnp.asarray(v)) for k, v in params.items()}  # noqa: E731
    # The monitored steps donate the state: no two of its fields share a buffer.
    return j_state.TrainState({k: jnp.asarray(v) for k, v in params.items()}, zeros(), zeros(),
                              jnp.asarray(alive), jnp.zeros(N_CAP, jnp.float32),
                              jnp.zeros(N_CAP, jnp.int32))


def jax_statics():
    from gsplat_tpu.train import step as j_step

    return j_step.StepStatics(chunk=128, **dataclasses.asdict(caps_statics()))


def assert_runs_match(got, ref):
    """The port's (state, steps) against the reference's: monitor and
    counts exact, state within tests/test_torch_parallel.py's tolerances."""
    (state, steps), (ref_state, ref_steps) = got, ref
    for k, ((loss, pairs, overflow, row_overflow, mon),
            (r_loss, r_pairs, r_overflow, r_row_overflow, r_mon)) in enumerate(
            zip(steps, ref_steps)):
        np.testing.assert_array_equal(mon, r_mon, err_msg=f"monitor, step {k}")
        assert (pairs, overflow, row_overflow) == (r_pairs, r_overflow, r_row_overflow), k
        assert loss == pytest.approx(r_loss, rel=1e-5), k
    for name in NAMES:
        np.testing.assert_allclose(state["params"][name], ref_state["params"][name],
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    _moments_match(state, ref_state)
    np.testing.assert_array_equal(state["accum_dur"], ref_state["accum_dur"])
    np.testing.assert_allclose(state["uv_grad_accum"], ref_state["uv_grad_accum"], rtol=1e-3)


def test_monitored_dp_at_dropping_cap_matches_jax(monkeypatch):
    import jax
    import jax.numpy as jnp

    from gsplat_tpu.parallel import data_parallel as j_dp
    from gsplat_tpu.train.step import fresh_monitor

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    params, alive = _scene(n=N, n_cap=N_CAP)
    gts = _gts(2, height=HEIGHT)
    outs = _run(_rank_monitored, 2, "dp", params, alive, gts, STEPS)
    monkeypatch.setattr(j_dp, "compute_loss_and_grads", _jax_exact_loss_and_grads)
    j_dp.get_monitored_dp_train_step.cache_clear()  # no step traced in another mode
    try:
        fn = j_dp.get_monitored_dp_train_step(jax_statics(), tuple(jax.devices()[:2]))
        state, monitor, steps = jax_start(params, alive), fresh_monitor(), []
        for k in range(STEPS):
            cams = [_camera((r + k) % 2, height=HEIGHT) for r in range(2)]
            stack = lambda f: jnp.asarray(np.stack([getattr(c, f) for c in cams]))  # noqa: E731
            state, m, monitor = fn(
                state, stack("view"), stack("proj"), stack("campos"),
                jnp.asarray(np.stack([gts[(r + k) % 2] for r in range(2)])),
                jnp.full((2,), BG, jnp.float32), jnp.int32(k), monitor)
            steps.append((float(m["loss"]), int(m["num_pairs"]), int(m["overflow"]),
                          int(m["row_overflow"]), np.asarray(monitor).copy()))
    finally:
        j_dp.get_monitored_dp_train_step.cache_clear()
    ref = {f: jax.tree.map(np.asarray, getattr(state, f)) for f in state._fields}
    _same_state(outs[0][0], outs[1][0], "replicas")
    for a, b in zip(outs[0][1], outs[1][1]):  # every rank read the same metrics
        assert a[:-1] == b[:-1] and np.array_equal(a[-1], b[-1])
    assert all(s[2] > PAIR_CAP for s in steps)  # every step dropped pairs
    assert_runs_match(outs[0], (ref, steps))
