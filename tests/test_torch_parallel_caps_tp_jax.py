"""Port parity: the monitored tile-parallel step at a pair cap that drops
pairs, against the JAX package's own.

The port's ``get_monitored_tp_train_step`` on 2 gloo ranks against JAX's
``get_monitored_tp_train_step`` on 2 virtual devices, 2 steps (camera 0,
then camera 1) on tests/test_torch_parallel_caps_dp_jax.py's scene at
48x40 (3 tile rows in strips of 2: the last strip padded), pair cap 512:
the first strip needs ~900 slots, so both sides drop its pairs. Both sides
are bound to exact mode as tests/test_torch_parallel_tp_jax.py binds them.
Exact: the monitor, ``num_pairs`` (the strips' sum), ``overflow`` and
``row_overflow`` (the strips' max); the state within the existing parity
tests' tolerances (``assert_runs_match``).

A file of its own, so that its interpret-mode compile runs beside the
other parity files' under ``--dist loadfile``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel import _camera, _gts, _run, _same_state, _scene  # noqa: E402
from test_torch_parallel_caps_dp_jax import (  # noqa: E402
    BG, HEIGHT, N, N_CAP, PAIR_CAP, STEPS, _rank_monitored, assert_runs_match, jax_start,
    jax_statics)


def test_monitored_tp_at_dropping_cap_matches_jax(monkeypatch):
    import jax
    import jax.numpy as jnp

    from gsplat_tpu.parallel import tile_parallel as j_tp
    from gsplat_tpu.train.step import fresh_monitor

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    params, alive = _scene(n=N, n_cap=N_CAP)
    gts = _gts(2, height=HEIGHT)
    outs = _run(_rank_monitored, 2, "tp", params, alive, gts, STEPS)
    monkeypatch.setattr(j_tp, "build_tile_tables",
                        functools.partial(j_tp.build_tile_tables, bf16_colors=False))
    monkeypatch.setattr(j_tp, "rasterize", functools.partial(j_tp.rasterize, bf16_grads=False))
    j_tp.get_monitored_tp_train_step.cache_clear()  # no step traced in another mode
    try:
        fn = j_tp.get_monitored_tp_train_step(jax_statics(), tuple(jax.devices()[:2]))
        state, monitor, steps = jax_start(params, alive), fresh_monitor(), []
        for k in range(STEPS):
            cm = _camera(k % 2, height=HEIGHT)
            state, m, monitor = fn(state, jnp.asarray(cm.view), jnp.asarray(cm.proj),
                                   jnp.asarray(cm.campos), jnp.asarray(gts[k % 2]),
                                   jnp.float32(BG), jnp.int32(k), monitor)
            steps.append((float(m.loss), int(m.num_pairs), int(m.overflow),
                          int(m.row_overflow), np.asarray(monitor).copy()))
    finally:
        j_tp.get_monitored_tp_train_step.cache_clear()
    ref = {f: jax.tree.map(np.asarray, getattr(state, f)) for f in state._fields}
    _same_state(outs[0][0], outs[1][0], "replicas")
    for a, b in zip(outs[0][1], outs[1][1]):  # every rank read the same metrics
        assert a[:-1] == b[:-1] and np.array_equal(a[-1], b[-1])
    assert all(s[2] > PAIR_CAP for s in steps)  # a strip dropped pairs every step
    assert_runs_match(outs[0], (ref, steps))
