"""Port parity: the tile-sharded step against the JAX package's own.

The port's ``tp_train_step`` on 2 gloo ranks against JAX's
``tp_train_step`` on 2 virtual devices, one camera at 48x40: 3 tile rows
in strips of 2, so the last strip is padded and the uv scale is R10's
unpadded (W, H) (ROADMAP Queue 3). The JAX step's ``build_tile_tables``
and ``rasterize`` are bound, in this test only, to exact mode
(``bf16_colors=False``, ``bf16_grads=False``), the mode the port is held
to, and the port's ranks to it too (``train.step.exact_mode``). Loss, parameters, both Adam moments, ``uv_grad_accum`` and
``accum_dur`` are compared: after one Adam step the parameters hardly
depend on the gradients' scale, the moments do, so a factor between the
two steps' strip sums would show there.

A file of its own, so that its interpret-mode compile runs beside
tests/test_torch_parallel.py's under ``--dist loadfile``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel import (  # noqa: E402
    BG, N_CAP, NAMES, _camera, _gts, _moments_match, _rank_tp, _run, _same_state, _scene,
    _statics)


def test_tp_matches_jax_tp_train_step(monkeypatch):
    import jax
    import jax.numpy as jnp

    from gsplat_tpu.parallel import tile_parallel as j_tp
    from gsplat_tpu.train import state as j_state
    from gsplat_tpu.train import step as j_step

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    height = 40
    params, alive = _scene()
    gt = _gts(1, height=height)[0]
    outs = _run(_rank_tp, 2, params, alive, gt, height)
    monkeypatch.setattr(j_tp, "build_tile_tables",
                        functools.partial(j_tp.build_tile_tables, bf16_colors=False))
    monkeypatch.setattr(j_tp, "rasterize", functools.partial(j_tp.rasterize, bf16_grads=False))
    st = _statics(height=height)
    j_st = j_step.StepStatics(chunk=128, **dict(dataclasses.asdict(st), pair_cap=2048))
    zeros = {k: jnp.zeros_like(jnp.asarray(v)) for k, v in params.items()}
    state = j_state.TrainState({k: jnp.asarray(v) for k, v in params.items()}, zeros, zeros,
                               jnp.asarray(alive), jnp.zeros(N_CAP, jnp.float32),
                               jnp.zeros(N_CAP, jnp.int32))
    cm = _camera(0, height=height)
    ref, m = j_tp.tp_train_step(
        state, jnp.asarray(cm.view), jnp.asarray(cm.proj), jnp.asarray(cm.campos),
        jnp.asarray(gt), jnp.float32(BG), jnp.int32(0), j_st,
        j_tp.make_tile_mesh(jax.devices()[:2]))
    ref = {f: jax.tree.map(np.asarray, getattr(ref, f)) for f in ref._fields}
    o0, o1 = outs
    _same_state(o0["tp"], o1["tp"], "replicas")
    got = o0["tp"]
    _, l_step, l_grads = o0["loss"]
    assert l_step == l_grads == pytest.approx(float(m.loss), rel=1e-5)
    assert o0["pairs"][1] == int(m.num_pairs) > 0
    for name in NAMES:
        np.testing.assert_allclose(got["params"][name], ref["params"][name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    _moments_match(got, ref)
    np.testing.assert_array_equal(got["accum_dur"], ref["accum_dur"])
    assert got["accum_dur"].max() == 1
    np.testing.assert_allclose(got["uv_grad_accum"], ref["uv_grad_accum"], rtol=1e-3)
