"""Port parity: the dp and tp trainers at the reference's capacities.

- ``Trainer(dp=2)`` and ``Trainer(tp=2)`` on 2 gloo ranks against the JAX
  ``Trainer(dp=2)`` / ``Trainer(tp=2)`` on 2 virtual devices, each side's
  monitored step replaced by a recorder (as
  tests/test_torch_parallel.py::test_dp_draws_match_jax_trainer replaces
  the JAX one): the recorder reports pair and row requirements past the
  capacities it was given at chosen iterations (``_requirement``), before
  and after ``adaptive_control_end``. The ``(pair_cap, row_cap)`` every
  step is given, the final capacities and those the checkpoint holds must
  be equal on both sides and on both ranks;
- with the same camera on 2 gloo ranks, ``get_monitored_dp_train_step`` at
  a pair cap is bit-equal to ``get_monitored_train_step`` at the same cap:
  losses, monitors, ``num_pairs``, ``overflow``, ``row_overflow``, the
  parameters and both Adam moments, the accumulators exactly twice the
  single step's (two cameras' visibility and uv-gradient norms), at a cap
  above the frame's requirement and at one below it (pairs dropped).

No JAX kernel is compiled here: the JAX trainer's steps are recorders.
"""

import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel import (  # noqa: E402, F401 (dataset is a fixture)
    BG, NAMES, _camera, _gts, _rank_setup, _read, _run, _scene, _state, _statics,
    _write_config, dataset)

from gsplat_tpu_torch import config as t_config  # noqa: E402
from gsplat_tpu_torch.train import state as t_state  # noqa: E402
from gsplat_tpu_torch.train import step as t_step  # noqa: E402
from gsplat_tpu_torch.train import trainer as t_trainer  # noqa: E402
from gsplat_tpu_torch.utils import checkpoint as t_checkpoint  # noqa: E402

ITERS = 10
# Boundaries every 2 iterations; the growth's headroom is a quarter before
# iteration 5 and a sixteenth from it on; no density step, no reset.
CAPS_SCHEDULE = dict(num_iters=ITERS, print_interval=2, adaptive_control_start=10**9,
                     adaptive_control_end=5, reset_opacity_start=10**9)


def _requirement(it: int, pair_cap: int, row_cap: int) -> tuple:
    """The (pair, row) requirements the recorder reports at iteration
    ``it``, given the step's capacities: the pair cap passed at 1, the row
    cap at 3, both at 6 (past adaptive_control_end), else room to spare."""
    if it == 1:
        return pair_cap + 700, row_cap // 2
    if it == 3:
        return pair_cap // 2, row_cap + 5000
    if it == 6:
        return 3 * pair_cap + 1, 2 * row_cap + 1
    return pair_cap // 2, row_cap // 2


def _rank_trainer_caps(rank, cfg_path, root, mode, out_base):
    from gsplat_tpu_torch.train.init import initialize_gaussians

    _rank_setup()
    conf = dataclasses.replace(t_config.parse_config(cfg_path),
                               output_dir=str(Path(out_base) / f"rank{rank}"))
    cams, imgs, xyz, rgb = _read(Path(root))
    tr = t_trainer.Trainer(conf, initialize_gaussians(xyz, rgb, conf), imgs, cams,
                           device="cpu", **{mode: 2})
    given, first = [], (tr.pair_cap, tr.row_cap)

    def get_step(st):
        def step(state, view, proj, campos, gt, bg, iteration, monitor):
            given.append((int(iteration), st.pair_cap, st.row_cap))
            pairs, rows = _requirement(int(iteration), st.pair_cap, st.row_cap)
            zero, i32 = torch.zeros(()), lambda x: torch.tensor(x, dtype=torch.int32)
            m = t_step.StepMetrics(zero, zero, i32(0), i32(0), i32(pairs), i32(rows))
            return state, m, t_step.fold_monitor(monitor, m)
        return step

    setattr(t_trainer, f"get_monitored_{mode}_train_step", get_step)
    tr.train(verbose=False)
    ck_path = Path(conf.output_dir) / "checkpoint.npz"
    tr.save_checkpoint(ck_path)
    ck = t_checkpoint.load_checkpoint(ck_path, "cpu") if rank == 0 else None
    return dict(given=given, first=first, caps=(tr.pair_cap, tr.row_cap),
                ck=(ck.pair_cap, ck.row_cap) if ck else None)


@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_trainer_caps_match_jax_trainer(dataset, tmp_path, monkeypatch, mode):
    import jax
    import jax.numpy as jnp

    from gsplat_tpu import config as j_config
    from gsplat_tpu.io import colmap as j_colmap
    from gsplat_tpu.parallel import data_parallel as j_dp
    from gsplat_tpu.parallel import tile_parallel as j_tp
    from gsplat_tpu.train import init as j_init
    from gsplat_tpu.train import trainer as j_trainer
    from gsplat_tpu.utils import checkpoint as j_checkpoint

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    cfg = _write_config(tmp_path / "c.yaml", **CAPS_SCHEDULE)
    outs = _run(_rank_trainer_caps, 2, cfg, dataset, mode, tmp_path / "out")
    # The JAX Trainer's own loop, its monitored step replaced by a recorder.
    sparse = dataset / "scene" / "sparse" / "0"
    conf = j_config.parse_config(cfg)
    cams = j_colmap.read_cameras_binary(sparse / "cameras.bin", 1)
    imgs = j_colmap.read_images_binary(sparse / "images.bin", str(dataset / "scene") + "/", 1)
    _, _, xyz, rgb = _read(dataset)
    ref = j_trainer.Trainer(conf, j_init.initialize_gaussians(xyz, rgb, conf), imgs, cams,
                            **{mode: 2})
    first, seen = (ref.pair_cap, ref.row_cap), []

    def get_step(st, devices):
        def step(state, views, projs, campos, gts, bgs, iteration, monitor):
            it = int(iteration)
            seen.append((it, st.pair_cap, st.row_cap))
            pairs, rows = _requirement(it, st.pair_cap, st.row_cap)
            new = jnp.stack([jnp.maximum(monitor[0], jnp.float32(pairs)),
                             jnp.maximum(monitor[1], jnp.float32(rows)), monitor[2]])
            loss = jnp.float32(0.0)
            return state, ({"loss": loss} if mode == "dp"
                           else types.SimpleNamespace(loss=loss)), new
        return step

    module = j_dp if mode == "dp" else j_tp
    monkeypatch.setattr(module, f"get_monitored_{mode}_train_step", get_step)
    monkeypatch.setattr(ref, "_dump_image", lambda *a: None)
    monkeypatch.setattr(ref, "evaluate", lambda **k: None)
    ref.train(verbose=False)
    ref.save_checkpoint(tmp_path / "jax.npz")
    ck = j_checkpoint.load_checkpoint(tmp_path / "jax.npz")
    assert len(seen) == ITERS
    for o in outs:
        assert o["first"] == first
        assert o["given"] == seen, mode
        assert o["caps"] == (ref.pair_cap, ref.row_cap)
    assert outs[0]["ck"] == (ck.pair_cap, ck.row_cap) == (ref.pair_cap, ref.row_cap)
    # Both caps grew, at three boundaries.
    assert len({(p, r) for _, p, r in seen}) == 4
    assert ref.pair_cap > first[0] and ref.row_cap > first[1]


def _rank_capped_dp_vs_single(rank, params, alive, gt, pair_cap, steps):
    from gsplat_tpu_torch.parallel import get_monitored_dp_train_step

    _rank_setup()
    st = dataclasses.replace(_statics(height=40), pair_cap=pair_cap)
    cm = _camera(0, height=40)
    gt = torch.from_numpy(gt)
    out = {}
    for label, fn in (("single", t_step.get_monitored_train_step(st)),
                      ("dp", get_monitored_dp_train_step(st))):
        state, monitor, metrics = _state(params, alive), t_step.fresh_monitor("cpu"), []
        for it in range(steps):
            state, m, monitor = fn(state, cm.view, cm.proj, cm.campos, gt, BG, it, monitor)
            assert all(isinstance(x, torch.Tensor) for x in m)
            metrics.append((m.loss.numpy().tobytes(), int(m.num_pairs), int(m.overflow),
                            int(m.row_overflow), monitor.numpy().tobytes()))
        out[label] = dict(metrics=metrics, state=t_state.state_to_numpy(state))
    return out


@pytest.mark.parametrize("pair_cap", [2048, 512], ids=["above", "below"])
def test_capped_dp_identical_cameras_bit_equal_to_single_step(pair_cap):
    """At 2048 the frame's pairs fit; at 512 the frame needs 1,036 slots
    and the cap drops pairs."""
    params, alive = _scene(n=300, n_cap=320)
    outs = _run(_rank_capped_dp_vs_single, 2, params, alive, _gts(1, height=40)[0], pair_cap,
                2)
    for o in outs:
        single, dp = o["single"], o["dp"]
        assert dp["metrics"] == single["metrics"]
        _, pairs, overflow, _, _ = single["metrics"][0]
        assert (overflow > pair_cap) == (pair_cap == 512) and pairs > 400
        for f in ("params", "adam_m", "adam_v"):
            for name in NAMES:
                np.testing.assert_array_equal(dp["state"][f][name], single["state"][f][name],
                                              err_msg=f"{f}.{name}")
        np.testing.assert_array_equal(dp["state"]["alive"], single["state"]["alive"])
        np.testing.assert_array_equal(dp["state"]["accum_dur"], 2 * single["state"]["accum_dur"])
        np.testing.assert_array_equal(dp["state"]["uv_grad_accum"],
                                      2 * single["state"]["uv_grad_accum"])
    for f in ("params", "adam_m", "adam_v"):
        for name in NAMES:
            np.testing.assert_array_equal(outs[0]["dp"]["state"][f][name],
                                          outs[1]["dp"]["state"][f][name])


def test_parallel_factories_are_kept_per_statics_and_group():
    """One callable a (StepStatics, group) and kind, dropped by
    ``release_graphs``; the tp factory is the tp step's."""
    from gsplat_tpu_torch.parallel import get_monitored_dp_train_step, get_monitored_tp_train_step

    st = _statics()
    st2 = dataclasses.replace(st, pair_cap=512)
    a = get_monitored_dp_train_step(st)
    assert get_monitored_dp_train_step(st) is a
    assert get_monitored_dp_train_step(st2) is not a
    assert get_monitored_tp_train_step(st) is not a
    assert get_monitored_dp_train_step(st, group="other") is not a
    t_step.release_graphs()
    assert get_monitored_dp_train_step(st) is not a
    assert a.monitored and a.step.keywords == {"group": None}
    t_step.release_graphs()
