"""Port parity: the configuration's ceiling and the garden-scale run
(``tools/bench_scale.py``, ``tools/train_at_scale.py``), on the CPU.

- ``round_capacity`` equals the JAX package's around 2^22 and at
  ``max_gaussians`` 4,250,000, where the capacity stops being a power of
  two (2^22 + 2^21);
- ``grow_state`` of a small state with nonzero moments and accumulators to
  capacity 6,144 (not a power of two) equals JAX's ``grow_state``;
- two ``train_step``s at capacity 6,144 and at 8,192 from the same
  Gaussians: loss and the alive rows of the parameters, moments and
  accumulators bit-equal;
- ``scale_gaussians`` and the target equal the reference script's own
  draws, its statements taken from ``scripts/bench_scale.py`` by ``ast``
  and run at a small N; ``scale_statics`` equals its ``StepStatics``
  without the pair and row caps, chunk and interpret flag;
  ``scale_config`` equals, field for field, JAX's ``parse_config`` of
  ``configs/base.yaml`` with the overrides of ``scripts/train_at_scale.py``
  (taken from it the same way);
- the reference's tile-row count (``row_overflow``: a sentinel row for
  every record without one) is the port's rows plus those records;
- ``bench_scale.run`` at 3,000 Gaussians and 64x40: finite loss, pairs and
  tile rows;
- ``train_at_scale.run`` shrunk to 8 views at 96x64 and 80 iterations with
  an opacity reset at 2, SH bands at 20, 40 and 60 and a density step at
  40: the eval PSNR rises, the PLY holds the alive Gaussians and the
  checkpoint reloads bit-identical. 80, not 40: after a reset to 0.05 the
  opacities take more than 40 iterations to regain the initial 0.2 at the
  base learning rate. ``main``'s arguments reach ``run``.
"""

import ast
import dataclasses
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gsplat_tpu import config as j_config  # noqa: E402
from gsplat_tpu.ops.camera import build_camera_matrices as j_build_camera  # noqa: E402
from gsplat_tpu.train import state as j_state  # noqa: E402
from gsplat_tpu.train.init import GaussianData as JGaussianData  # noqa: E402
from gsplat_tpu_torch.io.ply import load_ply  # noqa: E402
from gsplat_tpu_torch.tools import bench_scale, train_at_scale  # noqa: E402
from gsplat_tpu_torch.train import state as t_state  # noqa: E402
from gsplat_tpu_torch.train import trainer as t_trainer  # noqa: E402
from gsplat_tpu_torch.train.step import train_step  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def two_threads():
    """Two intra-op threads: the test shares the host with the other test
    workers, and torch's default of every core per worker makes them wait
    on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [(1 << 22) - 1, 1 << 22, (1 << 22) + 1, 4_250_000,
                               (1 << 22) + (1 << 21) + 1])
def test_round_capacity_equal_jax(n):
    assert t_state.round_capacity(n) == j_state.round_capacity(n)
    if n == 4_250_000:
        assert t_state.round_capacity(n) == (1 << 22) + (1 << 21) == 6_291_456


def _random_gaussians(n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        rgb=rng.normal(size=(n, 3)).astype(np.float32),
        opacity=rng.normal(size=n).astype(np.float32),
        scale=rng.normal(size=(n, 3)).astype(np.float32),
        quaternion=rng.normal(size=(n, 4)).astype(np.float32),
        sh=rng.normal(size=(n, 15, 3)).astype(np.float32),
    )


def test_grow_state_to_non_power_of_two_equal_jax():
    cols = _random_gaussians(3000, 0)
    j = j_state.init_state(JGaussianData(**cols), n_cap=4096)
    t = t_state.state_from_gaussians(t_state.GaussianData(**cols), "cpu", n_cap=4096)
    rng = np.random.default_rng(1)
    moments = {k: {name: rng.normal(size=v.shape).astype(np.float32)
                   for name, v in j.params.items()} for k in ("adam_m", "adam_v")}
    accum = rng.uniform(size=4096).astype(np.float32)
    dur = rng.integers(0, 50, 4096).astype(np.int32)
    j = j._replace(adam_m={k: jnp.asarray(v) for k, v in moments["adam_m"].items()},
                   adam_v={k: jnp.asarray(v) for k, v in moments["adam_v"].items()},
                   uv_grad_accum=jnp.asarray(accum), accum_dur=jnp.asarray(dur))
    for k in ("adam_m", "adam_v"):
        for name, v in moments[k].items():
            getattr(t, k)[name].copy_(torch.from_numpy(v))
    t.uv_grad_accum.copy_(torch.from_numpy(accum))
    t.accum_dur.copy_(torch.from_numpy(dur))
    j_big, t_big = j_state.grow_state(j, 6144), t_state.grow_state(t, 6144)
    assert t_big.capacity == 6144 and t_state.grow_state(t_big, 6144) is t_big
    got = t_state.state_to_numpy(t_big)
    for group in ("params", "adam_m", "adam_v"):
        for name, ref in getattr(j_big, group).items():
            assert got[group][name].shape[0] == 6144
            np.testing.assert_array_equal(got[group][name], np.asarray(ref),
                                          err_msg=f"{group} {name}")
    for name in ("alive", "uv_grad_accum", "accum_dur"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(j_big, name)),
                                      err_msg=name)


def test_train_step_capacity_6144_equals_8192(two_threads):
    """The capacity's padding rows change nothing in the alive rows: the
    same Gaussians at 6,144 (2^12 + 2^11) and at 8,192 train bit-equal."""
    g = bench_scale.scale_gaussians(5000, 0.5, seed=4)
    g.sh = 0.1 * np.random.default_rng(5).normal(size=(5000, 15, 3)).astype(np.float32)
    st = bench_scale.scale_statics(64, 40, pair_cap=0, row_cap=0)  # sized exactly
    cm = bench_scale.scale_camera(64, 40)
    gt = torch.from_numpy(np.random.default_rng(6).uniform(size=(40, 64, 3)).astype(np.float32))
    runs = []
    for cap in (6144, 8192):
        state = t_state.state_from_gaussians(g, "cpu", n_cap=cap)
        losses = []
        for it in range(2):
            state, m = train_step(state, cm.view, cm.proj, cm.campos, gt, 0.0, it, st)
            losses.append(m.loss.item())
            assert m.num_pairs > 0
        runs.append((losses, t_state.state_to_numpy(state)))
    (l_a, a), (l_b, b) = runs
    assert l_a == l_b and all(math.isfinite(x) for x in l_a)
    n = 5000
    for group in ("params", "adam_m", "adam_v"):
        for name in a[group]:
            np.testing.assert_array_equal(a[group][name][:n], b[group][name][:n],
                                          err_msg=f"{group} {name}")
    for name in ("alive", "uv_grad_accum", "accum_dur"):
        np.testing.assert_array_equal(a[name][:n], b[name][:n], err_msg=name)
    assert a["alive"].sum() == b["alive"].sum() == n


def _script(name):
    return ast.parse((REPO / "scripts" / name).read_text())


def _assigned(tree, target):
    """The module-level statement that assigns ``target``."""
    return next(node for node in tree.body if isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == target for t in node.targets))


def _run_statements(nodes, namespace):
    exec(compile(ast.Module(body=list(nodes), type_ignores=[]), "<script>", "exec"), namespace)
    return namespace


@pytest.mark.parametrize("scale_mul", [0.97, 1.52])
def test_scale_gaussians_equal_script_draws(scale_mul):
    tree = _script("bench_scale.py")
    n, w, h = 2000, 40, 24
    ns = _run_statements([_assigned(tree, "rng"), _assigned(tree, "g"), _assigned(tree, "gt")],
                         dict(np=np, N=n, SCALE_MUL=scale_mul, W=w, H=h,
                              GaussianData=JGaussianData, jnp=SimpleNamespace(asarray=np.asarray)))
    rng = np.random.default_rng(0)
    got = bench_scale.scale_gaussians(n, scale_mul, rng=rng)
    for ours, theirs in (("xyz", "xyz"), ("rgb", "rgb"), ("opacity", "opacity"),
                         ("scale", "scale"), ("quaternion", "quaternion")):
        a, b = getattr(got, ours), getattr(ns["g"], theirs)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=ours)
    np.testing.assert_array_equal(rng.uniform(0, 1, (h, w, 3)).astype(np.float32), ns["gt"])
    again = bench_scale.scale_gaussians(n, scale_mul, seed=0)
    np.testing.assert_array_equal(again.scale, got.scale)


def test_scale_statics_equal_script():
    tree = _script("bench_scale.py")
    w, h = 1296, 840
    ns = _run_statements([_assigned(tree, "cm")],
                         dict(np=np, W=w, H=h, build_camera_matrices=j_build_camera))
    call = _assigned(tree, "st").value
    ns.update(PAIR_CAP=31 * (1 << 19))  # the script's default
    want = {k.arg: eval(compile(ast.Expression(k.value), "<script>", "eval"), ns)
            for k in call.keywords}
    for dropped in ("chunk", "interpret"):
        want.pop(dropped)
    assert dataclasses.asdict(bench_scale.scale_statics(w, h)) == want
    cm = bench_scale.scale_camera(w, h)
    for f in ("view", "proj", "campos"):
        np.testing.assert_array_equal(getattr(cm, f), getattr(ns["cm"], f))


@pytest.mark.parametrize("iters", [2000, 40])
def test_scale_config_equal_jax(iters, tmp_path):
    tree = _script("train_at_scale.py")
    call = next(node for node in ast.walk(tree) if isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute) and node.func.attr == "replace")
    ns = dict(ITERS=iters, tmp=tmp_path)
    overrides = {k.arg: eval(compile(ast.Expression(k.value), "<script>", "eval"), ns)
                 for k in call.keywords}
    ref = dataclasses.replace(j_config.parse_config(REPO / "configs" / "base.yaml"), **overrides)
    got = train_at_scale.scale_config(iters, tmp_path / "out")
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_reference_row_count_equal_jax():
    """The reference's ``row_overflow`` counts a sentinel row for every
    record without a tile row: the port's rows plus those records, at
    tests/test_torch_binning.py's masked 32x32 geometry (its compile)."""
    from test_render import _make_scene

    from gsplat_tpu.ops import binning as j_binning
    from gsplat_tpu.ops.render import pack_attrs as j_pack_attrs
    from gsplat_tpu_torch.ops import binning

    n = 10
    uv, conic, radius, z, opa, rgb = _make_scene(np.random.default_rng(0), n, 32, 32)
    mask = np.ones(n, bool)
    mask[1::2] = False
    attrs = j_pack_attrs(jnp.asarray(uv), jnp.asarray(conic), jnp.asarray(rgb),
                         jnp.asarray(opa))
    ref = j_binning.build_tile_tables(
        jnp.asarray(uv), jnp.asarray(z), jnp.asarray(radius), jnp.asarray(mask), attrs=attrs,
        num_tiles_x=2, num_tiles_y=2, tile_size=16, pair_cap=4096, chunk_size=128,
        bf16_colors=False, interpret=True)
    _, _, off, total = binning.row_expand_inputs(
        *(torch.from_numpy(a) for a in (uv, z, radius, mask)), num_tiles_x=2, num_tiles_y=2,
        tile_size=16)
    rows, with_rows = bench_scale.row_totals(off, total)
    assert 0 < with_rows < n and rows > with_rows
    assert rows + n - with_rows == int(ref.row_overflow)


def test_bench_scale_run_small(two_threads):
    res = bench_scale.run(3000, 0.97, steps=1, reps=2, width=64, height=40, device="cpu",
                          pair_cap=16384, row_cap=12288, log=lambda *a: None)
    assert res.capacity == 4096 and res.state.capacity == 4096
    assert res.loss_finite and res.pairs > 0 and res.rows > 0 and len(res.step_ms) == 2
    assert res.peak_mib is None
    assert res.rows + res.capacity - res.row_gaussians == res.reference_rows > res.rows
    summary = res.summary()
    assert summary["n_cap"] == 4096 and summary["num_pairs"] == res.last_pairs > 0
    assert summary["first_pairs"] == res.pairs
    # the reference's requirements, sentinels counted, within the caps
    assert res.pairs < res.overflow <= 16384 and res.row_overflow == res.reference_rows


def test_train_at_scale_shrunk_raises_psnr(tmp_path, monkeypatch, two_threads):
    resets = []
    real_reset = t_trainer.reset_opacity

    def reset(state, value):
        resets.append(value)
        return real_reset(state, value)

    monkeypatch.setattr(t_trainer, "reset_opacity", reset)
    schedule = dict(adaptive_control_start=30, adaptive_control_interval=10,
                    adaptive_control_end=45, reset_opacity_start=1, reset_opacity_interval=2,
                    reset_opacity_end=3, add_sh_band_interval=20, print_interval=20,
                    test_eval_interval=20)
    res = train_at_scale.run(80, 96, 64, root=tmp_path, device="cpu", n_views=8,
                             n_gaussians=300, n_points=1000, overrides=schedule,
                             log=lambda *a: None)
    assert math.isfinite(res.psnr_init) and math.isfinite(res.psnr_final)
    assert res.psnr_final > res.psnr_init + 1.0
    assert [d.iteration for d in res.density] == [40] and res.density[0].applied
    assert resets == [0.05] and res.l_max == 3
    assert res.capacities == [4096] and res.gaussians_final == res.density[0].new_total
    assert load_ply(res.ply)["xyz"].shape[0] == res.gaussians_final
    fresh = t_trainer.Trainer(res.trainer.config, res.gaussians, res.trainer.images,
                              res.trainer.cameras, device="cpu")
    fresh.load_checkpoint(res.checkpoint)
    assert fresh.iter == 80 and fresh.l_max == 3
    a, b = t_state.state_to_numpy(fresh.state), t_state.state_to_numpy(res.trainer.state)
    for group in ("params", "adam_m", "adam_v"):
        for name in a[group]:
            np.testing.assert_array_equal(a[group][name], b[group][name])
    for name in ("alive", "uv_grad_accum", "accum_dur"):
        np.testing.assert_array_equal(a[name], b[name])
    summary = res.summary()
    assert summary["density"][0][0] == 40 and summary["capacities"] == [4096]


def test_train_at_scale_main_arguments(monkeypatch, capsys, tmp_path):
    seen = []

    def fake_run(iters, width, height, *, root, device, verbose):
        seen.append((iters, width, height, Path(root), device, verbose))
        return SimpleNamespace(summary=lambda: {"iters": iters})

    monkeypatch.setattr(train_at_scale, "run", fake_run)
    assert train_at_scale.main(["12", "320", "200", "--out", str(tmp_path)], device="cpu") == 0
    assert train_at_scale.main([], device="cpu") == 0
    assert seen[0] == (12, 320, 200, tmp_path, "cpu", True)
    assert seen[1][:3] == (2000, 1296, 840) and not seen[1][3].exists()
    assert 'RESULT {"iters": 12}' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train_at_scale.main(["12", "320"], device="cpu")
