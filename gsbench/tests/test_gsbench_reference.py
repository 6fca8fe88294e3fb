"""The reference against the port's CPU path, and ``correct`` as a run
decides it: true on sound runs of every cell, false under the precision
control and under each fault a cell can have, planted in the program."""

import importlib
import json
import subprocess
import sys

import pytest
import torch

from gsbench import cell as cells
from gsbench import harness, run, scene
from gsbench.reference import step as ref
from tiny import ROOT, tiny_root

torch.set_num_threads(4)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")
_REAL_RENDER = importlib.import_module("gsplat_tpu_torch.train.step").render_image


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _statics():
    cfg = json.loads((ROOT / "gsbench/configs/garden-ds4-1m.json").read_text())
    cam = scene.cameras(scene.training_angles(8), 80, 56, 68.0)[1]
    return cam, harness.ref_statics(cfg, cam, 3, 1.65)


def test_reference_equals_the_port_on_the_cpu():
    from gsplat_tpu_torch.train.state import GaussianParams, init_state
    from gsplat_tpu_torch.train.step import render_image, train_step

    cam, rst = _statics()
    params, alive = scene.gaussians(2000, 7, CPU)
    gp = GaussianParams(alive.shape[0], device="cpu")
    with torch.no_grad():
        for k in ref.PARAMS:
            getattr(gp, k).copy_(params[k])
        gp.alive.copy_(alive)
    cam_t = harness.cam_tensors(cam, CPU)
    st = harness.program_statics(rst, 0, 0)
    want = ref.render(params, alive, *cam_t, 0.3, rst)
    got = render_image(gp, *cam_t, 0.3, st)[0]
    assert torch.equal(got, want)
    gt = torch.rand(want.shape, generator=torch.Generator().manual_seed(1))
    state, s = init_state(gp), ref.State.fresh(params, alive)
    for it in (3001, 3002):
        loss = ref.train_step(s, *cam_t, gt, 0.5, it, rst)
        state, m = train_step(state, *cam_t, gt, 0.5, it, st)
        assert float(m.loss) == pytest.approx(loss, rel=1e-6)
    for k in ref.PARAMS:
        torch.testing.assert_close(getattr(state.params, k).detach(), s.params[k],
                                   rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(state.adam_m[k], s.m[k], rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("traced", [False, True])
def test_sound_runs_are_correct(root, workload, traced):
    line = run.run(workload, 2**31 + 5, 0.2, traced, device="cpu", root=root)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["attempted"] > 0 and line["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert ("setup_s" in line["metrics"]) != traced


def _numbers(root, workload, modes, seed=11):
    c = cells.resolve(workload, root)
    r = harness.Run(workload, c.config, c.traffic, seed, 0.2, False, CPU, 0.0)
    return c, c.entry.calibrate(r, modes)


@pytest.mark.parametrize("workload", ["train-step.garden-ds4-1m", "trainer.garden-ds4-1m",
                                      "render.garden-ds4-1m"])
def test_the_precision_control_is_not_correct(root, workload):
    c, res = _numbers(root, workload, ["control"])
    assert not harness.judge(res["control"], c.limits)[0], res


@pytest.mark.parametrize("workload", ["train-step.garden-ds4-1m", "trainer.garden-ds4-1m"])
def test_half_the_batch_in_the_reference_is_not_correct(root, workload):
    c, res = _numbers(root, workload, ["half"])
    assert not harness.judge(res["half"], c.limits)[0], res


def _unchanged(state, *args, **kw):
    return state


def _half_loss(pred, gt, w):
    from gsplat_tpu_torch.ops.loss import fused_loss

    h = pred.shape[0] // 2
    return fused_loss(pred[:h], gt[:h], w)


def _shifted_render(*args, **kw):
    image, tables = _REAL_RENDER(*args, **kw)
    return image + 1.0 / 255.0, tables


def _no_split(state, ds, *noise):
    import dataclasses

    from gsplat_tpu_torch.train.density import adaptive_density_step

    return adaptive_density_step(state, dataclasses.replace(ds, use_split=False), *noise)


def _unsorted(state):
    return state


@pytest.mark.parametrize("workload,name,fault", [
    ("train-step.garden-ds4-1m", "step.apply_adam", _unchanged),
    ("train-step.garden-ds4-1m", "step.fused_loss", _half_loss),
    ("trainer.garden-ds4-1m", "step.apply_adam", _unchanged),
    ("trainer.garden-ds4-1m", "step.fused_loss", _half_loss),
    ("trainer.garden-ds4-1m", "trainer.adaptive_density_step", _no_split),
    ("trainer.garden-ds4-1m", "trainer.morton_sort", _unsorted),
    ("render.garden-ds4-1m", "step.render_image", _shifted_render),
])
def test_a_fault_in_the_timed_path_is_not_correct(root, monkeypatch, workload, name, fault):
    module, attr = name.split(".")
    monkeypatch.setattr(importlib.import_module(f"gsplat_tpu_torch.train.{module}"), attr, fault)
    line = run.run(workload, 99, 0.2, False, device="cpu", root=root)
    assert not line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, "-m", "gsbench.run", "--workload", workload,
                           "--seed", "4242424242", "--seconds", "3", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.splitlines()[-1])["correct"]
