"""The Mip-Splatting cell (``mip-step.garden-ds4-1m-mip``) at the tiny CPU
size: sound runs are correct, the precision control and each fault are
not; every per-layer metric is either listed for its cells or read by
every cell; the cell's two readers return None where the program has no
``mip.*`` span or sweep kernel."""

import importlib
import json

import pytest
import torch

from gsbench import cell as cells
from gsbench import harness, run, trace
from tiny import ROOT, tiny_root

torch.set_num_threads(4)
CELL = "mip-step.garden-ds4-1m-mip"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """``tiny_root`` with the Mip cell's window and sweep cadence cut to 4."""
    dest = tiny_root(tmp_path_factory.mktemp("tiny_mip"))
    path = dest / "gsbench/traffic/mip-step.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "trace_units": 4,
                                "monitor_interval": 4}))
    path = dest / "gsbench/configs/garden-ds4-1m-mip.json"
    cfg = json.loads(path.read_text())
    cfg["mip"]["filter_interval"] = 4
    path.write_text(json.dumps(cfg))
    return dest


@pytest.mark.parametrize("traced", [False, True])
def test_sound_runs_are_correct(root, traced):
    line = run.run(CELL, 2**31 + 7, 0.2, traced, device="cpu", root=root)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap", "filter3d_gap"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert ("train_ms_per_iter" in line["metrics"]) != traced


@pytest.mark.parametrize("mode", ["control", "half", "no3d", "dilate"])
def test_the_control_and_each_fault_are_not_correct(root, mode):
    c = cells.resolve(CELL, root)
    r = harness.Run(CELL, c.config, c.traffic, 11, 0.2, False, torch.device("cpu"), 0.0)
    res = c.entry.calibrate(r, [mode])
    assert not harness.judge(res[mode], c.limits)[0], res


def _no_sweep(params, cameras):
    return None


def test_a_program_that_never_sweeps_is_not_correct(root, monkeypatch):
    mip = importlib.import_module("gsplat_tpu_torch.ops.mip")
    monkeypatch.setattr(mip, "update_filter_3d_", _no_sweep)
    line = run.run(CELL, 99, 0.2, False, device="cpu", root=root)
    assert not line["correct"] and line["checks"]["filter3d_gap"]["value"] == 1.0


def test_every_per_layer_metric_is_listed_or_read_everywhere():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells_of = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        if "workloads" in m:
            assert set(m["workloads"]) <= cells_of, m["name"]
        else:  # read in every cell that reports what it moves
            assert set(e2e[m["moves"]].get("workloads", cells_of)) <= cells_of, m["name"]


def test_the_readers_give_none_without_the_sweep():
    """A traced train outcome whose program holds no ``mip.filter3d`` span
    and whose trace holds no sweep kernel, as every other cell's and the
    parent program's."""
    from gsplat_tpu_torch.utils import profiling

    profiling.clear()
    traced = trace.Traced("train", 4, 1.0, 0.5, {f: 0.1 for f in trace.FAMILIES}, 0.3, [], [])
    out = harness.Outcome(kind="train", setup_s=1.0, window_s=1.0, units=4, attempted=4,
                          failed=0, numbers={}, traced=traced)
    for name in ("filter3d_ms.mip", "filter3d_roofline_pct.mip"):
        assert cells.reader(name).read(out) is None
    traced.filter3d_kernel_s, traced.filter3d_bound_s = None, 1e-4
    assert cells.reader("filter3d_roofline_pct.mip").read(out) is None
    traced.filter3d_kernel_s = 2e-4
    assert cells.reader("filter3d_roofline_pct.mip").read(out) == pytest.approx(50.0)
