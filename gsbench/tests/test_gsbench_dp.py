"""The data-parallel cell on the CPU: four gloo ranks at a tiny size.

``correct`` is false under the precision control, under the half-image
fault, and with a fault planted in rank 0's program (its Adam update
skipped: its first steps leave the reference and its replica the
others'). The watchdog ends a run as soon as a rank exits with a fault,
or when rank 0 falls silent; a rank that exits cleanly is no fault."""

import importlib
import json
import subprocess
import sys
import time

import pytest
import torch

from gsbench import cell as cells
from gsbench import harness, run
from tiny import tiny_root

WORKLOAD = "dp-step.garden-ds4-1m-dp4"
CPU = torch.device("cpu")
dp_step = importlib.import_module("gsbench.entries.dp_step")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("tiny"))
    path = root / "gsbench" / "traffic" / "dp-step.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "monitor_interval": 2,
                                "trace_units": 2}))
    return root


def test_the_controls_are_not_correct(root):
    c = cells.resolve(WORKLOAD, root)
    r = harness.Run(WORKLOAD, c.config, c.traffic, 13, 0.2, False, CPU, 0.0)
    res = c.entry.calibrate(r, ["control", "half"])
    for mode in ("control", "half"):
        assert not harness.judge(res[mode], c.limits)[0], res


def _unchanged(state, *args, **kw):
    return state


def test_a_fault_in_rank_0_is_not_correct(root, monkeypatch):
    monkeypatch.setattr(importlib.import_module("gsplat_tpu_torch.parallel.data_parallel"),
                        "apply_adam", _unchanged)
    line = run.run(WORKLOAD, 99, 0.2, False, device="cpu", root=root)
    assert not line["correct"], line["checks"]
    assert line["checks"]["replica_gap"]["value"] > 0


def _child(code: int, after_s: float):
    return subprocess.Popen([sys.executable, "-c",
                             f"import sys, time; time.sleep({after_s}); sys.exit({code})"])


@pytest.mark.parametrize("code", [3, -9])
def test_the_watchdog_ends_a_run_whose_rank_fails(code):
    procs = [_child(0, 0.0), _child(code, 0.5)]
    reasons = []
    dog = dp_step.Watchdog([p.poll for p in procs], 60.0, reasons.append)
    t0 = time.monotonic()
    dog.start()
    dog.join(timeout=10)
    assert not dog.is_alive() and time.monotonic() - t0 < 5
    assert reasons == [f"rank 2 exited with code {procs[1].returncode}"]


def test_the_watchdog_ends_a_silent_run_and_not_a_beating_one():
    reasons = []
    dog = dp_step.Watchdog([lambda: None], 1.0, reasons.append)
    dog.start()
    for _ in range(8):  # beats for 1.6 s, twice the silence allowed
        time.sleep(0.2)
        dog.beat()
    assert dog.is_alive() and reasons == []
    dog.join(timeout=5)
    assert reasons == ["rank 0 made no progress for 1 s"]
