"""Every part of ``BENCHMARK.json`` resolves by name, the file keeps to the
contract's shapes, and a cell added as new files is found with no file of
the benchmark edited."""

import hashlib
import json
import re
import shutil

import pytest

from gsbench import cell as cells
from tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
NUMBERS = {"train_step": {"loss_gap", "grad_gap", "change_gap"},
           "trainer": {"loss_gap", "grad_gap", "change_gap", "density_count_gap",
                       "density_norm_gap", "morton_unsorted"},
           "render": {"image_mae", "pixels_off"}}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    c = cells.resolve(workload)
    assert callable(c.entry.measure) and callable(c.entry.calibrate)
    assert set(c.limits) == NUMBERS[c.traffic["entry"]]
    assert all(v > 0 for k, v in c.limits.items() if k != "morton_unsorted")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(cells.reader(m["name"]).read)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(cells.reader(metric).read)


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gsbench"] and BENCH["command"][:2] == ["python3", "-m"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("gsbench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["source"]) <= 200
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200 and "\n" not in w["why"]
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        for w in m["workloads"]:  # each listed cell reports what the metric moves
            assert w in e2e[m["moves"]].get("workloads", [w])
    assert len(json.dumps(BENCH)) < 64 * 1024


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "gsbench").rglob("*")) if p.is_file()}


def test_a_cell_added_as_files_only_is_found(tmp_path):
    shutil.copytree(ROOT / "gsbench", tmp_path / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    g = tmp_path / "gsbench"
    cfg = json.loads((ROOT / "gsbench/configs/garden-ds4-1m.json").read_text())
    cfg.update(name="garden-ds4-250k", gaussians=250_000)
    (g / "configs" / "garden-ds4-250k.json").write_text(json.dumps(cfg))
    traffic = json.loads((g / "traffic" / "render.json").read_text())
    (g / "traffic" / "render-far.json").write_text(json.dumps({**traffic, "between": 2}))
    (g / "limits" / "render-far.garden-ds4-250k.json").write_text(
        (g / "limits" / "render.garden-ds4-1m.json").read_text())
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(BENCH["configs"][0], name="garden-ds4-250k",
                                 file="gsbench/configs/garden-ds4-250k.json"))
    bench["workloads"].append(dict(name="render-far.garden-ds4-250k", config="garden-ds4-250k",
                                   traffic="render-far", chips=1, why="a test cell"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "render.garden-ds4-1m" in m.get("workloads", []):
            m["workloads"].append("render-far.garden-ds4-250k")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = cells.resolve("render-far.garden-ds4-250k", tmp_path)
    assert c.config["gaussians"] == 250_000 and c.traffic["between"] == 2
    assert c.entry.measure.__module__.startswith("gsbench._by_name.")
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "render_ms_per_view",
                                                 "render_p95_ms"}
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
