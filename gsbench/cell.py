"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix. The
configuration's file is the one it gives; the traffic mix is
``gsbench/traffic/<traffic>.json``, whose ``entry`` names the driver
``gsbench/entries/<entry>.py``; the comparison's limits are
``gsbench/limits/<workload>.json``; each metric's reader is
``gsbench/metrics/<metric>.py``, with ``read(outcome)`` returning a number
or None. A new cell, mix or metric is new files and entries: nothing here
changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    entry: object
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list


def load_module(path: Path):
    name = "gsbench._by_name." + re.sub(r"\W", "_", str(path))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def metrics_of(bench: dict, workload: str, kind: str) -> list:
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def reader(name: str, root: Path = ROOT):
    return load_module(root / "gsbench" / "metrics" / f"{name}.py")


def resolve(workload: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    pkg = root / "gsbench"
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    traffic = _json(pkg / "traffic" / f"{w['traffic']}.json")
    return Cell(
        workload=w,
        config=_json(root / cfg["file"]),
        traffic=traffic,
        limits=_json(pkg / "limits" / f"{workload}.json"),
        entry=load_module(pkg / "entries" / f"{traffic['entry']}.py"),
        end_to_end=metrics_of(bench, workload, "end_to_end"),
        per_layer=metrics_of(bench, workload, "per_layer"),
    )
