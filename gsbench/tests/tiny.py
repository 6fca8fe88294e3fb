"""A copy of the benchmark at a size the CPU runs in seconds: the same
files under a temporary root, each configuration cut to a few thousand
Gaussians and a small image, the traced periods and the trainer's print
and density intervals to a few units."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny_root(dest: Path, n: int = 3000, width: int = 96, height: int = 64) -> Path:
    shutil.copytree(ROOT / "gsbench", dest / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["gaussians"] = n
        cfg["image"].update(width=width, height=height)
        if "caps" in cfg:
            cfg["caps"] = {"pair_cap": 1 << 16, "row_cap": 1 << 15}
        cfg["train"].update(print_interval=4, adaptive_control_interval=4)
        (dest / c["file"]).write_text(json.dumps(cfg))
    for name, change in (("train-step", dict(trace_units=4, monitor_interval=4)),
                         ("render", dict(trace_units=8, sample_span=16, sample=3))):
        path = dest / "gsbench" / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **change}))
    return dest
