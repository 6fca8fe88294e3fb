"""Run one cell of the port's benchmark and print its result line.

    python3 -m gsbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. The cell
(``BENCHMARK.json``'s ``workloads``) names its configuration and traffic
mix; ``cell.resolve`` finds their files, the entry that drives the
program, the comparison's limits and the metrics' readers. The run builds
its inputs from the seed, sets the program up (``setup_s``: from the
process's start to the first timed iteration), measures for ``--seconds``
(``--trace 1``: one traced period of the traffic's ``trace_units`` under
torch.profiler), then compares what the window produced with the plain
reference and prints each compared number beside its limit on standard
error, and the result as the last line of standard output.

Exits with 2, printing no result, without enough CUDA devices; with 3 if
a JAX module is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from gsbench import cell as cells

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".gsbench_cache"  # fixed, inside the checkout: a second run finds it
FORBIDDEN = ("jax", "jaxlib", "flax", "gsplat_tpu")


def process_start() -> float:
    """``time.perf_counter()`` at this process's start (Linux: from
    /proc; else now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def set_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
        (CACHE / sub).mkdir(parents=True, exist_ok=True)


def jax_loaded() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0].split(",")[-1].strip() if out else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def result_line(c, r, out, correct: bool, checks: dict, root: Path = ROOT) -> dict:
    import torch

    wanted = c.per_layer if r.trace else c.end_to_end
    metrics = {}
    for m in wanted:
        value = cells.reader(m["name"], root).read(out)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    cuda = r.device.type == "cuda"
    device = dict(platform="gpu" if cuda else "cpu",
                  kind=torch.cuda.get_device_name(r.device) if cuda else "cpu",
                  count=c.workload["chips"], memory_peak_bytes=out.memory_peak_bytes,
                  power_limit=power_limit() if cuda else "none")
    line = dict(correct=correct, attempted=out.attempted, failed=out.failed, metrics=metrics,
                device=device)
    if out.traced is not None:
        device.update(busy_s=out.traced.busy_s, window_s=out.traced.window_s)
        line["breakdown"] = dict(device_ops=out.traced.device_ops,
                                 idle_gaps=out.traced.idle_gaps)
    line["phases"] = out.phases
    line["checks"] = checks
    return line


def run(workload: str, seed: int, seconds: float, trace: bool, device=None,
        root: Path = ROOT, started: float | None = None) -> dict:
    """Measure one cell; returns its result line (a dict). ``device``
    None: the first CUDA device, which must exist."""
    import torch

    from gsbench import harness
    from gsbench.reference.gaussians import full_f32

    started = process_start() if started is None else started
    c = cells.resolve(workload, root)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < c.workload["chips"]:
            raise SystemExit(2)
        device = torch.device("cuda", 0)
    full_f32()
    device = torch.device(device)
    if device.type == "cuda":
        torch.zeros(1, device=device)
    r = harness.Run(workload=workload, config=c.config, traffic=c.traffic, seed=seed,
                    seconds=seconds, trace=trace, device=device, started=started)
    r.phases.mark("process start to the CUDA context")
    out = c.entry.measure(r)
    correct, checks = harness.judge(out.numbers, c.limits)
    return result_line(c, r, out, correct, checks, root)


def main(argv=None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(prog="python3 -m gsbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_caches()
    import torch

    if not torch.cuda.is_available():
        print("gsbench: no CUDA device", file=sys.stderr)
        return 2
    c = cells.resolve(args.workload)
    if torch.cuda.device_count() < c.workload["chips"]:
        print(f"gsbench: {args.workload} needs {c.workload['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    line = run(args.workload, args.seed, args.seconds, bool(args.trace), started=started)
    found = jax_loaded()
    if found:
        print(f"gsbench: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    print("setup_s parts: " + ", ".join(f"{k} {v:.3f} s" for k, v in line["phases"].items()),
          file=sys.stderr)
    del line["phases"]
    for name, chk in line["checks"].items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r} "
              f"{'ok' if chk['value'] <= chk['limit'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
