"""Tracing and profiling hooks (port of ``gsplat_tpu/utils/profiling.py``).

``StageTimers`` sums wall-clock time per named stage; a stage given
``block_on`` waits for the device of those tensors before it stops the
clock, so the time covers the work it queued. ``device_trace`` records a
``torch.profiler`` trace (host and, with a card, CUDA activity) and writes
it as a Chrome trace into a directory: open it in Perfetto or
``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path

import torch


def _synchronize(tensors) -> None:
    """Wait for the CUDA devices that hold ``tensors`` (a tensor, or a
    list, tuple or dict of them); CPU tensors need no wait."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    elif isinstance(tensors, dict):
        tensors = list(tensors.values())
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class StageTimers:
    """Per-stage wall-clock sums, the stage's device work included."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(
                f"{name:24s} {tot:8.3f}s total  {1e3 * tot / max(n, 1):8.2f}ms/call  x{n}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str | Path):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a card
    is present) and write ``<logdir>/trace_<pid>_<ns>.json``, a Chrome
    trace. Yields the profiler; its ``trace_path`` is set on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's device work ends inside the trace
    path = logdir / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    prof.trace_path = path
