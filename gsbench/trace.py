"""The traced window: torch.profiler over it, reduced to what the per-layer
readers read.

The device's busy time is the union of every device operation's interval
(kernels, copies, fills) inside the window, never their sum: operations
on two streams overlap. Device operations are split into the port's five
kernel families (``FAMILIES``, by their ``__global__`` names) and the
rest, the glue. The window is the harness's ``gsbench.window`` range on
the profiler's own clock. Idle gaps are named by the innermost host range
of the main thread that covers the gap's middle.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading

import torch

# The port's kernels (``gsplat_tpu_torch/csrc/*.cu``) by family: the
# ``__global__`` names ``chip_smoke.py::port_kernel_names`` (``:1225``)
# reads from the sources, kept here so that the split cannot move.
FAMILIES = {
    "K1": ("rasterize_forward_kernel",),
    "K2": ("rasterize_backward_kernel",),
    "K3": ("radix_histogram", "onesweep_pass"),
    "K4": ("segment_sum_kernel", "segment_sum_packed_kernel"),
    "K5": ("segment_expand_kernel",),
}
_FAMILY_RE = {fam: re.compile(r"\b(?:%s)\b" % "|".join(names)) for fam, names in FAMILIES.items()}
WINDOW = "gsbench.window"
TOP = 10


def family(name: str) -> str | None:
    for fam, rx in _FAMILY_RE.items():
        if rx.search(name):
            return fam
    return None


def _annotation(e) -> bool:
    try:
        return bool(e.is_user_annotation())
    except (AttributeError, RuntimeError):
        return False


def union_seconds(intervals) -> tuple[float, list]:
    """(seconds covered by the union of (start_ns, end_ns) intervals, the
    gaps between them as (start_ns, end_ns))."""
    busy, gaps, end = 0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e9, gaps


@dataclasses.dataclass
class Traced:
    """What the readers read. ``bounds_s`` and ``flops`` are filled in by
    the entry after the window (None where it counts no work)."""

    kind: str  # "train", "trainer" or "render"
    units: int  # iterations or views in the window
    window_s: float
    busy_s: float
    family_s: dict
    glue_s: float
    device_ops: list
    idle_gaps: list
    bounds_s: float | None = None
    flops: float | None = None


@contextlib.contextmanager
def window(enabled: bool):
    """Profile the block when ``enabled``; yields a list that holds the
    profiler afterwards."""
    out = []
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield out
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    out.append(prof)


def reduce(prof, kind: str, units: int) -> Traced:
    events = prof.profiler.kineto_results.events()
    main = threading.get_ident()
    host, device, win = [], [], None
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.name() == WINDOW:
                win = (start, end)
            host.append((start, end, e.name(), e.start_thread_id()))
        elif not (e.name() == WINDOW or _annotation(e)):  # a host range mirrored on the device
            device.append((start, end, e.name()))
    if win is None:
        raise RuntimeError("the trace holds no gsbench.window range")
    lo, hi = win
    device = [(max(s, lo), min(e, hi), n) for s, e, n in device if e > lo and s < hi]
    busy_s, gaps = union_seconds((s, e) for s, e, _ in device)
    fam = {f: 0.0 for f in FAMILIES}
    glue, by_name = 0.0, {}
    for s, e, n in device:
        sec = (e - s) / 1e9
        f = family(n)
        if f is None:
            glue += sec
        else:
            fam[f] += sec
        by_name[n] = by_name.get(n, 0.0) + sec
    first = min((s for s, _, _ in device), default=hi)
    last = max((e for _, e, _ in device), default=lo)
    gaps = [(lo, first)] + gaps + [(last, hi)] if device else []
    # The main thread's host ranges: the profiler records thread ids of its
    # own; take the thread of the window's range.
    tid = next((t for s, e, n, t in host if n == WINDOW), main)
    ranges = [(s, e, n) for s, e, n, t in host if t == tid and n != WINDOW]

    def doing(mid):
        best = None
        for s, e, n in ranges:
            if s <= mid <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        return best[2] if best else "host: no traced range"

    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    idle = [[doing((a + b) // 2), (b - a) / 1e9] for a, b in gaps if b > a]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Traced(kind, units, (hi - lo) / 1e9, busy_s, fam, glue,
                  [[n[:120], s] for n, s in ops], idle)
