"""Reading the program's own tracer (``gsplat_tpu_torch.utils.profiling``)
after the traced window: its spans, what it counted while it traced, and
its stage clock's times on the card.

The tracer records only while torch.profiler records, which in a run is
the traced window, so the spans and counts it holds are the window's. The
stage clock keeps every call's stamps; the window's calls are those whose
``<kind>.issue`` span the window holds, each carrying its slot. Every
reader returns None in an untraced run, in another cell, and with a
program that has no tracer.
"""

from __future__ import annotations

import statistics


def store():
    """The program's tracer module, or None where the program has none."""
    try:
        from gsplat_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "stage_times") else None


def _traced(out, kind: str):
    t = getattr(out, "traced", None)
    return t if t is not None and t.kind == kind and t.units else None


def span_ms_per_unit(out, kind: str, name: str) -> float | None:
    """Milliseconds spent in spans ``name`` over the window's units."""
    t, s = _traced(out, kind), store()
    if t is None or s is None:
        return None
    return sum(x.end_ns - x.start_ns for x in s.spans() if x.name == name) / 1e6 / t.units


def span_ms_mean(out, kind: str, name: str) -> float | None:
    """The mean milliseconds of one span ``name`` (None without one)."""
    t, s = _traced(out, kind), store()
    if t is None or s is None:
        return None
    ms = [(x.end_ns - x.start_ns) / 1e6 for x in s.spans() if x.name == name]
    return sum(ms) / len(ms) if ms else None


def counted(out, kind: str, names: tuple) -> int | None:
    """The sum of the counters ``names`` while the window traced."""
    t, s = _traced(out, kind), store()
    if t is None or s is None:
        return None
    got = s.counters()
    return sum(got.get(n, 0) for n in names)


def stage_ms(out, kind: str, clock: str, stage: str) -> float | None:
    """The median milliseconds of ``stage`` on the card over the window's
    calls of the stage clock ``clock`` (None without a device)."""
    t, s = _traced(out, kind), store()
    if t is None or s is None or t.busy_s <= 0:
        return None
    slots = [x.slot for x in s.spans() if x.name == f"{clock}.issue" and x.slot is not None]
    times = s.stage_times(clock) if slots else {}
    ms = [times[k][stage] for k in slots if k in times]
    return statistics.median(ms) if ms else None
