"""The port's tracer: host spans, counters and a stage clock on the device
(port of ``gsplat_tpu/utils/profiling.py``, grown into the one place the
port records what it does).

**Spans.** ``span(name)`` is a ``with`` block that records its name, start
and end (``time.time_ns()``, the clock of torch.profiler's events), its
parent span (the innermost span open on its thread, or the one given) and
its thread. Tracing is on while a torch.profiler session records
(``device_trace``, or any other profiler): then a span also opens a
``record_function`` of its own name, so the profiler's trace shows it.
While no profiler records, a span is one flag read and a shared no-op
object, and records nothing. ``spans()`` returns the recorded spans,
``clear()`` drops them.

**Counters.** ``count(name)`` adds to a plain integer: ``counter(name)``
is its total in this process; ``counters()`` holds what was counted while
tracing was on, since the last ``clear()``.

**The stage clock.** ``stage_clock(kind, device)`` around one call of the
train step (kind ``"step"``), the data-parallel step (``"dp"``: the step's
stages with ``allreduce`` before ``adam``), the render (``"render"``) or
Mip-Splatting's 3D-filter sweep (``"mip"``: one stage, ``filter3d``; its
call is the span ``mip.filter3d``, ``ops/mip.py::update_filter_3d_``)
stamps the call's start, each ``stage_done(stage)`` inside it stamps the
end of a stage, and its exit stamps the end of the last stage and advances
the clock's slot. On the card a stamp is a one-thread kernel
(``csrc/stamp.cu``) that reads ``%globaltimer`` into a device ring at
(slot mod ``RING``, stamp); on the CPU it writes ``time.time_ns()`` into a
CPU ring. The stamps sit on the stream, so a CUDA graph captures them and
each replay stamps with no host work; they write nothing the call reads.
``stage_times(kind)`` synchronises and returns each stage's milliseconds
for every call since the last ``clear()``, by slot. The rings belong to
the tracer, not to a graph: they outlive ``release_graphs()``. A call's
``<kind>.issue`` span (``issue_span``) carries the slot its stamps write.

``StageTimers`` sums wall-clock time per named stage; a stage given
``block_on`` waits for the device of those tensors before it stops the
clock, so the time covers the work it queued. ``device_trace`` records a
``torch.profiler`` trace (host and, with a card, CUDA activity) and writes
it as a Chrome trace into a directory: open it in Perfetto or
``chrome://tracing``; the spans show there as host ranges.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

# Stages of each kind's stage clock, in order: stamp 0 is the call's
# start, stamp i + 1 the end of stage i.
STAGES = {
    "step": ("geometry", "sh", "binning", "raster_fwd", "loss", "raster_bwd",
             "per_gaussian_bwd", "adam"),
    "dp": ("geometry", "sh", "binning", "raster_fwd", "loss", "raster_bwd",
           "per_gaussian_bwd", "allreduce", "adam"),
    "render": ("geometry", "sh", "binning", "raster_fwd"),
    "mip": ("filter3d",),
}
RING = 4096  # calls a ring keeps, per kind and device


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None  # the parent span's id
    thread: int  # threading.get_ident() of the thread it ran on
    slot: int | None = None  # an issue span's stage-clock slot


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()
_spans: list[Span] = []
_ids = itertools.count()
_local = threading.local()
_totals: dict[str, int] = defaultdict(int)
_traced: dict[str, int] = defaultdict(int)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "parent", "slot", "id", "start", "rf")

    def __init__(self, name: str, parent, slot):
        self.name, self.parent, self.slot = name, parent, slot

    def __enter__(self):
        stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        self.id = next(_ids)
        stack.append(self.id)
        self.start = time.time_ns()
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        end = time.time_ns()
        _stack().pop()
        _spans.append(Span(self.id, self.name, self.start, end, self.parent,
                           threading.get_ident(), self.slot))
        return False


def span(name: str, *, parent: int | None = None, slot: int | None = None):
    """A ``with`` block recorded as a span while tracing is on. ``parent``
    (a span's id) replaces the thread's innermost open span, for work a
    span caused on another thread."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Open(name, parent, slot)


def current_span() -> int | None:
    """The id of this thread's innermost open span, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def spans() -> list[Span]:
    """The spans recorded since the last ``clear()``, in order of their end."""
    return list(_spans)


def count(name: str, n: int = 1) -> None:
    _totals[name] += n
    if _profiler._is_profiler_enabled:
        _traced[name] += n


def counter(name: str) -> int:
    """``name``'s total in this process."""
    return _totals.get(name, 0)


def counters() -> dict[str, int]:
    """What was counted while tracing was on, since the last ``clear()``."""
    return dict(_traced)


# ---------------------------------------------------------------------------
# The stage clock


class _Ring:
    """One kind's stamps on one device: ``times`` (RING, stamps) int64 ns,
    ``slot`` the device's count of finished calls (on the card a device
    int64 that the last stamp advances), ``issued`` its host mirror."""

    def __init__(self, kind: str, device: torch.device):
        self.device = device
        self.stages = STAGES[kind]
        self.last = len(self.stages)
        # stage_done's stamps; the clock's exit stamps the last stage's end
        self.index = {s: i + 1 for i, s in enumerate(self.stages[:-1])}
        self.times = torch.zeros((RING, self.last + 1), dtype=torch.int64, device=device)
        self.slot = torch.zeros((), dtype=torch.int64, device=device)
        self.issued = self.cleared = 0
        self.cuda = device.type == "cuda"

    def stamp(self, i: int, advance: bool = False) -> None:
        if self.cuda:
            from ..kernels import _build

            _build.check(_build.build().gs_stage_stamp(
                self.times.data_ptr(), self.slot.data_ptr(), i, self.last + 1, RING,
                int(advance), _build.stream_ptr(self.device)), "stage_stamp")
        else:
            self.times[self.issued % RING, i] = time.time_ns()
        if advance:
            self.issued += 1

    def read(self) -> dict[int, dict[str, float]]:
        if self.cuda:
            torch.cuda.synchronize(self.device)
            done = int(self.slot)
        else:
            done = self.issued
        slots = list(range(max(self.cleared, done - RING), done))
        if not slots:
            return {}
        rows = self.times[torch.tensor([s % RING for s in slots], device=self.device)].cpu()
        ms = (rows[:, 1:] - rows[:, :-1]).double() / 1e6
        return {s: dict(zip(self.stages, map(float, ms[j]))) for j, s in enumerate(slots)}


_rings: dict[tuple[str, torch.device], _Ring] = {}
_last_device: dict[str, torch.device] = {}
_open_ring: _Ring | None = None  # the clock open now, seen by every thread


def rings_on(device: torch.device) -> None:
    """Make every kind's ring on ``device`` (before a CUDA graph's capture:
    a ring made inside one would live in the graph's memory pool)."""
    for kind in STAGES:
        if (kind, device) not in _rings:
            _rings[kind, device] = _Ring(kind, device)


@contextlib.contextmanager
def stage_clock(kind: str, device: torch.device):
    """Stamp one call of ``kind`` on ``device``: its start on entry, the
    last stage's end and the slot's advance on a clean exit. Inside an
    open clock it does nothing: the outermost call stamps."""
    global _open_ring
    if _open_ring is not None:
        yield
        return
    rings_on(device)
    ring = _rings[kind, device]
    _last_device[kind] = device
    _open_ring = ring
    try:
        ring.stamp(0)
        yield
        ring.stamp(ring.last, advance=True)
    finally:
        _open_ring = None


def stage_done(stage: str) -> None:
    """Stamp the end of ``stage`` in the open clock (nothing without one)."""
    ring = _open_ring
    if ring is not None:
        ring.stamp(ring.index[stage])


def issue_span(kind: str, device: torch.device, name: str | None = None):
    """The span ``name`` (default ``<kind>.issue``) of one call, carrying
    the slot that the call's stamps write."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    ring = _rings.get((kind, device))
    return _Open(name or f"{kind}.issue", None, ring.issued if ring is not None else 0)


@contextlib.contextmanager
def recording():
    """For a CUDA graph's capture: yields a dict that, on exit, holds the
    slots each ring advanced inside the block, which are taken back (a
    capture stamps nothing; each replay advances them, ``advance``)."""
    before = {key: ring.issued for key, ring in _rings.items()}
    counted: dict = {}
    try:
        yield counted
    finally:
        for key, issued in before.items():
            counted[key] = _rings[key].issued - issued
            _rings[key].issued = issued


def advance(counted: dict) -> None:
    for key, n in counted.items():
        _rings[key].issued += n


def stage_times(kind: str, device: torch.device | str | None = None
                ) -> dict[int, dict[str, float]]:
    """{slot: {stage: ms}} of every ``kind`` call on ``device`` (default:
    the device of the last such call) since the last ``clear()``, the
    newest ``RING`` at most. Synchronises the device."""
    device = _last_device.get(kind) if device is None else torch.device(device)
    if device is not None and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())  # as a tensor names it
    ring = _rings.get((kind, device))
    return {} if ring is None else ring.read()


def clear() -> None:
    """Drop the recorded spans, the traced counts and the stage times so
    far (counters' totals stay)."""
    _spans.clear()
    _traced.clear()
    for ring in _rings.values():
        ring.cleared = ring.issued


# ---------------------------------------------------------------------------
# Tools over the tracer


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
    """Per-stage wall-clock sums, the stage's device work included; each
    stage is also a span of its name."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        with span(name):
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
