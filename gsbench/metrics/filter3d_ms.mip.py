"""Mip-Splatting's 3D-filter sweep on the card (the camera sweep kernel and
the filter's finish): the program's ``mip`` stage clock, whose calls are
its ``mip.filter3d`` spans, the median over the traced window's sweeps.
None where the program has no such span."""

import statistics

from gsbench import program_spans


def read(out):
    t, s = out.traced, program_spans.store()
    if t is None or s is None or t.kind != "train" or t.busy_s <= 0:
        return None
    slots = [x.slot for x in s.spans() if x.name == "mip.filter3d" and x.slot is not None]
    times = s.stage_times("mip") if slots else {}
    ms = [times[k]["filter3d"] for k in slots if k in times]
    return statistics.median(ms) if ms else None
