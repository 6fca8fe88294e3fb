"""The share of the window's draws that the trainer's loader served from its
decoded-image cache (the program's counters ``loader.hits`` and
``loader.misses``, one a draw the trainer took), in percent; None without a
draw."""

from gsbench import program_spans


def read(out):
    hits = program_spans.counted(out, "trainer", ("loader.hits",))
    draws = program_spans.counted(out, "trainer", ("loader.hits", "loader.misses"))
    return 100.0 * hits / draws if draws else None
