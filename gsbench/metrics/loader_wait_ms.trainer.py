"""The trainer's wait on its image loader's queue (the program's
``loader.wait`` spans), per iteration of the traced window."""

from gsbench import program_spans


def read(out):
    return program_spans.span_ms_per_unit(out, "trainer", "loader.wait")
