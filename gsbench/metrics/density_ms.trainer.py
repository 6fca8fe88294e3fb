"""The density step, its state growth, second pass and Morton re-sort included
(the program's ``trainer.density`` spans), per iteration of the traced
window."""

from gsbench import program_spans


def read(out):
    return program_spans.span_ms_per_unit(out, "trainer", "trainer.density")
