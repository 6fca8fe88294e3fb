"""The image dump at a print boundary: render, copy, PNG encode (the program's
``trainer.dump`` spans), per iteration of the traced window."""

from gsbench import program_spans


def read(out):
    return program_spans.span_ms_per_unit(out, "trainer", "trainer.dump")
