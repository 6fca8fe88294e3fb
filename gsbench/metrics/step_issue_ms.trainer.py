"""The host's issue of the train step inside the trainer (the program's
``trainer.step`` spans), per iteration of the traced window."""

from gsbench import program_spans


def read(out):
    return program_spans.span_ms_per_unit(out, "trainer", "trainer.step")
