"""The host's one read of the on-device monitor at a boundary, the wait for the
card included (the program's ``trainer.monitor_read`` spans), per iteration
of the traced window."""

from gsbench import program_spans


def read(out):
    return program_spans.span_ms_per_unit(out, "trainer", "trainer.monitor_read")
