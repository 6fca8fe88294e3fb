"""The CUDA graphs built in the traced window: eager first calls and captures
of the step's and the render's graphs (the program's counters ``step.eager``
and ``step.captures``)."""

from gsbench import program_spans


def read(out):
    return program_spans.counted(out, "trainer", ("step.eager", "step.captures"))
