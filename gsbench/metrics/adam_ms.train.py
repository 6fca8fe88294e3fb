"""The step's ``adam`` stage on the card (Adam, the accumulators, the metrics
and the monitor's fold): the program's stage clock in the step's CUDA graph,
the median over the traced window's iterations."""

from gsbench import program_spans


def read(out):
    return program_spans.stage_ms(out, "train", "step", "adam")
