"""The dp step's ``adam`` stage on the card (Adam over the union of the
batch's masks, the accumulators, the metrics and the monitor's fold):
rank 0's ``dp`` stage clock, the median over the traced window's
iterations."""

from gsbench import program_spans


def read(out):
    return program_spans.stage_ms(out, "dp", "dp", "adam")
