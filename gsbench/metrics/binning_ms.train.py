"""The step's ``binning`` stage on the card (K5, K3 and the tile tables): the
program's stage clock in the step's CUDA graph, the median over the traced
window's iterations."""

from gsbench import program_spans


def read(out):
    return program_spans.stage_ms(out, "train", "step", "binning")
