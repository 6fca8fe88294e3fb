"""The step's ``sh`` stage on the card (the SH colour, ``sh_to_rgb``): the
program's stage clock in the step's CUDA graph, the median over the traced
window's iterations."""

from gsbench import program_spans


def read(out):
    return program_spans.stage_ms(out, "train", "step", "sh")
