"""The step's ``loss`` stage on the card (the loss's forward and its gradient
up to the rasterizer's backward): the program's stage clock in the step's
CUDA graph, the median over the traced window's iterations."""

from gsbench import program_spans


def read(out):
    return program_spans.stage_ms(out, "train", "step", "loss")
