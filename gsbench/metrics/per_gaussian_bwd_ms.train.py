"""The step's ``per_gaussian_bwd`` stage on the card (autograd back through the
per-Gaussian maths): the program's stage clock in the step's CUDA graph, the
median over the traced window's iterations."""

from gsbench import program_spans


def read(out):
    return program_spans.stage_ms(out, "train", "step", "per_gaussian_bwd")
