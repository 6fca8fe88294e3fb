"""The step's ``geometry`` stage on the card (projection, cull, Jacobian,
covariance and conic): the program's stage clock in the step's CUDA graph,
the median over the traced window's iterations."""

from gsbench import program_spans


def read(out):
    return program_spans.stage_ms(out, "train", "step", "geometry")
