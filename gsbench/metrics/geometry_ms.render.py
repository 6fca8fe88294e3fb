"""The render's ``geometry`` stage on the card (projection, cull, Jacobian,
covariance and conic): the program's stage clock in the render's CUDA graph,
the median over the traced window's views."""

from gsbench import program_spans


def read(out):
    return program_spans.stage_ms(out, "render", "render", "geometry")
