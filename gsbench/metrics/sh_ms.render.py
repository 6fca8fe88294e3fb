"""The render's ``sh`` stage on the card (the SH colour, ``sh_to_rgb``): the
program's stage clock in the render's CUDA graph, the median over the traced
window's views."""

from gsbench import program_spans


def read(out):
    return program_spans.stage_ms(out, "render", "render", "sh")
