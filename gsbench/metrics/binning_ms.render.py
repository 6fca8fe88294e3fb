"""The render's ``binning`` stage on the card (K5, K3 and the tile tables): the
program's stage clock in the render's CUDA graph, the median over the traced
window's views."""

from gsbench import program_spans


def read(out):
    return program_spans.stage_ms(out, "render", "render", "binning")
