"""The render's ``raster_fwd`` stage on the card (attribute packing, K1 and
``tiles_to_image``): the program's stage clock in the render's CUDA graph,
the median over the traced window's views."""

from gsbench import program_spans


def read(out):
    return program_spans.stage_ms(out, "render", "render", "raster_fwd")
