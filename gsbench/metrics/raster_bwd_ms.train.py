"""The step's ``raster_bwd`` stage on the card (K2 and K4, inside
``_Rasterize.backward``): the program's stage clock in the step's CUDA
graph, the median over the traced window's iterations."""

from gsbench import program_spans


def read(out):
    return program_spans.stage_ms(out, "train", "step", "raster_bwd")
