"""The step's ``raster_fwd`` stage on the card (attribute packing, K1 and
``tiles_to_image``): the program's stage clock in the step's CUDA graph, the
median over the traced window's iterations."""

from gsbench import program_spans


def read(out):
    return program_spans.stage_ms(out, "train", "step", "raster_fwd")
