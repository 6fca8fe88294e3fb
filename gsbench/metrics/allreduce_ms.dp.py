"""The dp step's ``allreduce`` stage on the card (the pack of the gradients,
both SUM all-reduces and the unpack, the division by the batch included):
rank 0's ``dp`` stage clock in the step's CUDA graph, the median over the
traced window's iterations."""

from gsbench import program_spans


def read(out):
    return program_spans.stage_ms(out, "dp", "dp", "allreduce")
