"""The loader thread's decode and pinned copy of one image (the program's
``loader.decode`` spans, on the loader's thread), their mean."""

from gsbench import program_spans


def read(out):
    return program_spans.span_ms_mean(out, "trainer", "loader.decode")
