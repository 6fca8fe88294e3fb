"""The host's issue of one graphed render: input copies, the replay and the
image's copy out (the program's ``render.issue`` spans), per view of the
traced window."""

from gsbench import program_spans


def read(out):
    return program_spans.span_ms_per_unit(out, "render", "render.issue")
