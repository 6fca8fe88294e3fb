"""The host's issue of one graphed step: input copies, the replay and the
copies out (the program's ``step.issue`` spans), per iteration of the traced
window."""

from gsbench import program_spans


def read(out):
    return program_spans.span_ms_per_unit(out, "train", "step.issue")
