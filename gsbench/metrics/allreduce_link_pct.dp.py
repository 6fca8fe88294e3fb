"""The all-reduce's share of its roofline: the least time of one step's
all-reduce (``collective.allreduce_floor_s`` of the bytes the program
counted over the traced window, ``comm.reduced_bytes``, a window
iteration, over the cell's ranks) over the ``allreduce`` stage's median
time."""

from gsbench import program_spans
from gsbench.collective import allreduce_floor_s


def read(out):
    ms = program_spans.stage_ms(out, "dp", "dp", "allreduce")
    nbytes = program_spans.counted(out, "dp", ("comm.reduced_bytes",))
    ranks = getattr(out, "ranks", None)
    if not ms or not nbytes or not ranks:
        return None
    return 100.0 * allreduce_floor_s(nbytes / out.traced.units, ranks) / (ms / 1e3)
