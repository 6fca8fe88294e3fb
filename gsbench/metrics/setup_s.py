"""Set-up: seconds from the process's start to the first timed iteration
(inputs drawn, kernels loaded or built, caps read, the first steps run
and the graph captured)."""


def read(out):
    return out.setup_s
