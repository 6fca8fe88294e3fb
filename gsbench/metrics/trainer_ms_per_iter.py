"""The trainer's whole window (every ``train`` call's time) over the
iterations completed in it (host clock)."""


def read(out):
    if out.kind != "trainer" or not out.units:
        return None
    return 1e3 * out.window_s / out.units
