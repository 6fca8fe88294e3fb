"""The whole window over the views completed in it (host clock)."""


def read(out):
    if out.kind != "render" or not out.units:
        return None
    return 1e3 * out.window_s / out.units
