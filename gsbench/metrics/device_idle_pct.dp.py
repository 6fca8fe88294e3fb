"""Rank 0's card's idle share of the traced window: one minus the union of
every device operation's interval over the window (never their sum); the
all-reduce's kernels count as busy, waits for the other ranks included."""


def read(out):
    t = out.traced
    if t is None or t.kind != "dp" or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
