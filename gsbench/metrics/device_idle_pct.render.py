"""The card's idle share of the traced window: one minus the union of
every device operation's interval over the window (never their sum)."""


def read(out):
    t = out.traced
    if t is None or t.kind != "render" or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
