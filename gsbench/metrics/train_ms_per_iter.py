"""The whole window over the training iterations completed in it (host
clock; the window ends after the card has finished)."""


def read(out):
    if out.kind != "train" or not out.units:
        return None
    return 1e3 * out.window_s / out.units
