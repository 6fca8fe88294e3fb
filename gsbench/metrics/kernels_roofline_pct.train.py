"""The port's kernels' share of their roofline in the traced window: the
least time of the work they were given (``roofline.kernel_bound``, from
each stepped view's pairs, tiles and pair-pixels) over their device time."""


def read(out):
    t = out.traced
    spent = sum(t.family_s.values()) if t is not None else 0.0
    if t is None or t.kind != "train" or not t.bounds_s or spent <= 0:
        return None
    return 100.0 * t.bounds_s / spent
