"""The whole step's share of the card's FP32 peak: its modelled operations
(``roofline.step_ops``) over the traced window's time x 67 TFLOP/s."""

from gsbench.roofline import FP32_OPS_PER_S


def read(out):
    t = out.traced
    if t is None or t.kind != "render" or not t.flops or t.busy_s <= 0:
        return None
    return 100.0 * t.flops / (t.window_s * FP32_OPS_PER_S)
