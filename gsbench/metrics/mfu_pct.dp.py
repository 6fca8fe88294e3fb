"""The whole dp step's share of one card's FP32 peak: rank 0's modelled
operations (``roofline.step_ops`` of its views) over the traced window's
time x 67 TFLOP/s."""

from gsbench.roofline import FP32_OPS_PER_S


def read(out):
    t = out.traced
    if t is None or t.kind != "dp" or not t.flops or t.busy_s <= 0:
        return None
    return 100.0 * t.flops / (t.window_s * FP32_OPS_PER_S)
