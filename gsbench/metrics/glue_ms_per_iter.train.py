"""Device time of every operation outside the port's five kernel families
(the plain-PyTorch glue: per-Gaussian maths, loss, Adam, autograd,
copies), per training iteration of the traced window."""


def read(out):
    t = out.traced
    if t is None or t.kind != "train" or not t.units or t.busy_s <= 0:
        return None
    return 1e3 * t.glue_s / t.units
