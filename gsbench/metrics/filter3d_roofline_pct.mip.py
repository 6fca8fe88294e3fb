"""The 3D-filter sweep kernel's share of its roofline in the traced window:
its least time (``mip_roofline.sweep_bound_ms`` a sweep) over its device
time in the trace. None where the trace holds no such kernel."""


def read(out):
    t = out.traced
    if t is None or t.kind != "train":
        return None
    spent, bound = getattr(t, "filter3d_kernel_s", None), getattr(t, "filter3d_bound_s", None)
    if not spent or not bound:
        return None
    return 100.0 * bound / spent
