"""Peaks, the kernels' least time and the step's modelled operations.

``kernel_bound`` and its constants are copied from ``chip_smoke.py``
(``:397-430`` and ``:431-478`` at the commit that added this benchmark):
bytes count each input read once and each output written once; FP32
operations count what these inputs need, counted from the kernel sources.
The operation counts of the glue (``GLUE_OPS``) are this benchmark's own
model, derived below, for the step's share of the chip's FP32 peak.
"""

from __future__ import annotations

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TILE = 16
# Per pair-pixel of a pixel's n_splats: dx, dy 2; power 11; expf 10; alpha
# 2; the 1/255 cutoff 1.
ALPHA_OPS = 26
# Past the cutoff, K1: T (1 - alpha) 2, the T test 1, w 1, three colour FMAs 6.
K1_PASS_OPS = 10
# K2: 1 - alpha and its reciprocal 2; T 1; c . dI 5; w 1; grad_alpha 3; the
# sum behind the splat 2; d/d power 2; the nine values added 28.
K2_PASS_OPS = 44
# Packed mode: rounding a staged pair 87; K2's words 50 a reached pair;
# K4's unpacking of a word row 21.
PACK_ATTR_OPS = 87
PACK_GRAD_OPS = 50
UNPACK_GRAD_OPS = 21

# The glue's FP32 operations (an FMA 2; a multiply, add, divide, compare or
# select 1; exp, log, sqrt, atan2, sin, cos 10), counted from the formulas
# of ``reference/``:
# - per Gaussian, forward: camera transform 18, projection 24, cull 8,
#   Jacobian 20, quaternion -> rotation 40, exp of the scales 30, Sigma 45,
#   conic 45, radius and ellipse scale 95, view direction 20, SH basis 45,
#   colour 96, sigmoid and packing 12: 498;
# - per Gaussian, backward: autograd's adjoints, twice the forward: 996;
# - per Gaussian, Adam: 59 parameter values x 27 (NaN scrub 2, first
#   moment 3, second 4, bias corrections 2, sqrt 10, eps 1, learning rate
#   and divide 2, three selects 3), plus the uv accumulators 8: 1,601;
# - per tile row, binning's strip extremes and gate: 150; per pair, its key 4;
# - per pixel, the loss: forward 15 channel-maps x 2 passes x 11 taps x 2 =
#   660 and the SSIM terms 3 x 40 = 120; backward 9 x 2 x 11 x 2 = 396 and
#   3 x 20 = 60: 1,236.
GLUE_OPS = dict(gaussian_fwd=498, gaussian_bwd=996, adam=1601, row=150, pair=4, loss=1236)


def kernel_bound(name: str, packed: bool = False, **work) -> dict:
    """The least time an H100 could take for one kernel's work: bytes,
    ops, bound_ms and bound_by ("bytes" or "operations")."""
    pix = TILE * TILE
    if name == "segment_expand":  # records and offsets in, columns out
        nbytes = sum(4 * (c * r + r + 1 + c * t) for c, r, t in work["expand"])
        ops = 0
    elif name == "radix_sort":  # keys in; sorted keys and permutation out
        nbytes, ops = 12 * work["keys"], 0
    elif name in ("rasterize_forward", "rasterize_backward"):
        g, p, t = work["gaussians"], work["pairs"], work["tiles"]
        nbytes = 36 * g + 4 * p + 8 * t + 4 * 5 * pix * t
        ops = ALPHA_OPS * work["pair_pixels"]
        if packed:
            ops += PACK_ATTR_OPS * work["reached"]
        if name == "rasterize_forward":
            ops += K1_PASS_OPS * work["passing"]
        else:
            nbytes += 4 * 3 * pix * t + 4 * p + (16 if packed else 36) * p
            ops += K2_PASS_OPS * work["passing"]
            if packed:
                ops += PACK_GRAD_OPS * work["reached"]
    elif name == "segment_sum":  # contiguous rows and pair_start in; sums out
        p, g = work["pairs"], work["gaussians"]
        nbytes = (16 if packed else 36) * p + 4 * (g + 1) + 36 * g
        ops = ((9 + UNPACK_GRAD_OPS) if packed else 9) * p
    else:
        raise ValueError(f"no bound for {name}")
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / FP32_OPS_PER_S
    return dict(bytes=nbytes, ops=ops, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _kernels(w: dict, train: bool) -> list:
    """One view's kernel calls in the packed step (train) or render."""
    calls = [("segment_expand", dict(expand=[(2, w["gaussians"], w["rows"]),
                                             (2, w["rows"], w["pairs"])])),
             ("radix_sort", dict(keys=w["pairs"])),
             ("rasterize_forward", w)]
    if train:
        calls += [("rasterize_backward", w), ("segment_sum", w)]
    return calls


def bound_seconds(works: list, train: bool) -> float:
    """The kernels' summed least time over the views ``works``."""
    return sum(kernel_bound(name, packed=True, **kw)["bound_ms"]
               for w in works for name, kw in _kernels(w, train)) / 1e3


def step_ops(works: list, train: bool, alive: int, pixels: int) -> float:
    """Modelled FP32 operations of the steps (or renders) ``works``."""
    total = 0.0
    for w in works:
        ops = sum(kernel_bound(name, packed=True, **kw)["ops"] for name, kw in _kernels(w, train))
        ops += w["rows"] * GLUE_OPS["row"] + w["pairs"] * GLUE_OPS["pair"]
        ops += alive * GLUE_OPS["gaussian_fwd"]
        if train:
            ops += alive * (GLUE_OPS["gaussian_bwd"] + GLUE_OPS["adam"])
            ops += pixels * GLUE_OPS["loss"]
        total += ops
    return total
