"""Mip-Splatting's operations and the least time of its 3D filter's sweep,
on ``roofline.py``'s peaks and counting rules (an FMA 2; a multiply, add,
divide, compare or select 1; exp, log, sqrt 10).

- The sweep (``gsplat_tpu_torch/csrc/filter3d.cu``), counted from the
  kernel's source, per Gaussian and camera: the camera transform's 9
  multiplies and 9 adds 18, the depth test 1, the four screen bounds'
  products and tests 8, the minimum and its select 2: 29. Bytes per
  capacity row: xyz 12, the alive byte 1, the depth written 4: 17.
- The step's filters, per Gaussian and view, forward: Sigma + f^2 I 4;
  the 3D factor's squared scales 33 (exp 30, the doubling 3), two products
  4, the sum 3, the divide 1 and sqrt 10; the 2D filter's two determinants
  8, their floors 2, the factor's divide, adds and sqrt 13 and its select
  3; the opacity scale's product 1, the cut's log and add 11 and the
  opacity's product 1: 94, less the 0.3 dilation's 2 adds it replaces: 92.
  Backward: autograd's adjoints, twice the forward: 184.
"""

from __future__ import annotations

from .reference.init import capacity
from .roofline import FP32_OPS_PER_S, HBM_BYTES_PER_S

SWEEP_TEST_OPS = 29
SWEEP_ROW_BYTES = 17
FILTER_OPS = dict(fwd=92, bwd=184)


def sweep_ops(gaussians: int, cameras: int) -> float:
    """FP32 operations of one sweep of ``gaussians`` over ``cameras``."""
    return float(gaussians) * cameras * SWEEP_TEST_OPS


def sweep_bound_ms(gaussians: int, cameras: int) -> float:
    """The least time an H100 could take for one sweep: its operations at
    the FP32 peak or its bytes (the capacity bucket's rows) at the HBM
    bandwidth, the larger."""
    return 1e3 * max(sweep_ops(gaussians, cameras) / FP32_OPS_PER_S,
                     SWEEP_ROW_BYTES * capacity(gaussians) / HBM_BYTES_PER_S)


def filter_ops(views: int, gaussians: int) -> float:
    """The step's filter operations over ``views`` stepped views."""
    return float(views) * gaussians * (FILTER_OPS["fwd"] + FILTER_OPS["bwd"])
