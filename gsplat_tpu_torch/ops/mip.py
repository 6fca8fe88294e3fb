"""Mip-Splatting's two filters (Yu et al., "Mip-Splatting: Alias-free 3D
Gaussian Splatting", CVPR 2024, arXiv:2311.16493; the published code's
``scene/gaussian_model.py`` and its rasterizer's ``computeCov2D``).

**The 3D smoothing filter.** A sweep over the training cameras gives each
Gaussian the depth ``d`` of its nearest camera that sees it: camera c sees
it where ``z_c > DEPTH_FLOOR`` and its pixel ``(f_x x/z + W/2, f_y y/z +
H/2)`` lies in ``[-MARGIN W, (1 + MARGIN) W] x [-MARGIN H, (1 + MARGIN)
H]``, with ``x_c = R_c x + t_c``. A Gaussian no camera sees takes the
largest ``d`` of those seen. ``filter_3d = d / max_c f_x,c *
sqrt(FILTER_VARIANCE)``. The step adds ``filter_3d^2 I`` to each Sigma
(the published code rebuilds Sigma from the scales ``sqrt(s^2 + f^2)``,
the same matrix to rounding) and multiplies the opacity by
``sqrt(prod s^2 / prod (s^2 + f^2))``. Dead rows get 0.

**The 2D Mip filter.** The screen covariance is dilated by ``KERNEL_2D``
in place of 3DGS's 0.3, and the opacity multiplied by
``sqrt(det0 / (det1 + 1e-6) + 1e-6)``, ``det0 = max(1e-6, det Sigma2D)``,
``det1 = max(1e-6, det(Sigma2D + KERNEL_2D I))``; the factor is 0 where
either determinant is at its floor (``ops/covariance.py``).

``nearest_depth_plain`` and ``filter_3d_plain`` are the sweep's plain
PyTorch version (``kernels/filter3d.py`` runs them on CPU tensors and
``csrc/filter3d.cu`` on the card). It tests the screen bounds without a division: ``x_lo z_c
<= x_c <= x_hi z_c`` with ``x_lo = (-MARGIN W - W/2) / f_x`` and ``x_hi =
((1 + MARGIN) W - W/2) / f_x`` (``z_c > 0``), the same for y; so it
differs from the published test by rounding, and a Gaussian within
rounding of a margin may fall on the other side of it. The kernel makes
the same f32 operations in the same order, so the two agree bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import profiling

FILTER_VARIANCE = 0.2  # the 3D filter's variance in pixels^2 at the nearest camera
KERNEL_2D = 0.1  # the 2D Mip filter's variance in pixels^2
DEPTH_FLOOR = 0.2  # a camera sees a Gaussian only beyond this depth
MARGIN = 0.15  # ... and only within this share of the image past each edge
FILTER_INTERVAL = 100  # iterations between the trainer's sweeps (the published cadence)
# A camera's row of the sweep's table: R (row-major) 9, t 3, f_x, f_y, and
# the screen's bounds over the focal length, x_lo, x_hi, y_lo, y_hi.
CAMERA_COLUMNS = 18


def camera_table(cameras, device) -> torch.Tensor:
    """(C, CAMERA_COLUMNS) float32 sweep table of ``cameras``, each with
    ``view`` (4, 4), ``width``, ``height``, ``focal_x`` and ``focal_y``
    (``ops/camera.py::CameraMatrices``)."""
    rows = []
    for cam in cameras:
        view = np.asarray(cam.view, dtype=np.float64)
        w, h = float(cam.width), float(cam.height)
        fx, fy = cam.focal_x, cam.focal_y
        rows.append(list(view[:3, :3].reshape(-1)) + list(view[:3, 3]) + [
            fx, fy, (-MARGIN * w - w / 2.0) / fx, ((1.0 + MARGIN) * w - w / 2.0) / fx,
            (-MARGIN * h - h / 2.0) / fy, ((1.0 + MARGIN) * h - h / 2.0) / fy])
    table = np.asarray(rows, dtype=np.float32).reshape(-1, CAMERA_COLUMNS)
    return torch.from_numpy(table).to(device)


def nearest_depth_plain(xyz: torch.Tensor, alive: torch.Tensor,
                        cameras: torch.Tensor) -> torch.Tensor:
    """(N,) depth of each alive Gaussian's nearest seeing camera; +inf
    where no camera sees it and on dead rows."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    best = torch.full_like(x, math.inf)
    for k in cameras.tolist():
        f32 = [torch.tensor(v, dtype=torch.float32) for v in k]
        r, t = f32[:9], f32[9:12]
        x_lo, x_hi, y_lo, y_hi = f32[14:]
        xc = r[0] * x + r[1] * y + r[2] * z + t[0]
        yc = r[3] * x + r[4] * y + r[5] * z + t[1]
        zc = r[6] * x + r[7] * y + r[8] * z + t[2]
        seen = ((zc > DEPTH_FLOOR) & (xc >= x_lo * zc) & (xc <= x_hi * zc)
                & (yc >= y_lo * zc) & (yc <= y_hi * zc))
        best = torch.where(seen, torch.minimum(best, zc), best)
    return torch.where(alive, best, math.inf)


def filter_3d_plain(xyz: torch.Tensor, alive: torch.Tensor, cameras: torch.Tensor
                    ) -> torch.Tensor:
    """(N,) 3D filter: the nearest seeing camera's depth (unseen rows take
    the largest seen, 0 with none seen) over the largest f_x, times
    sqrt(FILTER_VARIANCE); 0 on dead rows."""
    d = nearest_depth_plain(xyz, alive, cameras)
    seen = torch.isfinite(d)
    d = torch.where(seen, d, torch.where(seen, d, 0.0).amax())
    f = d / cameras[:, 12].amax() * math.sqrt(FILTER_VARIANCE)
    return torch.where(alive, f, 0.0)


@torch.no_grad()
def update_filter_3d_(params, cameras: torch.Tensor) -> None:
    """Recompute ``params.filter_3d`` in place from the sweep table
    ``cameras`` (``camera_table``), on the parameters' device with no host
    read: a CUDA graph that reads the buffer takes the new values. The
    tracer's span ``mip.filter3d`` covers the call and carries the slot of
    its stage clock ``mip`` (one stage, ``filter3d``); it counts
    ``mip.filter3d_sweeps`` (one) and ``mip.filter3d_tests`` (rows x
    cameras)."""
    from ..kernels.filter3d import filter_3d_

    if params.filter_3d is None:
        raise ValueError("update_filter_3d_: the parameters hold no filter_3d buffer "
                         "(train/state.py::with_filter_3d)")
    dev = params.xyz.device
    profiling.count("mip.filter3d_sweeps")
    profiling.count("mip.filter3d_tests", params.capacity * cameras.shape[0])
    with profiling.issue_span("mip", dev, name="mip.filter3d"), \
            profiling.stage_clock("mip", dev):
        filter_3d_(params.filter_3d, params.xyz.detach(), params.alive, cameras)


def filtered_sigma(sigma: torch.Tensor, filter_3d: torch.Tensor) -> torch.Tensor:
    """(N, 6) Sigma [xx xy xz yy yz zz] + filter_3d^2 I."""
    f2 = filter_3d * filter_3d
    xx, xy, xz, yy, yz, zz = sigma.unbind(1)
    return torch.stack([xx + f2, xy, xz, yy + f2, yz, zz + f2], dim=1)


def opacity_scale_3d(scale: torch.Tensor, filter_3d: torch.Tensor) -> torch.Tensor:
    """(N,) ``sqrt(prod s^2 / prod (s^2 + f^2))`` of log-scales ``scale``
    (N, 3): the 3D filter's opacity factor."""
    s2 = torch.exp(2.0 * scale)
    f2 = (filter_3d * filter_3d)[:, None]
    s2f = s2 + f2
    # products spelled out: torch.prod's backward reads the host (no graph)
    return torch.sqrt((s2[:, 0] * s2[:, 1] * s2[:, 2]) / (s2f[:, 0] * s2f[:, 1] * s2f[:, 2]))
