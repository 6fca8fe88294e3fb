"""Camera matrix construction (host-side, numpy).

Port of ``gsplat_tpu/ops/camera.py``, carried over verbatim in numpy.

Conventions match the reference trainer: view = [R | t; 0 0 0 1] from the
COLMAP (w, x, y, z) quaternion and tvec; a D3D-style perspective projection
with znear=0.01, zfar=100 and ``fov = 2 atan(W / 2f)``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..io.colmap import qvec_to_rotmat

ZNEAR = 0.01
ZFAR = 100.0


@dataclasses.dataclass(frozen=True)
class CameraMatrices:
    """Per-(camera, pose) constants consumed by the render path."""

    view: np.ndarray  # (4, 4) float32 world->camera
    proj: np.ndarray  # (4, 4) float32 camera->clip
    campos: np.ndarray  # (3,) float32 camera center in world coords
    width: int
    height: int
    focal_x: float
    focal_y: float
    tan_fovx: float
    tan_fovy: float


def build_camera_matrices(
    qvec: np.ndarray,
    tvec: np.ndarray,
    width: int,
    height: int,
    focal_x: float,
    focal_y: float,
) -> CameraMatrices:
    rot = qvec_to_rotmat(np.asarray(qvec, dtype=np.float64))
    t = np.asarray(tvec, dtype=np.float64)

    view = np.zeros((4, 4), dtype=np.float32)
    view[:3, :3] = rot.astype(np.float32)
    view[:3, 3] = t.astype(np.float32)
    view[3, 3] = 1.0

    fov_x = 2.0 * math.atan(width / (2.0 * focal_x))
    fov_y = 2.0 * math.atan(height / (2.0 * focal_y))
    tan_fovx = math.tan(fov_x / 2.0)
    tan_fovy = math.tan(fov_y / 2.0)

    top = tan_fovy * ZNEAR
    right = tan_fovx * ZNEAR

    proj = np.zeros((4, 4), dtype=np.float32)
    proj[0, 0] = 2.0 * ZNEAR / (2.0 * right)
    proj[1, 1] = 2.0 * ZNEAR / (2.0 * top)
    proj[3, 2] = 1.0
    proj[2, 2] = ZFAR / (ZFAR - ZNEAR)
    proj[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)

    campos = (-rot.T @ t).astype(np.float32)

    return CameraMatrices(
        view=view,
        proj=proj,
        campos=campos,
        width=int(width),
        height=int(height),
        focal_x=float(focal_x),
        focal_y=float(focal_y),
        tan_fovx=tan_fovx,
        tan_fovy=tan_fovy,
    )
