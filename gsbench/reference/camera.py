"""Camera matrices from a COLMAP pose (NumPy), as the trainer builds them:
view = [R | t], a D3D-style perspective with znear 0.01 and zfar 100,
``fov = 2 atan(W / 2f)``."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

ZNEAR = 0.01
ZFAR = 100.0


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """(w, x, y, z), normalised first -> rotation matrix."""
    w, x, y, z = (float(v) for v in q)
    n = math.sqrt(w * w + x * x + y * y + z * z)
    if n > 0:
        w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat_to_qvec(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z), Shepperd's method."""
    r = np.asarray(r, dtype=np.float64)
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = (0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s)
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        q = ((r[2, 1] - r[1, 2]) / s, 0.25 * s, (r[0, 1] + r[1, 0]) / s, (r[0, 2] + r[2, 0]) / s)
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        q = ((r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s, 0.25 * s, (r[1, 2] + r[2, 1]) / s)
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        q = ((r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s, (r[1, 2] + r[2, 1]) / s, 0.25 * s)
    return np.array(q, np.float64)


@dataclasses.dataclass(frozen=True)
class Camera:
    view: np.ndarray  # (4, 4) float32 world -> camera
    proj: np.ndarray  # (4, 4) float32 camera -> clip
    campos: np.ndarray  # (3,) float32
    width: int
    height: int
    focal_x: float
    focal_y: float
    tan_fovx: float
    tan_fovy: float

    @property
    def centre(self) -> np.ndarray:
        return self.campos.astype(np.float64)


def camera(qvec, tvec, width: int, height: int, focal_x: float, focal_y: float) -> Camera:
    rot = qvec_to_rotmat(np.asarray(qvec, dtype=np.float64))
    t = np.asarray(tvec, dtype=np.float64)
    view = np.zeros((4, 4), np.float32)
    view[:3, :3] = rot.astype(np.float32)
    view[:3, 3] = t.astype(np.float32)
    view[3, 3] = 1.0
    tan_fovx = math.tan(math.atan(width / (2.0 * focal_x)))
    tan_fovy = math.tan(math.atan(height / (2.0 * focal_y)))
    top, right = tan_fovy * ZNEAR, tan_fovx * ZNEAR
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = 2.0 * ZNEAR / (2.0 * right)
    proj[1, 1] = 2.0 * ZNEAR / (2.0 * top)
    proj[3, 2] = 1.0
    proj[2, 2] = ZFAR / (ZFAR - ZNEAR)
    proj[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    campos = (-rot.T @ t).astype(np.float32)
    return Camera(view, proj, campos, int(width), int(height), float(focal_x),
                  float(focal_y), tan_fovx, tan_fovy)
