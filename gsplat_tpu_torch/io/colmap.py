"""COLMAP binary reconstruction readers and writers (port of
``gsplat_tpu/io/colmap.py``, numpy and ``struct`` as there).

- ``read_cameras_binary``: the 11 COLMAP camera models, of which only
  PINHOLE and SIMPLE_PINHOLE are accepted; intrinsics divided by
  ``downsample_factor`` and width/height rescaled with round().
- ``read_images_binary``: qvec/tvec poses, and the image path made as
  ``{root}images_{f}/{name}`` (``images/`` at factor 1).
- ``read_points3d_binary``: xyz/rgb/error and track.
- ``qvec_to_rotmat`` / ``Image.cam_pos``: (w, x, y, z) quaternion to
  rotation matrix, camera centre ``-R^T t``.
- ``compute_max_diagonal``: the largest camera-centre distance from the
  centroid.

A reader raises ``ColmapError`` on a missing file, a short file or an
unsupported camera model.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

__all__ = [
    "Camera",
    "Image",
    "Point3D",
    "ColmapError",
    "CAMERA_MODELS",
    "read_cameras_binary",
    "read_images_binary",
    "read_points3d_binary",
    "write_cameras_binary",
    "write_images_binary",
    "write_points3d_binary",
    "compute_max_diagonal",
    "qvec_to_rotmat",
    "rotmat_to_qvec",
]


class ColmapError(RuntimeError):
    pass


# model_id -> (name, num_params), COLMAP's table.
CAMERA_MODELS: dict[int, tuple[str, int]] = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}

_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    """Rotation matrix from a (w, x, y, z) quaternion (normalized first)."""
    w, x, y, z = np.asarray(qvec, dtype=np.float64)
    n = np.sqrt(w * w + x * x + y * y + z * z)
    if n > 0:
        w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Robust rotation-matrix -> (w,x,y,z) quaternion (Shepperd's method)."""
    R = np.asarray(R, dtype=np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w, x = 0.25 * s, (R[2, 1] - R[1, 2]) / s
        y, z = (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w, x = (R[2, 1] - R[1, 2]) / s, 0.25 * s
        y, z = (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w, x = (R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s
        y, z = 0.25 * s, (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w, x = (R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s
        y, z = (R[1, 2] + R[2, 1]) / s, 0.25 * s
    return np.array([w, x, y, z], np.float64)


@dataclasses.dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # float64 (num_params,)

    @property
    def focal_x(self) -> float:
        return float(self.params[0])

    @property
    def focal_y(self) -> float:
        # SIMPLE_PINHOLE has a single focal length (f, cx, cy).
        return float(self.params[1 if self.model == "PINHOLE" else 0])


@dataclasses.dataclass
class Image:
    id: int
    qvec: np.ndarray  # float64 (4,) w,x,y,z
    tvec: np.ndarray  # float64 (3,)
    camera_id: int
    name: str  # full path to the image file
    xys: np.ndarray  # float64 (P, 2)
    point3d_ids: np.ndarray  # int64 (P,)

    def qvec_to_rotmat(self) -> np.ndarray:
        return qvec_to_rotmat(self.qvec)

    def cam_pos(self) -> np.ndarray:
        """Camera center in world coordinates: -R^T t."""
        return -self.qvec_to_rotmat().T @ self.tvec


@dataclasses.dataclass
class Point3D:
    id: int
    xyz: np.ndarray  # float64 (3,)
    rgb: np.ndarray  # uint8 (3,)
    error: float
    image_ids: np.ndarray  # int32 (T,)
    point2d_idxs: np.ndarray  # int32 (T,)


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    data = f.read(size)
    if len(data) != size:
        raise ColmapError("Unexpected end of file")
    return struct.unpack(fmt, data)


def read_cameras_binary(
    path: str | Path, downsample_factor: int = 1
) -> dict[int, Camera]:
    path = Path(path)
    if not path.is_file():
        raise ColmapError(f"Could not open file {path}")
    cameras: dict[int, Camera] = {}
    with open(path, "rb") as f:
        (num_cameras,) = _read(f, "<Q")
        for _ in range(num_cameras):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            if model_id not in (0, 1):
                raise ColmapError(
                    "Only PINHOLE or SIMPLE_PINHOLE camera supported"
                )
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{num_params}d"), dtype=np.float64)
            params = params / float(downsample_factor)
            width = int(np.round(width / float(downsample_factor)))
            height = int(np.round(height / float(downsample_factor)))
            cameras[cam_id] = Camera(
                id=cam_id, model=name, width=width, height=height, params=params
            )
    return cameras


def read_images_binary(
    path: str | Path, img_root_dir: str = "", downsample_factor: int = 1
) -> dict[int, Image]:
    path = Path(path)
    if not path.is_file():
        raise ColmapError(f"Could not open file {path}")
    images: dict[int, Image] = {}
    subdir = f"images_{downsample_factor}" if downsample_factor > 1 else "images"
    with open(path, "rb") as f:
        (num_images,) = _read(f, "<Q")
        for _ in range(num_images):
            (img_id,) = _read(f, "<i")
            qvec = np.array(_read(f, "<4d"), dtype=np.float64)
            tvec = np.array(_read(f, "<3d"), dtype=np.float64)
            (camera_id,) = _read(f, "<i")
            name_chars = []
            while True:
                (c,) = _read(f, "<c")
                if c == b"\x00":
                    break
                name_chars.append(c.decode("latin-1"))
            name = img_root_dir + subdir + "/" + "".join(name_chars)
            (num_points2d,) = _read(f, "<Q")
            if num_points2d:
                rec = np.frombuffer(
                    f.read(24 * num_points2d),
                    dtype=np.dtype([("xy", "<f8", 2), ("id", "<i8")]),
                )
                if rec.shape[0] != num_points2d:
                    raise ColmapError("Unexpected end of file")
                xys = rec["xy"].astype(np.float64)
                p3d_ids = rec["id"].astype(np.int64)
            else:
                xys = np.zeros((0, 2), dtype=np.float64)
                p3d_ids = np.zeros((0,), dtype=np.int64)
            images[img_id] = Image(
                id=img_id,
                qvec=qvec,
                tvec=tvec,
                camera_id=camera_id,
                name=name,
                xys=xys,
                point3d_ids=p3d_ids,
            )
    return images


def read_points3d_binary(path: str | Path) -> dict[int, Point3D]:
    path = Path(path)
    if not path.is_file():
        raise ColmapError(f"Could not open file {path}")
    points: dict[int, Point3D] = {}
    with open(path, "rb") as f:
        (num_points,) = _read(f, "<Q")
        for _ in range(num_points):
            pid, x, y, z, r, g, b, error = _read(f, "<Q3d3Bd")
            (track_len,) = _read(f, "<Q")
            if track_len:
                rec = np.frombuffer(
                    f.read(8 * track_len),
                    dtype=np.dtype([("img", "<i4"), ("p2d", "<i4")]),
                )
                if rec.shape[0] != track_len:
                    raise ColmapError("Unexpected end of file")
                image_ids = rec["img"].astype(np.int32)
                p2d_idxs = rec["p2d"].astype(np.int32)
            else:
                image_ids = np.zeros((0,), dtype=np.int32)
                p2d_idxs = np.zeros((0,), dtype=np.int32)
            points[pid] = Point3D(
                id=pid,
                xyz=np.array([x, y, z], dtype=np.float64),
                rgb=np.array([r, g, b], dtype=np.uint8),
                error=error,
                image_ids=image_ids,
                point2d_idxs=p2d_idxs,
            )
    return points


# ----------------------------------------------------------------------------
# Writers — inverse of the readers; used by unit tests and dataset tooling.
# ----------------------------------------------------------------------------


def write_cameras_binary(cameras: dict[int, Camera], path: str | Path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id = _MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(images: dict[int, Image], path: str | Path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for img in images.values():
            f.write(struct.pack("<i", img.id))
            f.write(struct.pack("<4d", *img.qvec))
            f.write(struct.pack("<3d", *img.tvec))
            f.write(struct.pack("<i", img.camera_id))
            # Writers store the bare file name (no directory prefix).
            bare = img.name.rsplit("/", 1)[-1]
            f.write(bare.encode("latin-1") + b"\x00")
            f.write(struct.pack("<Q", len(img.point3d_ids)))
            for (x, y), pid in zip(img.xys, img.point3d_ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))


def write_points3d_binary(points: dict[int, Point3D], path: str | Path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q3d3Bd", p.id, *p.xyz, *p.rgb, p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for img_id, p2d in zip(p.image_ids, p.point2d_idxs):
                f.write(struct.pack("<ii", int(img_id), int(p2d)))


def compute_max_diagonal(images: dict[int, Image]) -> float:
    """Max distance of any camera center from the centroid."""
    if not images:
        return 0.0
    centers = np.stack([img.cam_pos() for img in images.values()])
    centroid = centers.mean(axis=0)
    return float(np.linalg.norm(centers - centroid, axis=1).max())
