"""Gaussian initialization from an SfM point cloud (port of
``gsplat_tpu/train/init.py``, numpy as there).

- isotropic log-scale from the mean distance to the 3 nearest neighbours
  (the C++ kd-tree of ``io/native.py``, built at first use; 0.01 where a
  point has none or sits on another);
- colour as the SH DC coefficient ``(rgb/255 - 0.5) / Y00``;
- opacity ``logit(0.2)``; identity quaternion.

With ``strict_reference=False`` the config's ``initial_opacity``,
``initial_scale_num_neighbors``, ``initial_scale_factor`` and
``max_initial_scale`` apply. ``knn_mean_dist_plain`` (scipy's
``cKDTree``) is the plain version the tests hold the native KNN against;
a failed build raises and never falls back to it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import ConfigParameters
from ..io import native

Y00 = 0.28209479177387814


@dataclasses.dataclass
class GaussianData:
    """Host-side struct-of-arrays Gaussian container."""

    xyz: np.ndarray  # (N, 3) float32
    rgb: np.ndarray  # (N, 3) float32 — SH DC coefficients
    opacity: np.ndarray  # (N,) float32 — logits
    scale: np.ndarray  # (N, 3) float32 — log-scales
    quaternion: np.ndarray  # (N, 4) float32 — (w, x, y, z)
    sh: np.ndarray | None = None  # (N, K, 3) float32 higher bands

    @property
    def num(self) -> int:
        return int(self.xyz.shape[0])

    def append(self, other: "GaussianData") -> "GaussianData":
        """Concatenate two containers; ``sh`` only if both have it."""
        if other.num == 0:
            return self
        sh = None
        if self.sh is not None and other.sh is not None:
            sh = np.concatenate([self.sh, other.sh], axis=0)
        return GaussianData(
            xyz=np.concatenate([self.xyz, other.xyz], axis=0),
            rgb=np.concatenate([self.rgb, other.rgb], axis=0),
            opacity=np.concatenate([self.opacity, other.opacity], axis=0),
            scale=np.concatenate([self.scale, other.scale], axis=0),
            quaternion=np.concatenate([self.quaternion, other.quaternion], axis=0),
            sh=sh,
        )

    def filter(self, mask: np.ndarray) -> "GaussianData":
        """Keep rows where mask is True."""
        mask = np.asarray(mask, dtype=bool)
        if mask.shape[0] != self.num:
            raise ValueError(f"mask has {mask.shape[0]} rows, expected {self.num}")
        return GaussianData(
            xyz=self.xyz[mask],
            rgb=self.rgb[mask],
            opacity=self.opacity[mask],
            scale=self.scale[mask],
            quaternion=self.quaternion[mask],
            sh=None if self.sh is None else self.sh[mask],
        )


def knn_mean_dist_plain(xyz: np.ndarray, k: int) -> np.ndarray:
    """Mean distance to each point's k nearest neighbours (self excluded),
    with scipy's ``cKDTree``: the plain version of
    ``io.native.knn_mean_dist``."""
    from scipy.spatial import cKDTree

    tree = cKDTree(xyz)
    # k+1 because the query point itself is returned at distance 0.
    dists, _ = tree.query(xyz, k=k + 1, workers=-1)
    neigh = dists[:, 1:]
    valid = np.isfinite(neigh)
    counts = valid.sum(axis=1)
    sums = np.where(valid, neigh, 0.0).sum(axis=1)
    mean = np.where(counts > 0, sums / np.maximum(counts, 1), 0.01)
    return mean.astype(np.float32)


def initialize_gaussians(
    points_xyz: np.ndarray,
    points_rgb: np.ndarray,
    config: ConfigParameters | None = None,
) -> GaussianData:
    """Initial Gaussians from SfM points: ``points_xyz`` (N, 3) float,
    ``points_rgb`` (N, 3) uint8 in [0, 255]."""
    xyz = np.asarray(points_xyz, dtype=np.float64)
    n = xyz.shape[0]
    if n == 0:
        return GaussianData(
            xyz=np.zeros((0, 3), np.float32),
            rgb=np.zeros((0, 3), np.float32),
            opacity=np.zeros((0,), np.float32),
            scale=np.zeros((0, 3), np.float32),
            quaternion=np.zeros((0, 4), np.float32),
        )

    strict = config is None or config.strict_reference
    k = 3 if strict else int(config.initial_scale_num_neighbors)
    opacity0 = 0.2 if strict else float(config.initial_opacity)

    avg_dist = native.knn_mean_dist(xyz, k)  # 0.01 for a lone point
    # A duplicated point has distance 0, whose log is -inf: 0.01 instead,
    # as for a point without neighbours.
    avg_dist = np.where(avg_dist > 0, avg_dist, 0.01).astype(np.float32)
    if not strict:
        avg_dist = avg_dist * float(config.initial_scale_factor)
        avg_dist = np.minimum(avg_dist, float(config.max_initial_scale))

    rgb01 = np.asarray(points_rgb, dtype=np.float32) / 255.0
    dc = (rgb01 - 0.5) / Y00

    quat = np.zeros((n, 4), dtype=np.float32)
    quat[:, 0] = 1.0

    return GaussianData(
        xyz=xyz.astype(np.float32),
        rgb=dc.astype(np.float32),
        opacity=np.full((n,), np.log(opacity0) - np.log(1.0 - opacity0), np.float32),
        scale=np.repeat(np.log(avg_dist)[:, None], 3, axis=1).astype(np.float32),
        quaternion=quat,
    )
