"""The trainer's start from an SfM cloud: an isotropic log-scale from the
mean distance to the 3 nearest neighbours (0.01 where that is 0), colour
as the SH DC coefficient (rgb / 255 - 0.5) / Y00, opacity logit(0.2),
the identity quaternion, no higher SH bands; then the capacity bucket
(the next power of two from 4096 up to 2^22, then steps of 2^21)."""

from __future__ import annotations

import numpy as np
import torch

from .gaussians import SH_C0


def capacity(n: int, minimum: int = 4096) -> int:
    cap = minimum
    while cap < n and cap < (1 << 22):
        cap *= 2
    while cap < n:
        cap += 1 << 21
    return cap


def knn_mean_dist(xyz: np.ndarray, k: int = 3) -> np.ndarray:
    from scipy.spatial import cKDTree

    d, _ = cKDTree(xyz).query(xyz, k=k + 1, workers=-1)
    d = d[:, 1:]
    ok = np.isfinite(d)
    n = ok.sum(axis=1)
    mean = np.where(n > 0, np.where(ok, d, 0.0).sum(axis=1) / np.maximum(n, 1), 0.01)
    return mean.astype(np.float32)


def from_cloud(xyz: np.ndarray, rgb: np.ndarray, device) -> tuple[dict, torch.Tensor]:
    """(params padded to the capacity, alive) on ``device``."""
    n = xyz.shape[0]
    dist = knn_mean_dist(np.asarray(xyz, np.float64))
    dist = np.where(dist > 0, dist, 0.01).astype(np.float32)
    dc = (np.asarray(rgb, np.float32) / 255.0 - 0.5) / SH_C0
    quat = np.zeros((n, 4), np.float32)
    quat[:, 0] = 1.0
    cols = dict(xyz=xyz.astype(np.float32), rgb=dc.astype(np.float32),
                opacity=np.full((n,), np.log(0.2) - np.log(0.8), np.float32),
                scale=np.repeat(np.log(dist)[:, None], 3, axis=1).astype(np.float32),
                quat=quat, sh=np.zeros((n, 15, 3), np.float32))
    cap = capacity(n)
    params = {}
    for k, col in cols.items():
        t = torch.zeros((cap,) + col.shape[1:], dtype=torch.float32, device=device)
        t[:n] = torch.from_numpy(col).to(device)
        params[k] = t
    alive = torch.arange(cap, device=device) < n
    return params, alive
