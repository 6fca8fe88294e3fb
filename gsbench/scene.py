"""Inputs made from the seed: the scene, the camera path, the SfM cloud.

The scene is the recipe of ``chip_smoke.py::scene_arrays`` (``:556``, the
JAX package's bench scene): centres N(0, diag(2, 1.4, 1.2)^2) around
(0, 0, 6), colour DC N(0, 1), opacity logits U(-1, 2), log-scales of
U(0.004, 0.04) x (1e6 / n)^0.33 x ``scale_mul``, quaternions (1, 0.2 N(0,
1)^3), SH bands N(0, 0.1^2); the perturbed copy a run trains from adds
N(0, 0.3^2) to the colours and -0.5 to the opacity logits. It is drawn on
the device with a ``torch.Generator`` in two calls, so a seed gives the
same scene on the same card. The cameras are ``chip_smoke.py::
trainer_cameras``' (``:1376``): centres on a circle of radius 1.5 in the
z = 0 plane, each looking at (0, 0, 6), focal 0.85 W. The cloud is
``sfm_cloud``'s (``:2371``): the scene's centres plus N(0, 0.05^2), uint8
colours of its DC. ``scale_mul`` 0.97 and the 4.25M configuration's caps
are ``gsplat_tpu_torch/tools/bench_scale.py``'s (``:42-43``, the JAX
package's ``scripts/bench_scale.py``).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from .reference import camera as refcam
from .reference.gaussians import SH_C0
from .reference.init import capacity


def mix(seed: int, salt: str) -> int:
    """A 63-bit generator seed from the run's seed and a purpose."""
    h = hashlib.sha256(f"{int(seed)}/{salt}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def gaussians(n: int, seed: int, device, scale_mul: float = 1.0,
              perturb: bool = False) -> tuple[dict, torch.Tensor]:
    """(the six parameters padded to the capacity bucket of n, alive)."""
    cap = capacity(n)
    gen = torch.Generator(device=device)
    gen.manual_seed(mix(seed, "scene"))
    nrm = torch.randn((n, 54), generator=gen, device=device)
    uni = torch.rand((n, 4), generator=gen, device=device)
    xyz = nrm[:, 0:3] * torch.tensor([2.0, 1.4, 1.2], device=device)
    xyz[:, 2] += 6.0
    rgb = nrm[:, 3:6]
    quat = torch.cat([torch.ones((n, 1), device=device), 0.2 * nrm[:, 6:9]], dim=1)
    sh = 0.1 * nrm[:, 9:54].reshape(n, 15, 3)
    opacity = uni[:, 0] * 3.0 - 1.0
    scale = torch.log((0.004 + 0.036 * uni[:, 1:4]) * ((1e6 / n) ** 0.33 * scale_mul))
    if perturb:
        gen.manual_seed(mix(seed, "perturb"))
        rgb = rgb + 0.3 * torch.randn((n, 3), generator=gen, device=device)
        opacity = opacity - 0.5
    params = {}
    for k, col in dict(xyz=xyz, rgb=rgb, opacity=opacity, scale=scale, quat=quat, sh=sh).items():
        t = torch.zeros((cap,) + tuple(col.shape[1:]), device=device)
        t[:n] = col
        params[k] = t
    return params, torch.arange(cap, device=device) < n


def circle_pose(angle: float) -> tuple[np.ndarray, np.ndarray]:
    """COLMAP (qvec, tvec) of a camera on the circle looking at (0, 0, 6)."""
    centre = np.array([1.5 * math.cos(angle), 1.5 * math.sin(angle), 0.0])
    fwd = np.array([0.0, 0.0, 6.0]) - centre
    fwd /= np.linalg.norm(fwd)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    rot = np.stack([right, np.cross(fwd, right), fwd])
    return refcam.rotmat_to_qvec(rot), -rot @ centre


def training_angles(views: int) -> list:
    return [2 * math.pi * i / views for i in range(views)]


def novel_angles(views: int, between: int) -> list:
    """``between`` poses spaced evenly between each pair of neighbouring
    training views, none on one."""
    return [2 * math.pi * (i + (j + 1) / (between + 1)) / views
            for i in range(views) for j in range(between)]


def cameras(angles, width: int, height: int, focal: float) -> list:
    return [refcam.camera(*circle_pose(a), width, height, focal, focal) for a in angles]


def scene_extent(cams) -> float:
    """The trainer's: 1.1 x the largest camera-centre distance from the
    centroid."""
    c = np.stack([cam.centre for cam in cams])
    return 1.1 * float(np.linalg.norm(c - c.mean(axis=0), axis=1).max())


def sfm_cloud(params: dict, n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(xyz float64 (n, 3), rgb uint8 (n, 3)) of the scene's first n."""
    gen = torch.Generator(device=params["xyz"].device)
    gen.manual_seed(mix(seed, "cloud"))
    jitter = 0.05 * torch.randn((n, 3), generator=gen, device=params["xyz"].device)
    xyz = (params["xyz"][:n] + jitter).double().cpu().numpy()
    rgb = torch.clamp((params["rgb"][:n] * SH_C0 + 0.5) * 255, 0, 255).to(torch.uint8)
    return xyz, rgb.cpu().numpy()
