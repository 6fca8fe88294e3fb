"""Per-Gaussian projection math (port of ``gsplat_tpu/ops/projection.py``).

Dense over the Gaussian axis, same formulas and epsilons as the reference:
``xyz_c = R xyz + t``; clip -> NDC with ``/(w + 1e-6)`` -> pixel
``(ndc*0.5+0.5)*W``; the projection Jacobian with the 1.3*tan_fov clamp and
the |z| < 1e-6 zero guard. The two matrix products must run in full f32
(no TF32): callers on the card keep ``torch.backends.cuda.matmul.allow_tf32``
off, which is PyTorch's default.
"""

from __future__ import annotations

import torch


def _safe(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Replace near-zero denominators by +-eps (sign kept)."""
    signed = torch.where(x < 0, torch.full_like(x, -eps), torch.full_like(x, eps))
    return torch.where(x.abs() < eps, signed, x)


def world_to_camera(xyz: torch.Tensor, view: torch.Tensor) -> torch.Tensor:
    """(N,3) world points -> (N,3) camera-space points."""
    return xyz @ view[:3, :3].T + view[:3, 3]


def project_to_screen(
    xyz_c: torch.Tensor, proj: torch.Tensor, width: int, height: int
) -> torch.Tensor:
    """(N,3) camera points -> (N,2) pixel coordinates."""
    ones = torch.ones_like(xyz_c[:, :1])
    hom = torch.cat([xyz_c, ones], dim=1)  # (N, 4)
    clip = hom @ proj.T  # (N, 4)
    denom = _safe(clip[:, 3] + 1e-6, 1e-8)
    x_ndc = clip[:, 0] / denom
    y_ndc = clip[:, 1] / denom
    u = (x_ndc * 0.5 + 0.5) * width
    v = (y_ndc * 0.5 + 0.5) * height
    return torch.stack([u, v], dim=1)


def projection_jacobian(
    xyz_c: torch.Tensor,
    focal_x: float,
    focal_y: float,
    tan_fovx: float,
    tan_fovy: float,
) -> torch.Tensor:
    """Pinhole Jacobian, (N, 6) rows [J00 J01 J02 J10 J11 J12]."""
    x, y, z = xyz_c[:, 0], xyz_c[:, 1], xyz_c[:, 2]
    degenerate = z.abs() < 1e-6
    zs = _safe(z, 1e-6)

    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    xc = torch.clamp(x / zs, -limx, limx) * zs
    yc = torch.clamp(y / zs, -limy, limy) * zs

    j00 = focal_x / zs
    j02 = -(focal_x * xc) / (zs * zs)
    j11 = focal_y / zs
    j12 = -(focal_y * yc) / (zs * zs)
    zero = torch.zeros_like(j00)
    jac = torch.stack([j00, zero, j02, zero, j11, j12], dim=1)
    return torch.where(degenerate[:, None], torch.zeros_like(jac), jac)


def frustum_cull_mask(
    uv: torch.Tensor,
    xyz_c: torch.Tensor,
    near_thresh: float,
    padding: int,
    width: int,
    height: int,
) -> torch.Tensor:
    """Keep-mask: z >= near AND uv within image +- padding."""
    u, v = uv[:, 0], uv[:, 1]
    z = xyz_c[:, 2]
    in_frame = (
        (u >= -padding) & (u <= width + padding)
        & (v >= -padding) & (v <= height + padding)
    )
    return (z >= near_thresh) & in_frame
