"""Real spherical harmonics up to l=3 (port of ``gsplat_tpu/ops/sh.py``).

Orthonormal real SH in the graphics sign convention, ordered by (l, m) with
index l^2 + l + m. ``rgb = dc * Y0 + 0.5 + sum_i coeff_i * Y_i`` with no
clamp, view direction ``normalize(xyz - campos)`` with +1e-9 on the length.
"""

from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, 1.0925484305920792, 0.31539156525252005,
       1.0925484305920792, 0.5462742152960396)
_C3 = (0.5900435899266435, 2.890611442640554, 0.4570457994644658,
       0.3731763325901154, 0.4570457994644658, 1.445305721320277,
       0.5900435899266435)

Y00 = _C0


def num_sh_coeffs(l_max: int) -> int:
    return (l_max + 1) * (l_max + 1)


def sh_basis(dirs: torch.Tensor, l_max: int) -> torch.Tensor:
    """SH basis values for unit directions. (N, 3) -> (N, (l_max+1)^2)."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    out = [torch.full_like(x, _C0)]
    if l_max >= 1:
        out += [_C1 * y, _C1 * z, _C1 * x]
    if l_max >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [
            _C2[0] * x * y,
            _C2[1] * y * z,
            _C2[2] * (3.0 * zz - 1.0),
            _C2[3] * x * z,
            _C2[4] * (xx - yy),
        ]
    if l_max >= 3:
        xx, yy, zz = x * x, y * y, z * z
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * x * y * z,
            _C3[2] * y * (5.0 * zz - 1.0),
            _C3[3] * z * (5.0 * zz - 3.0),
            _C3[4] * x * (5.0 * zz - 1.0),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=1)


def view_dirs(xyz: torch.Tensor, campos: torch.Tensor) -> torch.Tensor:
    """normalize(xyz - campos) with the reference's +1e-9 length epsilon."""
    diff = xyz - campos[None, :]
    length = torch.sqrt(torch.sum(diff * diff, dim=1)) + 1e-9
    return diff / length[:, None]


def sh_to_rgb(
    xyz: torch.Tensor,
    dc: torch.Tensor,
    sh: torch.Tensor,
    campos: torch.Tensor,
    l_max: int,
) -> torch.Tensor:
    """Per-Gaussian view-dependent colour.

    Args:
      xyz: (N, 3) world positions. dc: (N, 3) band-0 coefficients.
      sh: (N, 15, 3) higher-band coefficients (bands beyond l_max ignored).
      campos: (3,) camera center. l_max: active SH degree, 0..3.

    Returns:
      (N, 3) colours = dc*Y0 + 0.5 + sum coeffs*Y (no clamp).
    """
    dirs = view_dirs(xyz, campos)
    basis = sh_basis(dirs, l_max)  # (N, K)
    rgb = dc * basis[:, :1] + 0.5
    k = num_sh_coeffs(l_max)
    if k > 1:
        rgb = rgb + torch.einsum("nk,nkc->nc", basis[:, 1:], sh[:, : k - 1, :])
    return rgb
