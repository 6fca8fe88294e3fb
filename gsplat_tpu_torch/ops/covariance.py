"""3D covariance and 2D conic math (port of ``gsplat_tpu/ops/covariance.py``).

- ``sigma_from_quat_scale``: quaternion normalized by 1/(|q| + 1e-6), scales
  exponentiated, Sigma = (RS)(RS)^T as [xx xy xz yy yz zz].
- ``conic_and_radius``: conic = inverse of ``J W Sigma (J W)^T + 0.3 I``, and
  the binning record [r_major r_minor sin cos ell_scale] with the
  opacity-aware cut radius. The same scalarized formulas as the reference,
  in the same order, so the f32 results agree to rounding.
- ``mip_conic_and_radius``: the same with Mip-Splatting's 2D Mip filter in
  place of the 0.3 dilation, and its opacity factor (``ops/mip.py``).
"""

from __future__ import annotations

import math

import torch

_LOG255 = math.log(255.0)
DILATION = 0.3  # 3DGS's screen-space dilation, pixels^2


def sigma_from_quat_scale(quat: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(N,4) (w,x,y,z) quats + (N,3) log-scales -> (N,6) symmetric Sigma."""
    norm = torch.sqrt(torch.sum(quat * quat, dim=1))
    inv_norm = 1.0 / (norm + 1e-6)
    w = quat[:, 0] * inv_norm
    x = quat[:, 1] * inv_norm
    y = quat[:, 2] * inv_norm
    z = quat[:, 3] * inv_norm

    x2, y2, z2 = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z

    r00 = 1.0 - 2.0 * (y2 + z2)
    r01 = 2.0 * (xy - wz)
    r02 = 2.0 * (xz + wy)
    r10 = 2.0 * (xy + wz)
    r11 = 1.0 - 2.0 * (x2 + z2)
    r12 = 2.0 * (yz - wx)
    r20 = 2.0 * (xz - wy)
    r21 = 2.0 * (yz + wx)
    r22 = 1.0 - 2.0 * (x2 + y2)

    sx = torch.exp(scale[:, 0])
    sy = torch.exp(scale[:, 1])
    sz = torch.exp(scale[:, 2])

    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz

    s_xx = m00 * m00 + m01 * m01 + m02 * m02
    s_xy = m00 * m10 + m01 * m11 + m02 * m12
    s_xz = m00 * m20 + m01 * m21 + m02 * m22
    s_yy = m10 * m10 + m11 * m11 + m12 * m12
    s_yz = m10 * m20 + m11 * m21 + m12 * m22
    s_zz = m20 * m20 + m21 * m21 + m22 * m22
    return torch.stack([s_xx, s_xy, s_xz, s_yy, s_yz, s_zz], dim=1)


def _screen_cov(sigma: torch.Tensor, jac: torch.Tensor, view: torch.Tensor):
    """The screen covariance ``J W Sigma (J W)^T`` as its three columns
    (c00, c01, c11), undilated."""
    w3 = view[:3, :3]
    j00, j02 = jac[:, 0], jac[:, 2]
    j11, j12 = jac[:, 4], jac[:, 5]
    m0 = [j00 * w3[0, c] + j02 * w3[2, c] for c in range(3)]
    m1 = [j11 * w3[1, c] + j12 * w3[2, c] for c in range(3)]

    sxx, sxy, sxz = sigma[:, 0], sigma[:, 1], sigma[:, 2]
    syy, syz, szz = sigma[:, 3], sigma[:, 4], sigma[:, 5]

    def _sig_row(v):  # Sigma @ v for a row vector v (list of 3 (N,) cols)
        return [
            sxx * v[0] + sxy * v[1] + sxz * v[2],
            sxy * v[0] + syy * v[1] + syz * v[2],
            sxz * v[0] + syz * v[1] + szz * v[2],
        ]

    s_m0 = _sig_row(m0)
    s_m1 = _sig_row(m1)
    return (m0[0] * s_m0[0] + m0[1] * s_m0[1] + m0[2] * s_m0[2],
            m0[0] * s_m1[0] + m0[1] * s_m1[1] + m0[2] * s_m1[2],
            m1[0] * s_m1[0] + m1[1] * s_m1[1] + m1[2] * s_m1[2])


def _conic_radius(cov00, cov01, cov11, r_cut, mh_dist: float):
    """Conic and binning record of the dilated screen covariance, the cut
    radius ``r_cut`` in sigmas."""
    det = cov00 * cov11 - cov01 * cov01
    inv_det = 1.0 / det
    conic = torch.stack(
        [cov11 * inv_det, -cov01 * inv_det, cov00 * inv_det], dim=1
    )

    mid = 0.5 * (cov00 + cov11)
    lam_term = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam1 = mid + lam_term
    lam2 = mid - lam_term
    cut = torch.clamp(r_cut, max=mh_dist)
    r_major = torch.ceil(cut * torch.sqrt(torch.clamp(lam1, min=0.0)))
    r_minor = torch.ceil(cut * torch.sqrt(torch.clamp(lam2, min=0.0)))
    theta = 0.5 * torch.atan2(2.0 * cov01, cov00 - cov11)
    # Pad of the reference for its packed (bf16/f16) stream; kept so the
    # pair sets of both packages agree.
    kappa = lam1 / torch.clamp(lam2, min=1e-12)
    r_pad = torch.sqrt(r_cut * r_cut * (1.0 + kappa * (1.0 / 128.0)) + 0.1)
    ell_scale = torch.clamp(r_pad / torch.clamp(cut, min=1e-6), max=2.0)
    radius = torch.stack(
        [r_major, r_minor, torch.sin(theta), torch.cos(theta), ell_scale], dim=1
    )
    return conic, radius.detach()


def _log_opacity_cut(log_opacity_255: torch.Tensor) -> torch.Tensor:
    """alpha = opacity exp(-d^2/2) >= 1/255 <=> d^2 <= 2 ln(255 opacity):
    the cut radius in sigmas from ln(255 opacity)."""
    return torch.sqrt(torch.clamp(2.0 * log_opacity_255, min=0.0))


def conic_and_radius(
    sigma: torch.Tensor,
    jac: torch.Tensor,
    view: torch.Tensor,
    mh_dist: float,
    opacity_logit: torch.Tensor | None = None,
):
    """2D conic (inverse screen covariance) and binning radius record.

    Returns:
      conic: (N, 3) [c00 c01 c11] of inv(J W Sigma (J W)^T + 0.3 I).
      radius: (N, 5) [r_major r_minor sin_theta cos_theta ell_scale],
        detached. With ``opacity_logit`` the cut radius shrinks to the
        alpha = 1/255 isocontour, ``sqrt(2 ln(255 sigmoid(o)))`` sigmas;
        ``ell_scale`` is that isocontour (padded as in the reference) in
        units of the OBB radius, capped at 2.
    """
    c00, cov01, c11 = _screen_cov(sigma, jac, view)
    cov00 = c00 + DILATION
    cov11 = c11 + DILATION
    if opacity_logit is not None:
        softplus = torch.logaddexp(-opacity_logit, torch.zeros_like(opacity_logit))
        r_cut = _log_opacity_cut(_LOG255 - softplus)
    else:
        r_cut = torch.full_like(cov00, math.sqrt(2.0 * _LOG255))
    return _conic_radius(cov00, cov01, cov11, r_cut, mh_dist)


def mip_conic_and_radius(
    sigma: torch.Tensor,
    jac: torch.Tensor,
    view: torch.Tensor,
    mh_dist: float,
    opacity_logit: torch.Tensor,
    opacity_scale_3d: torch.Tensor,
    kernel: float,
):
    """Mip-Splatting's 2D Mip filter (``ops/mip.py``): the conic of
    ``J W Sigma (J W)^T + kernel I``, the opacity factor
    ``sqrt(det0 / (det1 + 1e-6) + 1e-6)`` (0 where either determinant is
    at its 1e-6 floor) and the binning record, whose cut radius is the
    1/255 isocontour of the filtered opacity ``sigmoid(o)
    opacity_scale_3d`` times that factor.

    Returns (conic (N, 3), radius (N, 5) detached, the opacity scale
    ``opacity_scale_3d`` x the 2D factor (N,))."""
    c00, cov01, c11 = _screen_cov(sigma, jac, view)
    det0 = torch.clamp(c00 * c11 - cov01 * cov01, min=1e-6)
    cov00 = c00 + kernel
    cov11 = c11 + kernel
    det1 = torch.clamp(cov00 * cov11 - cov01 * cov01, min=1e-6)
    coef = torch.sqrt(det0 / (det1 + 1e-6) + 1e-6)
    coef = torch.where((det0 <= 1e-6) | (det1 <= 1e-6), torch.zeros_like(coef), coef)
    opacity_scale = opacity_scale_3d * coef
    with torch.no_grad():
        softplus = torch.logaddexp(-opacity_logit, torch.zeros_like(opacity_logit))
        r_cut = _log_opacity_cut(_LOG255 - softplus + torch.log(opacity_scale))
    conic, radius = _conic_radius(cov00, cov01, cov11, r_cut, mh_dist)
    return conic, radius, opacity_scale
