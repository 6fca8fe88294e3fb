"""Per-Gaussian forward: camera transform, projection, frustum cull,
covariance -> conic and binning radius, spherical-harmonic colour.

Dense over the Gaussian axis, differentiable by autograd; the same
formulas and epsilons as the measured step, in full float32 (matrix
products and convolutions without TF32). ``low`` computes the chain in
bfloat16 and hands float32 back: the precision control.
"""

from __future__ import annotations

import dataclasses
import math

import torch

LOG255 = math.log(255.0)
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, 1.0925484305920792, 0.31539156525252005,
         1.0925484305920792, 0.5462742152960396)
SH_C3 = (0.5900435899266435, 2.890611442640554, 0.4570457994644658,
         0.3731763325901154, 0.4570457994644658, 1.445305721320277,
         0.5900435899266435)
PARAMS = ("xyz", "rgb", "opacity", "scale", "quat", "sh")


@dataclasses.dataclass(frozen=True)
class Statics:
    """What one step needs besides its inputs: the image, the intrinsics,
    the config's thresholds and learning rates."""

    width: int
    height: int
    tile: int
    l_max: int
    focal_x: float
    focal_y: float
    tan_fovx: float
    tan_fovy: float
    near_thresh: float
    mh_dist: float
    cull_padding: int
    ssim_frac: float
    base_lr: float
    xyz_lr_init: float
    xyz_lr_final: float
    quat_lr: float
    scale_lr: float
    opacity_lr: float
    rgb_lr: float
    sh_lr: float
    scene_extent: float
    num_iters: int

    @property
    def tiles_x(self) -> int:
        return (self.width + self.tile - 1) // self.tile

    @property
    def tiles_y(self) -> int:
        return (self.height + self.tile - 1) // self.tile


def full_f32():
    """Matrix products and convolutions in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _safe(x, eps=1e-12):
    signed = torch.where(x < 0, torch.full_like(x, -eps), torch.full_like(x, eps))
    return torch.where(x.abs() < eps, signed, x)


def _conic_radius(sigma, jac, view, mh_dist, opacity_logit):
    w3 = view[:3, :3]
    j00, j02, j11, j12 = jac[:, 0], jac[:, 2], jac[:, 4], jac[:, 5]
    m0 = [j00 * w3[0, c] + j02 * w3[2, c] for c in range(3)]
    m1 = [j11 * w3[1, c] + j12 * w3[2, c] for c in range(3)]
    sxx, sxy, sxz, syy, syz, szz = (sigma[:, k] for k in range(6))

    def sig(v):
        return [sxx * v[0] + sxy * v[1] + sxz * v[2],
                sxy * v[0] + syy * v[1] + syz * v[2],
                sxz * v[0] + syz * v[1] + szz * v[2]]

    s0, s1 = sig(m0), sig(m1)
    cov00 = m0[0] * s0[0] + m0[1] * s0[1] + m0[2] * s0[2] + 0.3
    cov01 = m0[0] * s1[0] + m0[1] * s1[1] + m0[2] * s1[2]
    cov11 = m1[0] * s1[0] + m1[1] * s1[1] + m1[2] * s1[2] + 0.3
    det = cov00 * cov11 - cov01 * cov01
    inv_det = 1.0 / det
    conic = torch.stack([cov11 * inv_det, -cov01 * inv_det, cov00 * inv_det], dim=1)
    mid = 0.5 * (cov00 + cov11)
    lam_term = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam1, lam2 = mid + lam_term, mid - lam_term
    softplus = torch.logaddexp(-opacity_logit, torch.zeros_like(opacity_logit))
    r_cut = torch.sqrt(torch.clamp(2.0 * (LOG255 - softplus), min=0.0))
    cut = torch.clamp(r_cut, max=mh_dist)
    r_major = torch.ceil(cut * torch.sqrt(torch.clamp(lam1, min=0.0)))
    r_minor = torch.ceil(cut * torch.sqrt(torch.clamp(lam2, min=0.0)))
    theta = 0.5 * torch.atan2(2.0 * cov01, cov00 - cov11)
    kappa = lam1 / torch.clamp(lam2, min=1e-12)
    r_pad = torch.sqrt(r_cut * r_cut * (1.0 + kappa * (1.0 / 128.0)) + 0.1)
    ell = torch.clamp(r_pad / torch.clamp(cut, min=1e-6), max=2.0)
    radius = torch.stack([r_major, r_minor, torch.sin(theta), torch.cos(theta), ell], dim=1)
    return conic, radius.detach()


def _sigma(quat, scale):
    inv = 1.0 / (torch.sqrt(torch.sum(quat * quat, dim=1)) + 1e-6)
    w, x, y, z = (quat[:, k] * inv for k in range(4))
    x2, y2, z2, xy, xz, yz = x * x, y * y, z * z, x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = [[1.0 - 2.0 * (y2 + z2), 2.0 * (xy - wz), 2.0 * (xz + wy)],
         [2.0 * (xy + wz), 1.0 - 2.0 * (x2 + z2), 2.0 * (yz - wx)],
         [2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (x2 + y2)]]
    s = [torch.exp(scale[:, k]) for k in range(3)]
    m = [[r[i][j] * s[j] for j in range(3)] for i in range(3)]

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    return torch.stack([dot(m[0], m[0]), dot(m[0], m[1]), dot(m[0], m[2]),
                        dot(m[1], m[1]), dot(m[1], m[2]), dot(m[2], m[2])], dim=1)


def _sh_rgb(xyz, dc, sh, campos, l_max):
    diff = xyz - campos[None, :]
    d = diff / (torch.sqrt(torch.sum(diff * diff, dim=1)) + 1e-9)[:, None]
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    basis = [torch.full_like(x, SH_C0)]
    if l_max >= 1:
        basis += [SH_C1 * y, SH_C1 * z, SH_C1 * x]
    if l_max >= 2:
        xx, yy, zz = x * x, y * y, z * z
        basis += [SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (3.0 * zz - 1.0),
                  SH_C2[3] * x * z, SH_C2[4] * (xx - yy)]
    if l_max >= 3:
        xx, yy, zz = x * x, y * y, z * z
        basis += [SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * x * y * z,
                  SH_C3[2] * y * (5.0 * zz - 1.0), SH_C3[3] * z * (5.0 * zz - 3.0),
                  SH_C3[4] * x * (5.0 * zz - 1.0), SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3.0 * yy)]
    b = torch.stack(basis, dim=1)
    rgb = dc * b[:, :1] + 0.5
    k = (l_max + 1) ** 2
    if k > 1:
        rgb = rgb + torch.einsum("nk,nkc->nc", b[:, 1:], sh[:, : k - 1, :])
    return rgb


def per_gaussian(p: dict, alive, view, proj, campos, st: Statics, low: bool = False):
    """(uv, conic, rgb, mask, radius, z) of every Gaussian of ``p`` (a dict
    of the six parameter tensors) for one camera."""
    if low:
        p = {k: v.to(torch.bfloat16) for k, v in p.items()}
        view, proj, campos = (t.to(torch.bfloat16) for t in (view, proj, campos))
    xyz_c = p["xyz"] @ view[:3, :3].T + view[:3, 3]
    hom = torch.cat([xyz_c, torch.ones_like(xyz_c[:, :1])], dim=1)
    clip = hom @ proj.T
    denom = _safe(clip[:, 3] + 1e-6, 1e-8)
    uv = torch.stack([(clip[:, 0] / denom * 0.5 + 0.5) * st.width,
                      (clip[:, 1] / denom * 0.5 + 0.5) * st.height], dim=1)
    x, y, z = xyz_c[:, 0], xyz_c[:, 1], xyz_c[:, 2]
    pad = st.cull_padding
    mask = ((z >= st.near_thresh) & (uv[:, 0] >= -pad) & (uv[:, 0] <= st.width + pad)
            & (uv[:, 1] >= -pad) & (uv[:, 1] <= st.height + pad) & alive)
    zs = _safe(z, 1e-6)
    xc = torch.clamp(x / zs, -1.3 * st.tan_fovx, 1.3 * st.tan_fovx) * zs
    yc = torch.clamp(y / zs, -1.3 * st.tan_fovy, 1.3 * st.tan_fovy) * zs
    j00, j11 = st.focal_x / zs, st.focal_y / zs
    j02 = -(st.focal_x * xc) / (zs * zs)
    j12 = -(st.focal_y * yc) / (zs * zs)
    zero = torch.zeros_like(j00)
    jac = torch.stack([j00, zero, j02, zero, j11, j12], dim=1)
    jac = torch.where((z.abs() < 1e-6)[:, None], torch.zeros_like(jac), jac)
    sigma = _sigma(p["quat"], p["scale"])
    conic, radius = _conic_radius(sigma, jac, view, st.mh_dist, p["opacity"])
    rgb = _sh_rgb(p["xyz"], p["rgb"], p["sh"], campos, st.l_max)
    out = (uv, conic, rgb, mask, radius, z)
    if low:
        out = tuple(t if t.dtype == torch.bool else t.to(torch.float32) for t in out)
    return out


def pack_attrs(uv, conic, rgb, opacity_logit):
    """(N, 9) rows [u v c00 c01 c11 sigmoid(o) r g b], differentiable."""
    opa = torch.sigmoid(opacity_logit)
    return torch.stack([uv[:, 0], uv[:, 1], conic[:, 0], conic[:, 1], conic[:, 2], opa,
                        rgb[:, 0], rgb[:, 1], rgb[:, 2]], dim=1).contiguous()
