"""The per-Gaussian covariance and its screen conic, and their gradient.

``covariance`` is ``ops/projection.py::projection_jacobian``,
``ops/covariance.py::sigma_from_quat_scale`` and ``conic_and_radius`` or,
under Mip-Splatting (``filter_3d`` given), ``ops/mip.py::filtered_sigma``,
``opacity_scale_3d`` and ``ops/covariance.py::mip_conic_and_radius``. On CPU
tensors it runs those ops (``covariance_plain``), autograd through them. On
CUDA tensors it is one ``torch.autograd.Function`` over ``csrc/covariance.cu``:
the forward writes the conic, the radius record and, under Mip-Splatting, the
opacity scale in one pass, bit-equal to the plain ops on the card; the
backward recomputes the forward from the saved inputs (xyz_c, quat, scale,
filter_3d, the view) and writes the gradients of xyz_c, quat and scale in one
pass, within f32 rounding of autograd through the plain ops
(``covariance_backward_plain`` is its plain version). The view's rotation is
read from device memory, so a CUDA graph's replay takes the view's camera.
Counted as ``_build.launches["covariance_forward"]`` and
``["covariance_backward"]``.
"""

from __future__ import annotations

import torch

from ..ops import covariance as cov_ops
from ..ops import mip, projection
from . import _build


def covariance_plain(xyz_c, quat, scale, opacity, view, *, focal_x, focal_y, tan_fovx,
                     tan_fovy, mh_dist, filter_3d=None):
    """The plain ops: (conic (N, 3), radius (N, 5) detached, opacity scale
    (N,) under Mip-Splatting, else None)."""
    jac = projection.projection_jacobian(xyz_c, focal_x, focal_y, tan_fovx, tan_fovy)
    sigma = cov_ops.sigma_from_quat_scale(quat, scale)
    if filter_3d is None:
        return (*cov_ops.conic_and_radius(sigma, jac, view, mh_dist, opacity_logit=opacity),
                None)
    return cov_ops.mip_conic_and_radius(
        mip.filtered_sigma(sigma, filter_3d), jac, view, mh_dist, opacity,
        mip.opacity_scale_3d(scale, filter_3d), mip.KERNEL_2D)


def _rotation(n: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotations of normalised (w, x, y, z) quaternions."""
    w, x, y, z = n.unbind(1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=1).reshape(-1, 3, 3)


def _rotation_vjp(n: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(N, 4): the gradient of ``_rotation(n)`` given ``g`` (N, 3, 3)."""
    w, x, y, z = n.unbind(1)
    g = g.reshape(-1, 9)
    g00, g01, g02, g10, g11, g12, g20, g21, g22 = g.unbind(1)
    return torch.stack([
        2 * (z * (g10 - g01) + y * (g02 - g20) + x * (g21 - g12)),
        2 * (y * (g01 + g10) + z * (g02 + g20) + w * (g21 - g12)) - 4 * x * (g11 + g22),
        2 * (x * (g01 + g10) + w * (g02 - g20) + z * (g12 + g21)) - 4 * y * (g00 + g22),
        2 * (w * (g10 - g01) + x * (g02 + g20) + y * (g12 + g21)) - 4 * z * (g00 + g11),
    ], dim=1)


def covariance_backward_plain(g_conic, g_opacity_scale, xyz_c, quat, scale, view, *,
                              focal_x, focal_y, tan_fovx, tan_fovy, filter_3d=None):
    """Plain PyTorch version of the backward kernel: the gradients of
    ``covariance_plain``'s conic and (under Mip-Splatting) opacity scale
    with respect to (xyz_c, quat, scale), given their gradients ``g_conic``
    (N, 3), any strides, and ``g_opacity_scale`` (N,) or None. In matrix
    form: T = J W (N, 2, 3), cov = T Sigma T^T + k I; radius and the
    opacity logit carry no gradient."""
    k = cov_ops.DILATION if filter_3d is None else mip.KERNEL_2D
    x, y, z = xyz_c.unbind(1)
    degenerate = z.abs() < 1e-6
    zs = projection._safe(z, 1e-6)
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    tx, ty = x / zs, y / zs
    txc, tyc = torch.clamp(tx, -limx, limx), torch.clamp(ty, -limy, limy)
    zero = torch.zeros_like(z)
    jac = torch.stack([focal_x / zs, zero, -focal_x * txc / zs,
                       zero, focal_y / zs, -focal_y * tyc / zs], dim=1).reshape(-1, 2, 3)
    jac = torch.where(degenerate[:, None, None], 0.0, jac)
    w3 = view[:3, :3]
    t = jac @ w3  # (N, 2, 3)

    norm = torch.sqrt(torch.sum(quat * quat, dim=1))
    inv = 1.0 / (norm + 1e-6)
    n = quat * inv[:, None]
    r = _rotation(n)
    e = torch.exp(scale)
    m = r * e[:, None, :]
    sigma = m @ m.transpose(1, 2)
    if filter_3d is not None:
        eye = torch.eye(3, dtype=m.dtype, device=m.device)
        sigma = sigma + (filter_3d * filter_3d)[:, None, None] * eye
    c = t @ sigma @ t.transpose(1, 2)
    c00, c01, c11 = c[:, 0, 0], c[:, 0, 1], c[:, 1, 1]
    cov00, cov11 = c00 + k, c11 + k

    # conic = [cov11, -cov01, cov00] / det
    ga, gb, gc = g_conic.unbind(1)
    inv_det = 1.0 / (cov00 * cov11 - c01 * c01)
    g_det = -(ga * cov11 - gb * c01 + gc * cov00) * inv_det * inv_det
    g_cov00 = gc * inv_det + g_det * cov11
    g_cov11 = ga * inv_det + g_det * cov00
    g_c01 = -gb * inv_det - 2 * g_det * c01
    g_scale = torch.zeros_like(scale)
    if filter_3d is not None:
        raw0 = c00 * c11 - c01 * c01
        raw1 = cov00 * cov11 - c01 * c01
        det0, det1 = raw0.clamp(min=1e-6), raw1.clamp(min=1e-6)
        d1e = det1 + 1e-6
        coef = torch.sqrt(det0 / d1e + 1e-6)
        floor = (det0 <= 1e-6) | (det1 <= 1e-6)
        # os3 = sqrt(prod_j s2_j / (s2_j + f^2)), s2 = e^2s: d os3 / d s_j =
        # os3 f^2 / (s2_j + f^2)
        s2 = torch.exp(2 * scale)
        f2 = (filter_3d * filter_3d)[:, None]
        os3 = torch.sqrt(torch.prod(s2 / (s2 + f2), dim=1))
        g_u = torch.where(floor, 0.0, g_opacity_scale * os3) / (2 * coef)
        g_raw0 = torch.where(raw0 >= 1e-6, g_u / d1e, 0.0)
        g_raw1 = torch.where(raw1 >= 1e-6, -g_u * (det0 / d1e / d1e), 0.0)
        g_cov00 = g_cov00 + g_raw0 * c11 + g_raw1 * cov11
        g_cov11 = g_cov11 + g_raw0 * c00 + g_raw1 * cov00
        g_c01 = g_c01 - 2 * c01 * (g_raw0 + g_raw1)
        g_os3 = torch.where(floor, 0.0, g_opacity_scale * coef)
        g_scale = (g_os3 * os3)[:, None] * f2 / (s2 + f2)

    # the gradient of the 2 x 2 screen covariance, its off-diagonal split in two
    h = torch.stack([g_cov00, 0.5 * g_c01, 0.5 * g_c01, g_cov11], dim=1).reshape(-1, 2, 2)
    g_t = 2 * h @ t @ sigma
    g_sigma = t.transpose(1, 2) @ h @ t  # symmetric
    g_m = 2 * g_sigma @ m
    g_r = g_m * e[:, None, :]
    g_scale = g_scale + torch.sum(g_m * r, dim=1) * e
    g_n = _rotation_vjp(n, g_r)
    g_inv = torch.sum(g_n * quat, dim=1)
    g_sq = -g_inv * inv * inv / (2 * norm)
    g_quat = g_n * inv[:, None] + 2 * g_sq[:, None] * quat

    g_jac = torch.where(degenerate[:, None, None], 0.0, g_t @ w3.T)  # (N, 2, 3)
    g_j00, g_j02, g_j11, g_j12 = g_jac[:, 0, 0], g_jac[:, 0, 2], g_jac[:, 1, 1], g_jac[:, 1, 2]
    g_txc = -(g_j02 * focal_x) / zs
    g_tyc = -(g_j12 * focal_y) / zs
    g_tx = torch.where((tx >= -limx) & (tx <= limx), g_txc, 0.0)
    g_ty = torch.where((ty >= -limy) & (ty <= limy), g_tyc, 0.0)
    g_zs = ((-(g_j00 * focal_x + g_j11 * focal_y) + g_j02 * focal_x * txc
             + g_j12 * focal_y * tyc) / (zs * zs) - (g_tx * tx + g_ty * ty) / zs)
    g_xyz_c = torch.stack([g_tx / zs, g_ty / zs, torch.where(degenerate, 0.0, g_zs)], dim=1)
    return g_xyz_c, g_quat, g_scale


def _consts(focal_x, focal_y, tan_fovx, tan_fovy, mh_dist, mip_model: bool) -> tuple:
    """The kernels' constants, as the plain ops round them to f32: fx, fy,
    1.3 tan-fov in x and y, mh_dist, the screen dilation, ln 255."""
    return (focal_x, focal_y, 1.3 * tan_fovx, 1.3 * tan_fovy, mh_dist,
            mip.KERNEL_2D if mip_model else cov_ops.DILATION, cov_ops._LOG255)


def _check(xyz_c, quat, scale, opacity, view, filter_3d) -> None:
    name = "covariance"
    n = xyz_c.shape[0] if xyz_c.dim() else -1
    want = {"xyz_c": (xyz_c, (n, 3)), "quat": (quat, (n, 4)), "scale": (scale, (n, 3)),
            "opacity": (opacity, (n,))}
    if filter_3d is not None:
        want["filter_3d"] = (filter_3d, (n,))
    for label, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} must be float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if view.dtype != torch.float32 or tuple(view.shape) != (4, 4):
        raise ValueError(f"{name}: view must be float32 (4, 4), got {view.dtype} "
                         f"{tuple(view.shape)}")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _forward_launch(xyz_c, quat, scale, opacity, filter_3d, view, consts):
    n, dev = xyz_c.shape[0], xyz_c.device
    conic = torch.empty((n, 3), dtype=torch.float32, device=dev)
    radius = torch.empty((n, 5), dtype=torch.float32, device=dev)
    opacity_scale = None if filter_3d is None else torch.empty_like(opacity)
    err = _build.build().gs_covariance_forward(
        conic.data_ptr(), radius.data_ptr(), _ptr(opacity_scale), xyz_c.data_ptr(),
        quat.data_ptr(), scale.data_ptr(), opacity.data_ptr(), _ptr(filter_3d),
        view.data_ptr(), n, filter_3d is not None, *consts, _build.stream_ptr(dev))
    _build.check(err, "covariance_forward")
    _build.launches["covariance_forward"] += 1
    return conic, radius, opacity_scale


def _backward_launch(g_conic, g_opacity_scale, xyz_c, quat, scale, filter_3d, view, consts):
    name = "covariance_backward"
    n, dev = xyz_c.shape[0], xyz_c.device
    if g_conic.dtype != torch.float32 or tuple(g_conic.shape) != (n, 3) or g_conic.device != dev:
        raise ValueError(f"{name}: the conic's gradient must be float32 ({n}, 3) on {dev}, "
                         f"got {g_conic.dtype} {tuple(g_conic.shape)} on {g_conic.device}")
    if filter_3d is not None:
        g_opacity_scale = g_opacity_scale.contiguous()
    grad_xyz_c, grad_quat, grad_scale = (torch.empty_like(t) for t in (xyz_c, quat, scale))
    err = _build.build().gs_covariance_backward(
        grad_xyz_c.data_ptr(), grad_quat.data_ptr(), grad_scale.data_ptr(), g_conic.data_ptr(),
        g_conic.stride(0), g_conic.stride(1),
        None if filter_3d is None else g_opacity_scale.data_ptr(), xyz_c.data_ptr(),
        quat.data_ptr(), scale.data_ptr(), _ptr(filter_3d), view.data_ptr(), n,
        filter_3d is not None, *consts, _build.stream_ptr(dev))
    _build.check(err, name)
    _build.launches[name] += 1
    return grad_xyz_c, grad_quat, grad_scale


class _Covariance(torch.autograd.Function):
    """(xyz_c, quat, scale, opacity, filter_3d or None, view) -> (conic,
    radius[, opacity scale]); differentiable in xyz_c, quat and scale."""

    @staticmethod
    def forward(ctx, xyz_c, quat, scale, opacity, filter_3d, view, consts):
        ctx.save_for_backward(xyz_c, quat, scale, filter_3d, view)
        ctx.consts = consts
        conic, radius, opacity_scale = _forward_launch(xyz_c, quat, scale, opacity, filter_3d,
                                                       view, consts)
        ctx.mark_non_differentiable(radius)
        return (conic, radius) if opacity_scale is None else (conic, radius, opacity_scale)

    @staticmethod
    def backward(ctx, g_conic, g_radius, g_opacity_scale=None):
        xyz_c, quat, scale, filter_3d, view = ctx.saved_tensors
        grads = _backward_launch(g_conic, g_opacity_scale, xyz_c, quat, scale, filter_3d, view,
                                 ctx.consts)
        return (*grads, None, None, None, None)


def covariance(xyz_c: torch.Tensor, quat: torch.Tensor, scale: torch.Tensor,
               opacity: torch.Tensor, view: torch.Tensor, *, focal_x: float, focal_y: float,
               tan_fovx: float, tan_fovy: float, mh_dist: float,
               filter_3d: torch.Tensor | None = None):
    """The conic (N, 3), the binning record (N, 5), detached, and under
    Mip-Splatting (``filter_3d`` (N,) given) the opacity scale (N,), else
    None, of camera-space points ``xyz_c`` (N, 3), quaternions ``quat``
    (N, 4), log-scales ``scale`` (N, 3) and opacity logits ``opacity``
    (N,), all float32 and contiguous, seen through the (4, 4) ``view``
    matrix with the given intrinsics. A CPU tensor takes
    ``covariance_plain``; CUDA tensors the kernels, differentiable in
    xyz_c, quat and scale."""
    _check(xyz_c, quat, scale, opacity, view, filter_3d)
    kw = dict(focal_x=focal_x, focal_y=focal_y, tan_fovx=tan_fovx, tan_fovy=tan_fovy)
    if xyz_c.device.type == "cpu":
        return covariance_plain(xyz_c, quat, scale, opacity, view, mh_dist=mh_dist,
                                filter_3d=filter_3d, **kw)
    view = view.contiguous()
    _build.require_cuda("covariance", xyz_c, quat, scale, opacity, view,
                        *([] if filter_3d is None else [filter_3d]))
    out = _Covariance.apply(xyz_c, quat, scale, opacity, filter_3d, view,
                            _consts(mh_dist=mh_dist, mip_model=filter_3d is not None, **kw))
    return out if filter_3d is not None else (*out, None)
