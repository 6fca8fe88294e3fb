"""Per-Gaussian SH colour (``ops/sh.py::sh_to_rgb``) and its gradient.

``sh_to_rgb`` on CPU tensors is ``ops/sh.py``'s function, autograd through
its torch ops. On CUDA tensors it is one ``torch.autograd.Function`` over
``csrc/sh.cu``: the forward writes the (N, 3) colours in one pass; the
backward recomputes the view direction and the basis from ``xyz`` and
``campos`` (the Function saves xyz, sh and campos) and writes the
gradients of xyz, dc and sh in one pass, sh's whole rows with zeros for the
bands above ``l_max`` (as autograd's zero fill gives them). ``campos`` is
read from device memory, so a CUDA graph's replay takes the view's camera.
Both kernels compute in f32 with ``ops/sh.py``'s constants and terms, but
sum in another order than the batched product of its einsum: they agree
with the plain versions to f32 rounding, not bit for bit.
"""

from __future__ import annotations

import torch

from ..ops import sh as sh_ops
from . import _build

SH_SHAPE = (15, 3)  # the full l=3 budget a row (train/state.py)


def _basis_jacobian(dirs: torch.Tensor, l_max: int) -> list:
    """d Y_k / d dir for k = 1 .. (l_max+1)^2 - 1: a list of (N, 3)
    tensors, the derivatives of ``sh_ops.sh_basis``'s terms."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    zero = torch.zeros_like(x)
    c1, c2, c3 = sh_ops._C1, sh_ops._C2, sh_ops._C3
    rows = []
    if l_max >= 1:
        rows += [(zero, zero + c1, zero), (zero, zero, zero + c1), (zero + c1, zero, zero)]
    if l_max >= 2:
        rows += [
            (c2[0] * y, c2[0] * x, zero),
            (zero, c2[1] * z, c2[1] * y),
            (zero, zero, 6.0 * c2[2] * z),
            (c2[3] * z, zero, c2[3] * x),
            (2.0 * c2[4] * x, -2.0 * c2[4] * y, zero),
        ]
    if l_max >= 3:
        xx, yy, zz = x * x, y * y, z * z
        rows += [
            (6.0 * c3[0] * x * y, 3.0 * c3[0] * (xx - yy), zero),
            (c3[1] * y * z, c3[1] * x * z, c3[1] * x * y),
            (zero, c3[2] * (5.0 * zz - 1.0), 10.0 * c3[2] * y * z),
            (zero, zero, c3[3] * (15.0 * zz - 3.0)),
            (c3[4] * (5.0 * zz - 1.0), zero, 10.0 * c3[4] * x * z),
            (2.0 * c3[5] * x * z, -2.0 * c3[5] * y * z, c3[5] * (xx - yy)),
            (3.0 * c3[6] * (xx - yy), -6.0 * c3[6] * x * y, zero),
        ]
    return [torch.stack(r, dim=1) for r in rows]


def sh_to_rgb_backward_plain(g: torch.Tensor, xyz: torch.Tensor, sh: torch.Tensor,
                             campos: torch.Tensor, l_max: int):
    """Plain PyTorch version of the backward kernel: the gradients of
    ``ops/sh.py::sh_to_rgb`` with respect to (xyz, dc, sh) given the
    colour gradient ``g`` (N, 3). ``grad_sh`` is (N, 15, 3) with zeros
    past l_max, ``grad_xyz`` zeros at l_max 0."""
    diff = xyz - campos[None, :]
    r = torch.sqrt(torch.sum(diff * diff, dim=1))
    length = r + 1e-9
    dirs = diff / length[:, None]
    k = sh_ops.num_sh_coeffs(l_max)
    grad_dc = g * sh_ops.Y00
    grad_sh = torch.zeros(sh.shape, dtype=g.dtype, device=g.device)
    if k == 1:
        return torch.zeros_like(xyz), grad_dc, grad_sh
    basis = sh_ops.sh_basis(dirs, l_max)[:, 1:]  # (N, k - 1)
    grad_sh[:, : k - 1] = basis[:, :, None] * g[:, None, :]
    grad_basis = torch.sum(sh[:, : k - 1] * g[:, None, :], dim=2)  # (N, k - 1)
    grad_dir = sum(grad_basis[:, i, None] * jac
                   for i, jac in enumerate(_basis_jacobian(dirs, l_max)))
    radial = torch.sum(grad_dir * diff, dim=1) / (r * length * length)
    grad_xyz = grad_dir / length[:, None] - diff * radial[:, None]
    return grad_xyz, grad_dc, grad_sh


def _check(xyz, dc, sh, campos, l_max) -> None:
    name = "sh_to_rgb"
    n = xyz.shape[0] if xyz.dim() else -1
    want = {"xyz": (xyz, (n, 3)), "dc": (dc, (n, 3)), "sh": (sh, (n, *SH_SHAPE)),
            "campos": (campos, (3,))}
    for label, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} must be float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if l_max not in (0, 1, 2, 3):
        raise ValueError(f"{name}: l_max must be 0..3, got {l_max!r}")


def _forward_launch(xyz, dc, sh, campos, l_max) -> torch.Tensor:
    n = xyz.shape[0]
    rgb = torch.empty((n, 3), dtype=torch.float32, device=xyz.device)
    err = _build.build().gs_sh_forward(
        rgb.data_ptr(), xyz.data_ptr(), dc.data_ptr(), sh.data_ptr(), campos.data_ptr(), n,
        l_max, _build.stream_ptr(xyz.device))
    _build.check(err, "sh_forward")
    _build.launches["sh_forward"] += 1
    return rgb


def _backward_launch(g, xyz, sh, campos, l_max):
    name = "sh_backward"
    n = xyz.shape[0]
    if g.dtype != torch.float32 or tuple(g.shape) != (n, 3) or g.device != xyz.device:
        raise ValueError(f"{name}: the colour gradient must be float32 ({n}, 3) on "
                         f"{xyz.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    grad_xyz, grad_dc, grad_sh = torch.empty_like(xyz), torch.empty_like(xyz), torch.empty_like(sh)
    err = _build.build().gs_sh_backward(
        grad_xyz.data_ptr(), grad_dc.data_ptr(), grad_sh.data_ptr(), g.data_ptr(),
        g.stride(0), g.stride(1), xyz.data_ptr(), sh.data_ptr(), campos.data_ptr(), n, l_max,
        _build.stream_ptr(xyz.device))
    _build.check(err, name)
    _build.launches[name] += 1
    return grad_xyz, grad_dc, grad_sh


class _ShToRgb(torch.autograd.Function):
    """(xyz, dc, sh, campos) -> (N, 3) colours; differentiable in xyz, dc
    and sh."""

    @staticmethod
    def forward(ctx, xyz, dc, sh, campos, l_max):
        ctx.save_for_backward(xyz, sh, campos)
        ctx.l_max = l_max
        return _forward_launch(xyz, dc, sh, campos, l_max)

    @staticmethod
    def backward(ctx, g):
        xyz, sh, campos = ctx.saved_tensors
        return (*_backward_launch(g, xyz, sh, campos, ctx.l_max), None, None)


def sh_to_rgb(xyz: torch.Tensor, dc: torch.Tensor, sh: torch.Tensor, campos: torch.Tensor,
              l_max: int) -> torch.Tensor:
    """Per-Gaussian colour ``dc*Y0 + 0.5 + sum coeffs*Y`` (no clamp) of
    ``xyz`` (N, 3), ``dc`` (N, 3) and ``sh`` (N, 15, 3) seen from ``campos``
    (3,), all float32 and contiguous, at ``l_max`` 0..3: (N, 3). A CPU
    tensor takes ``ops/sh.py::sh_to_rgb``; CUDA tensors (``sh`` 16-byte
    aligned) the kernels, differentiable in xyz, dc and sh."""
    _check(xyz, dc, sh, campos, l_max)
    if xyz.device.type == "cpu":
        return sh_ops.sh_to_rgb(xyz, dc, sh, campos, l_max)
    _build.require_cuda("sh_to_rgb", xyz, dc, sh, campos)
    if sh.data_ptr() % 16:
        raise ValueError("sh_to_rgb: sh must be 16-byte aligned")
    return _ShToRgb.apply(xyz, dc, sh, campos, l_max)
