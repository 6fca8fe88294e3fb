"""Fused SSIM + L1 loss and PSNR (port of ``gsplat_tpu/ops/loss.py``).

- 11-tap separable Gaussian window (sigma 1.5, the reference's hardcoded
  taps), C1 = 0.01^2, C2 = 0.03^2;
- the forward convolutions use edge-clamped (replicate) padding;
- loss = mean over pixels and channels of (1-w)|x-y| + w(1-SSIM);
- the backward is the reference's, NOT the adjoint of the forward: the
  stored derivative maps are convolved with ZERO padding and the L1 sign
  term is added, all over H*W*3. Plain autograd through ``conv2d`` would
  give a different gradient, so the loss is a ``torch.autograd.Function``.

The convolutions are depthwise ``conv2d`` on channel-major (C, H, W) maps,
always in full f32: a convolution on the card would otherwise run in TF32
(``torch.backends.cudnn.allow_tf32`` is True by default), where the
reference runs at HIGHEST precision.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

# The reference's 11-tap Gaussian, sigma = 1.5.
GAUSS_TAPS = (
    0.001028380123898387, 0.0075987582094967365, 0.036000773310661316,
    0.10936068743467331, 0.21300552785396576, 0.26601171493530273,
    0.21300552785396576, 0.10936068743467331, 0.036000773310661316,
    0.0075987582094967365, 0.001028380123898387,
)
HALO = 5
C1 = 0.01**2
C2 = 0.03**2


@contextlib.contextmanager
def _full_f32_conv():
    """cuDNN convolutions in full f32 inside the block, whatever the flags."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@functools.lru_cache(maxsize=None)
def _taps(device: torch.device) -> torch.Tensor:
    """The taps on ``device``, copied there once: a copy from the host
    inside a CUDA graph's capture would be a host sync."""
    return torch.tensor(GAUSS_TAPS, dtype=torch.float32, device=device)


def _sep_conv(img: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """11x11 separable Gaussian filter of channel-major (C, H, W) maps.

    ``pad_mode`` "edge" replicates the border pixels; "zero" pads zeros.
    Filters along H first, then along W, as the reference does.
    """
    c = img.shape[0]
    taps = _taps(img.device)
    x = img[None]
    if pad_mode == "edge":
        x = F.pad(x, (HALO, HALO, HALO, HALO), mode="replicate")
        pad = 0
    else:
        pad = HALO
    with _full_f32_conv():
        x = F.conv2d(x, taps.view(1, 1, -1, 1).expand(c, 1, -1, 1),
                     padding=(pad, 0), groups=c)
        x = F.conv2d(x, taps.view(1, 1, 1, -1).expand(c, 1, 1, -1),
                     padding=(0, pad), groups=c)
    return x[0]


def _fused_loss_fwd(pred: torch.Tensor, gt: torch.Tensor, ssim_weight: float):
    """(loss, derivative maps) of channel-major (C, H, W) images."""
    c = pred.shape[0]
    conv = _sep_conv(torch.cat([pred, gt, pred * pred, gt * gt, pred * gt]), "edge")
    mu1, mu2 = conv[0:c], conv[c : 2 * c]
    s1 = conv[2 * c : 3 * c] - mu1 * mu1
    s2 = conv[3 * c : 4 * c] - mu2 * mu2
    s12 = conv[4 * c : 5 * c] - mu1 * mu2
    a = mu1 * mu1 + mu2 * mu2 + C1
    b = s1 + s2 + C2
    c_ = 2.0 * mu1 * mu2 + C1
    d_ = 2.0 * s12 + C2
    ssim = (c_ * d_) / (a * b)
    l1 = torch.abs(pred - gt)
    loss = torch.mean((1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - ssim))
    # The partial-derivative maps the reference's forward kernel stores.
    d_mu1 = (
        (mu2 * 2.0 * d_) / (a * b)
        - (mu2 * 2.0 * c_) / (a * b)
        - (mu1 * 2.0 * c_ * d_) / (a * a * b)
        + (mu1 * 2.0 * c_ * d_) / (a * b * b)
    )
    d_s1 = (-c_ * d_) / (a * b * b)
    d_s12 = (2.0 * c_) / (a * b)
    maps = torch.cat([-ssim_weight * d_mu1, -ssim_weight * d_s1, -ssim_weight * d_s12])
    return loss, maps


class _FusedLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, gt, ssim_weight):
        pred_c = pred.permute(2, 0, 1)
        gt_c = gt.permute(2, 0, 1)
        loss, maps = _fused_loss_fwd(pred_c, gt_c, ssim_weight)
        ctx.save_for_backward(pred_c, gt_c, maps)
        ctx.ssim_weight = ssim_weight
        return loss

    @staticmethod
    def backward(ctx, g):
        pred, gt, maps = ctx.saved_tensors
        w = ctx.ssim_weight
        c, h, wd = pred.shape
        conv = _sep_conv(maps, "zero")
        ssim_grad = conv[0:c] + (2.0 * pred) * conv[c : 2 * c] + gt * conv[2 * c : 3 * c]
        sign = torch.where(pred > gt, 1.0, -1.0)
        grad = (ssim_grad + (1.0 - w) * sign) / float(h * wd * c)
        return (g * grad).permute(1, 2, 0), None, None


def fused_loss(pred: torch.Tensor, gt: torch.Tensor, ssim_weight: float) -> torch.Tensor:
    """Scalar (1-w) L1 + w (1-SSIM) of (H, W, 3) images; differentiable in
    ``pred`` with the reference's gradient (``gt`` gets none)."""
    return _FusedLoss.apply(pred, gt, float(ssim_weight))


def compute_psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """10*log10(1/MSE); 100.0 on exact match."""
    mse = torch.mean((pred - gt) ** 2)
    return torch.where(
        mse == 0.0, torch.full_like(mse, 100.0), 10.0 * torch.log10(1.0 / mse)
    )
