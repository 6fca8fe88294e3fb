"""The fused SSIM + L1 loss and its gradient, as the measured step defines
them: an 11-tap separable Gaussian (sigma 1.5) with edge-replicated
padding in the forward; a backward that convolves the stored derivative
maps with zero padding and adds the L1 sign term (not the adjoint of the
forward). Convolutions in full float32."""

from __future__ import annotations

import torch
import torch.nn.functional as F

TAPS = (0.001028380123898387, 0.0075987582094967365, 0.036000773310661316,
        0.10936068743467331, 0.21300552785396576, 0.26601171493530273,
        0.21300552785396576, 0.10936068743467331, 0.036000773310661316,
        0.0075987582094967365, 0.001028380123898387)
HALO = 5
C1 = 0.01 ** 2
C2 = 0.03 ** 2


def _blur(img, zero_pad):
    c = img.shape[0]
    taps = torch.tensor(TAPS, dtype=torch.float32, device=img.device)
    x = img[None]
    pad = HALO if zero_pad else 0
    if not zero_pad:
        x = F.pad(x, (HALO, HALO, HALO, HALO), mode="replicate")
    x = F.conv2d(x, taps.view(1, 1, -1, 1).expand(c, 1, -1, 1), padding=(pad, 0), groups=c)
    x = F.conv2d(x, taps.view(1, 1, 1, -1).expand(c, 1, 1, -1), padding=(0, pad), groups=c)
    return x[0]


def loss_and_grad(pred, gt, w: float, rows: slice = slice(None)):
    """(loss, d loss / d pred) of (H, W, 3) images. ``rows`` keeps only
    those image rows in the loss (a planted fault: part of the batch left
    out, the mean taken over the rest)."""
    pred_c = pred[rows].permute(2, 0, 1)
    gt_c = gt[rows].permute(2, 0, 1)
    c, h, wd = pred_c.shape
    conv = _blur(torch.cat([pred_c, gt_c, pred_c * pred_c, gt_c * gt_c, pred_c * gt_c]),
                 False)
    mu1, mu2 = conv[0:c], conv[c:2 * c]
    s1 = conv[2 * c:3 * c] - mu1 * mu1
    s2 = conv[3 * c:4 * c] - mu2 * mu2
    s12 = conv[4 * c:5 * c] - mu1 * mu2
    a = mu1 * mu1 + mu2 * mu2 + C1
    b = s1 + s2 + C2
    cc = 2.0 * mu1 * mu2 + C1
    d = 2.0 * s12 + C2
    ssim = (cc * d) / (a * b)
    loss = torch.mean((1.0 - w) * torch.abs(pred_c - gt_c) + w * (1.0 - ssim))
    d_mu1 = ((mu2 * 2.0 * d) / (a * b) - (mu2 * 2.0 * cc) / (a * b)
             - (mu1 * 2.0 * cc * d) / (a * a * b) + (mu1 * 2.0 * cc * d) / (a * b * b))
    d_s1 = (-cc * d) / (a * b * b)
    d_s12 = (2.0 * cc) / (a * b)
    maps = _blur(torch.cat([-w * d_mu1, -w * d_s1, -w * d_s12]), True)
    ssim_grad = maps[0:c] + (2.0 * pred_c) * maps[c:2 * c] + gt_c * maps[2 * c:3 * c]
    sign = torch.where(pred_c > gt_c, 1.0, -1.0)
    grad = torch.zeros_like(pred)
    grad[rows] = ((ssim_grad + (1.0 - w) * sign) / float(h * wd * c)).permute(1, 2, 0)
    return loss, grad
