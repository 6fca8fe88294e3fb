"""Image metrics (port of ``gsplat_tpu/ops/loss.py::compute_psnr``).

The fused SSIM+L1 training loss comes with the training step.
"""

from __future__ import annotations

import torch


def compute_psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """10*log10(1/MSE); 100.0 on exact match."""
    mse = torch.mean((pred - gt) ** 2)
    return torch.where(
        mse == 0.0, torch.full_like(mse, 100.0), 10.0 * torch.log10(1.0 / mse)
    )
