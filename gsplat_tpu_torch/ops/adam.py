"""Visibility-masked Adam (port of ``gsplat_tpu/ops/adam.py``).

- B1 = 0.9, B2 = 0.999, EPS = 1e-8;
- bias corrections 1 - beta^(iter+1) come from the caller, once per step;
- NaN gradients become 0 (dead capacity rows, xyz = 0 and quat = 0, give
  0 * inf in the per-Gaussian chain; this scrub and the mask keep them
  out of the parameters);
- only masked (visible and alive) rows step: the moments of invisible
  Gaussians do not decay.
"""

from __future__ import annotations

import torch

B1 = 0.9
B2 = 0.999
EPS = 1e-8


def masked_adam_update(
    param: torch.Tensor,
    grad: torch.Tensor,
    m: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    lr,
    bias1,
    bias2,
):
    """One Adam step on rows where ``mask`` (N,) is True; others unchanged.

    Returns new (param, m, v) tensors; the inputs are not modified.
    """
    mask = mask.reshape(mask.shape + (1,) * (param.dim() - mask.dim()))
    g = torch.where(torch.isnan(grad), 0.0, grad)
    m_new = B1 * m + (1.0 - B1) * g
    v_new = B2 * v + (1.0 - B2) * g * g
    m_hat = m_new / bias1
    v_hat = v_new / bias2
    step = -lr * m_hat / (torch.sqrt(v_hat) + EPS)
    return (
        torch.where(mask, param + step, param),
        torch.where(mask, m_new, m),
        torch.where(mask, v_new, v),
    )
