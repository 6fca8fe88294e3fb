"""Gaussian parameters (port of ``gsplat_tpu/train/state.py``).

Parameters live in dense (N_cap, d) tensors with an ``alive`` mask, as in
the reference. SH is always (N_cap, 15, 3), the full l=3 budget; the active
band is ``StepStatics.l_max``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

PARAM_DIMS = {
    "xyz": 3,
    "rgb": 3,
    "opacity": 0,  # (N,)
    "scale": 3,
    "quat": 4,
    "sh": (15, 3),
}


def round_capacity(n: int, minimum: int = 4096) -> int:
    """Capacity bucket: next power of two (>= minimum) up to 2^22, then
    2^21-granular steps (the reference's bucketing)."""
    cap = minimum
    while cap < n and cap < (1 << 22):
        cap *= 2
    while cap < n:
        cap += 1 << 21
    return cap


def _param_shape(name: str, n: int) -> tuple[int, ...]:
    dim = PARAM_DIMS[name]
    if dim == 0:
        return (n,)
    if isinstance(dim, tuple):
        return (n, *dim)
    return (n, dim)


class GaussianParams(nn.Module):
    """Per-Gaussian parameters as ``nn.Parameter``s plus an ``alive`` buffer.

    Attributes mirror the reference's ``params`` dict: ``xyz (N,3)``,
    ``rgb (N,3)`` (SH band 0), ``opacity (N,)`` (logits), ``scale (N,3)``
    (log-scales), ``quat (N,4)`` (w,x,y,z), ``sh (N,15,3)``.
    """

    def __init__(self, capacity: int, device: torch.device | str = "cpu"):
        super().__init__()
        for name in PARAM_DIMS:
            shape = _param_shape(name, capacity)
            self.register_parameter(
                name,
                nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device)),
            )
        self.register_buffer(
            "alive", torch.zeros((capacity,), dtype=torch.bool, device=device)
        )

    @property
    def capacity(self) -> int:
        return int(self.alive.shape[0])


def params_from_jax(
    params: dict[str, np.ndarray],
    alive: np.ndarray,
    device: torch.device | str,
) -> GaussianParams:
    """Carry a reference state's parameters across.

    ``params`` maps the reference's names to host arrays (for a JAX state,
    ``{k: np.asarray(v) for k, v in state.params.items()}``); ``alive`` is
    its (N_cap,) mask. Shapes must match ``PARAM_DIMS``.
    """
    alive = np.asarray(alive, dtype=bool)
    n = alive.shape[0]
    out = GaussianParams(n, device=device)
    with torch.no_grad():
        for name in PARAM_DIMS:
            arr = np.asarray(params[name], dtype=np.float32)
            if arr.shape != _param_shape(name, n):
                raise ValueError(
                    f"{name}: shape {arr.shape}, expected {_param_shape(name, n)}"
                )
            getattr(out, name).copy_(torch.from_numpy(arr))
        out.alive.copy_(torch.from_numpy(alive))
    return out
