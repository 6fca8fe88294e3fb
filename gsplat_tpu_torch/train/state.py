"""Gaussian parameters and training state (port of
``gsplat_tpu/train/state.py``).

Parameters live in dense (N_cap, d) tensors with an ``alive`` mask, as in
the reference. SH is always (N_cap, 15, 3), the full l=3 budget; the active
band is ``StepStatics.l_max``.
"""

from __future__ import annotations

import dataclasses

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

    def __init__(self, capacity: int, device: torch.device | str = "cuda"):
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
            getattr(out, name).copy_(torch.from_numpy(arr.copy()))
        out.alive.copy_(torch.from_numpy(alive.copy()))
    return out


@dataclasses.dataclass
class TrainState:
    """Parameters, Adam moments and densification accumulators.

    The reference's ``TrainState`` fields. ``params`` holds the ``alive``
    mask as a buffer, so ``alive`` is read from there. ``adam_m`` and
    ``adam_v`` map each parameter name to a tensor of its shape;
    ``uv_grad_accum`` (N_cap,) float32 sums each visible Gaussian's uv
    gradient norm, ``accum_dur`` (N_cap,) int32 counts its visible steps.
    The port's ``apply_adam`` updates a state in place.
    """

    params: GaussianParams
    adam_m: dict[str, torch.Tensor]
    adam_v: dict[str, torch.Tensor]
    uv_grad_accum: torch.Tensor
    accum_dur: torch.Tensor

    @property
    def alive(self) -> torch.Tensor:
        return self.params.alive

    @property
    def capacity(self) -> int:
        return self.params.capacity


def _zero_moments(params: GaussianParams) -> dict[str, torch.Tensor]:
    return {
        name: torch.zeros_like(getattr(params, name).detach()) for name in PARAM_DIMS
    }


def init_state(params: GaussianParams, alive: torch.Tensor | None = None) -> TrainState:
    """A fresh state around ``params``: zero moments and accumulators.

    ``alive`` (N_cap,) bool, when given, replaces ``params.alive``.
    """
    if alive is not None:
        params.alive.copy_(torch.as_tensor(alive, dtype=torch.bool))
    dev = params.alive.device
    n = params.capacity
    return TrainState(
        params=params,
        adam_m=_zero_moments(params),
        adam_v=_zero_moments(params),
        uv_grad_accum=torch.zeros((n,), dtype=torch.float32, device=dev),
        accum_dur=torch.zeros((n,), dtype=torch.int32, device=dev),
    )


def state_from_jax(
    params: dict[str, np.ndarray],
    adam_m: dict[str, np.ndarray],
    adam_v: dict[str, np.ndarray],
    alive: np.ndarray,
    uv_grad_accum: np.ndarray,
    accum_dur: np.ndarray,
    device: torch.device | str,
) -> TrainState:
    """Carry a reference ``TrainState`` across, its fields as host arrays.

    For a JAX state ``s``: ``state_from_jax(**{f: jax.tree.map(np.asarray,
    getattr(s, f)) for f in s._fields}, device=...)``.
    """
    state = init_state(params_from_jax(params, alive, device))
    with torch.no_grad():
        for name in PARAM_DIMS:
            for ours, theirs in ((state.adam_m, adam_m), (state.adam_v, adam_v)):
                arr = np.asarray(theirs[name], dtype=np.float32)
                if arr.shape != tuple(ours[name].shape):
                    raise ValueError(f"moment {name}: shape {arr.shape}")
                ours[name].copy_(torch.from_numpy(arr.copy()))
        state.uv_grad_accum.copy_(torch.from_numpy(np.array(uv_grad_accum, np.float32)))
        state.accum_dur.copy_(torch.from_numpy(np.array(accum_dur, np.int32)))
    return state


def state_to_numpy(state: TrainState) -> dict:
    """The state's fields as host arrays (copies), under the reference's
    names."""
    host = lambda t: t.detach().cpu().numpy().copy()  # noqa: E731
    return dict(
        params={name: host(getattr(state.params, name)) for name in PARAM_DIMS},
        adam_m={name: host(t) for name, t in state.adam_m.items()},
        adam_v={name: host(t) for name, t in state.adam_v.items()},
        alive=host(state.alive),
        uv_grad_accum=host(state.uv_grad_accum),
        accum_dur=host(state.accum_dur),
    )
