"""Gaussian parameters and training state (port of
``gsplat_tpu/train/state.py``).

Parameters live in dense (N_cap, d) tensors with an ``alive`` mask, as in
the reference. SH is always (N_cap, 15, 3), the full l=3 budget; the active
band is ``StepStatics.l_max``. ``state_from_gaussians`` sizes a new state
by the reference's capacity rule, and ``grow_state`` re-buckets one into a
larger capacity when densification needs it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .init import GaussianData

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


def round_pair_cap(n: int, minimum: int = 1 << 20) -> int:
    """Pair capacity bucket (the reference's rule): ceil to a 2^19
    multiple; below that granularity, the next power of two from
    max(minimum, 512)."""
    g = 1 << 19
    if max(n, minimum) >= g:
        return max(minimum, ((n + g - 1) // g) * g)
    cap = max(minimum, 512)
    while cap < n:
        cap *= 2
    return cap


def round_row_cap(n: int, minimum: int = 2048) -> int:
    """Tile-row capacity bucket (the reference's rule): ceil to a 2^18
    multiple; below that granularity, the next power of two from
    max(minimum, 2048)."""
    g = 1 << 18
    if max(n, minimum) >= g:
        return max(minimum, ((n + g - 1) // g) * g)
    cap = max(minimum, 2048)
    while cap < n:
        cap *= 2
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


def state_from_gaussians(
    g: GaussianData,
    device: torch.device | str,
    n_cap: int | None = None,
    max_gaussians: int | None = None,
) -> TrainState:
    """A fresh state holding ``g``'s Gaussians in its first rows.

    The reference ``init_state``'s capacity rule: ``n_cap`` if given, else
    ``round_capacity(g.num)`` capped at ``round_capacity(max_gaussians)``.
    Rows past ``g.num`` are zero and not alive; SH is zero unless ``g``
    has it.
    """
    n = g.num
    if n_cap is None:
        n_cap = round_capacity(n)
        if max_gaussians is not None:
            n_cap = min(n_cap, round_capacity(max_gaussians))
    if n > n_cap:
        raise ValueError(f"{n} gaussians exceed capacity {n_cap}")
    columns = dict(xyz=g.xyz, rgb=g.rgb, opacity=g.opacity, scale=g.scale,
                   quat=g.quaternion, sh=g.sh)
    params = {}
    for name in PARAM_DIMS:
        out = np.zeros(_param_shape(name, n_cap), np.float32)
        if columns[name] is not None:
            out[:n] = columns[name]
        params[name] = out
    return init_state(params_from_jax(params, np.arange(n_cap) < n, device))


def grow_state(state: TrainState, new_cap: int) -> TrainState:
    """The state re-bucketed to a larger capacity: new parameters (a new
    ``GaussianParams``), moments and accumulators, padded with zero rows
    that are not alive. Returns ``state`` itself if ``new_cap`` is not
    larger."""
    old = state.capacity
    if new_cap <= old:
        return state
    dev = state.alive.device

    def pad(t: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((new_cap, *t.shape[1:]), dtype=t.dtype, device=dev)
        out[:old] = t
        return out

    params = GaussianParams(new_cap, device=dev)
    with torch.no_grad():
        for name in PARAM_DIMS:
            getattr(params, name)[:old] = getattr(state.params, name)
        params.alive[:old] = state.alive
    return TrainState(
        params=params,
        adam_m={k: pad(v) for k, v in state.adam_m.items()},
        adam_v={k: pad(v) for k, v in state.adam_v.items()},
        uv_grad_accum=pad(state.uv_grad_accum),
        accum_dur=pad(state.accum_dur),
    )


def num_active(state: TrainState) -> int:
    return int(state.alive.sum().item())


def to_gaussian_data(state: TrainState, l_max: int) -> GaussianData:
    """The alive Gaussians on the host (for PLY export), SH up to band
    ``l_max``."""
    alive = state.alive.cpu().numpy()
    host = {name: getattr(state.params, name).detach().cpu().numpy()[alive]
            for name in PARAM_DIMS}
    num_sh = (l_max + 1) ** 2 - 1
    return GaussianData(
        xyz=host["xyz"], rgb=host["rgb"], opacity=host["opacity"],
        scale=host["scale"], quaternion=host["quat"],
        sh=host["sh"][:, :num_sh, :] if num_sh > 0 else None,
    )


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
