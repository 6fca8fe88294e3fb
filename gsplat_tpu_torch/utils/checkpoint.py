"""Checkpoint and resume (port of ``gsplat_tpu/utils/checkpoint.py``).

One ``.npz`` with the reference's keys: ``params.<name>``,
``adam_m.<name>``, ``adam_v.<name>``, ``alive``, ``uv_grad_accum``,
``accum_dur``, ``_iter``, ``_l_max``, ``_pair_cap``, ``_row_cap`` and
``_config_hash``, so each package resumes the other's checkpoints. The
port sizes its pair stream exactly, so it writes ``_pair_cap`` and
``_row_cap`` as 0, which the reference reads as "unknown", and ignores
them on load. ``config_hash`` is the reference's, over the same fields.
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..train.state import TrainState, state_from_jax, state_to_numpy


class Checkpoint(NamedTuple):
    state: TrainState
    iteration: int
    l_max: int
    config_hash: str  # "" = unknown


def config_hash(config) -> str:
    """Identity hash over behaviour-relevant config fields (paths excluded:
    a dataset legitimately moves between save and resume)."""
    skip = {"dataset_path", "output_dir"}
    items = sorted(
        (k, repr(v))
        for k, v in dataclasses.asdict(config).items()
        if k not in skip
    )
    return hashlib.sha256(repr(items).encode()).hexdigest()[:16]


def save_checkpoint(path, state: TrainState, iteration: int, l_max: int,
                    cfg_hash: str = "") -> None:
    host = state_to_numpy(state)
    arrays = {
        "_iter": np.int64(iteration),
        "_l_max": np.int64(l_max),
        "_pair_cap": np.int64(0),
        "_row_cap": np.int64(0),
        "_config_hash": np.bytes_(cfg_hash.encode()),
    }
    for group in ("params", "adam_m", "adam_v"):
        for k, v in host[group].items():
            arrays[f"{group}.{k}"] = v
    for k in ("alive", "uv_grad_accum", "accum_dur"):
        arrays[k] = host[k]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def load_checkpoint(path, device: torch.device | str) -> Checkpoint:
    """Read a checkpoint of either package into the port's state on
    ``device``."""
    with np.load(path) as data:
        groups: dict[str, dict] = {"params": {}, "adam_m": {}, "adam_v": {}}
        for name in data.files:
            if "." in name:
                group, key = name.split(".", 1)
                groups[group][key] = data[name]
        state = state_from_jax(
            **groups, alive=data["alive"], uv_grad_accum=data["uv_grad_accum"],
            accum_dur=data["accum_dur"], device=device,
        )
        cfg = bytes(data["_config_hash"]).decode() if "_config_hash" in data.files else ""
        return Checkpoint(state, int(data["_iter"]), int(data["_l_max"]), cfg)
