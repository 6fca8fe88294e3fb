"""Multi-device training over ``torch.distributed`` (port of
``gsplat_tpu/parallel``).

One process a rank; every rank holds the Gaussian parameters and the Adam
state whole (replicated) and updates them identically. Two modes:

- ``data_parallel``: one camera a rank, gradients summed over the ranks;
- ``tile_parallel``: one camera's tile rows split into strips, one a rank.

``initialize_multihost`` joins this process to the default process group;
with one process and no coordinator it is a no-op. ``launch.spawn`` starts
local ranks (the CLI's ``--dp``/``--tp``). A step's ``group`` argument, a
process group (None: the default one), takes the place of the reference's
device mesh. The factories (``get_dp_train_step``,
``get_monitored_dp_train_step`` and their tp twins) are the reference's:
on the card, at a pair cap and over NCCL, each captures its whole step,
collectives included, into one CUDA graph; over gloo they run eagerly.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from ..utils import profiling
from .data_parallel import dp_train_step, get_dp_train_step, get_monitored_dp_train_step
from .tile_parallel import get_monitored_tp_train_step, get_tp_train_step, tp_train_step

__all__ = ["dp_train_step", "tp_train_step", "get_dp_train_step",
           "get_monitored_dp_train_step", "get_tp_train_step", "get_monitored_tp_train_step",
           "initialize_multihost", "require_world"]

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 600.0


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout: float = DEFAULT_TIMEOUT_S,
    local_rank: int | None = None,
) -> None:
    """Join the default process group as rank ``process_id`` of
    ``num_processes``.

    ``coordinator_address`` is ``host:port`` (or ``tcp://host:port``) of
    rank 0's store. ``backend`` says where the ranks' tensors live:

    - ``"nccl"`` (the default): every rank has its own CUDA device, rank r
      on ``cuda:local_rank`` of its own host; a ``local_rank`` past the
      host's devices raises. ``local_rank`` None means ``process_id``,
      which holds when all ranks share one host. On several hosts, give
      each process its index among its host's processes: rank 9 of 16 on
      two hosts of 8 cards is ``local_rank`` 1;
    - ``"gloo"``: ranks on the CPU, or ranks that share one CUDA device
      (their collectives are staged through host memory, ``comm``).

    No backend is chosen after another fails. ``timeout`` (seconds) bounds
    every collective, so a rank that never reaches one turns into an error
    instead of a hang. Under NCCL the group is bound to the rank's device,
    which makes its communicator here, not at the first collective. The
    tracer's span ``dp.init`` covers the join and the communicator. No-op
    when only one process is present and no coordinator is given.
    """
    if coordinator_address is None and num_processes in (None, 1):
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs coordinator_address, num_processes and "
                         "process_id")
    backend = backend or "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend == "nccl":
        local_rank = process_id if local_rank is None else local_rank
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not 0 <= local_rank < cards:
            raise RuntimeError(f"backend nccl runs one CUDA device a rank: rank {process_id} "
                               f"at local rank {local_rank}: ranks exceed the available "
                               f"devices ({cards})")
        torch.cuda.set_device(local_rank)
    addr = coordinator_address
    bound = dict(device_id=torch.device("cuda", local_rank)) if backend == "nccl" else {}
    with profiling.span("dp.init"):
        dist.init_process_group(
            backend, init_method=addr if "://" in addr else f"tcp://{addr}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout), **bound,
        )


def require_world(want: int, group=None) -> int:
    """This process's rank in a process group of exactly ``want`` ranks;
    raises if there is no such group."""
    have = dist.get_world_size(group) if dist.is_initialized() else 1
    if have != want:
        raise ValueError(f"{want} ranks were asked for, but the process group has {have}: "
                         "start the ranks with the CLI's --dp/--tp or initialize_multihost")
    return dist.get_rank(group)

