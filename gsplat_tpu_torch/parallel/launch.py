"""Start local ranks: ``spawn(fn, world, args, backend=...)`` runs
``fn(rank, *args)`` in ``world`` new processes joined in one process group
(a free localhost port for its store) and returns their return values in
rank order.

The processes are ``torch.multiprocessing.start_processes``'s: a rank that
raises or exits ends every rank and raises here with its traceback, so
that a fault in one rank never leaves the others waiting in a collective;
a run that outlives ``join_timeout`` is ended the same way. Each rank gets
an equal share of the host's cores for its intra-op threads: ranks that
each took every core would contend for them.
"""

from __future__ import annotations

import os
import queue
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import DEFAULT_TIMEOUT_S, initialize_multihost


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world, addr, backend, timeout, args, results):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    initialize_multihost(addr, world, rank, backend, timeout=timeout)
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    results.put((rank, out))


def _drain(results, got: dict, world: int, wait: float = 0.0) -> None:
    while len(got) < world:
        try:
            r, out = results.get(timeout=wait) if wait else results.get_nowait()
        except queue.Empty:
            return
        got[r] = out


def spawn(fn, world: int, args: tuple = (), *, backend: str,
          timeout: float = DEFAULT_TIMEOUT_S, join_timeout: float | None = None) -> list:
    """Run ``fn(rank, *args)`` on ranks 0..world-1, each in a new process
    (start method ``spawn``); ``fn`` and ``args`` must pickle. ``timeout``
    (seconds) is the process group's; ``join_timeout``, if given, bounds the
    whole run."""
    results = mp.get_context("spawn").Queue()
    addr = f"127.0.0.1:{free_port()}"
    ctx = mp.start_processes(_entry, (fn, world, addr, backend, timeout, args, results),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + (float("inf") if join_timeout is None else join_timeout)
    got: dict = {}
    try:
        # Results are read while the ranks run: a rank whose result fills
        # the queue's pipe exits only once it has been read.
        while not ctx.join(timeout=0.2):
            _drain(results, got, world)
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in time")
        _drain(results, got, world, wait=10.0)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    if len(got) < world:
        raise RuntimeError(f"ranks {sorted(set(range(world)) - set(got))} exited with no result")
    return [got[r] for r in range(world)]
