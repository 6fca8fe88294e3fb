"""The collectives of the parallel steps, over ``torch.distributed``.

Each step reduces as few buffers as it can: ``sum_over_ranks`` packs every
per-Gaussian float (the six parameter gradients and the extra columns a
step needs) and one slot per rank for each scalar metric into one float32
buffer, the visibility mask and one slot per rank for each integer metric
(the pair count, binning's pair and row requirements) into one int32
buffer, and SUM-reduces each once. A rank's scalar lands in its own slot,
so the reduced slots hold every rank's value: a mean, a sum, a max or rank
0's value follows on every rank, on the device, without another
collective or a host read, and every rank reads the same bits.

The gloo backend reduces host memory; where a rank's tensor is on a CUDA
device (ranks that share one card), the gloo branch here copies it to the
host, runs the collective there and copies the result back: a host sync,
so a gloo step is never captured into a CUDA graph. NCCL takes the device
tensor as it is, and its collectives are captured with the step.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..train.state import PARAM_DIMS


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through host memory: a CUDA tensor under gloo."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def capturable(group=None) -> bool:
    """Whether the group's collectives can be captured into a CUDA graph
    with the step: NCCL's run on the device; gloo's stage through the
    host."""
    return dist.get_backend(group) == dist.Backend.NCCL


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """SUM-reduce ``t`` in place over the group's ranks."""
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked along dim 0, in rank order."""
    src = t.detach().contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=0)
    return out.to(t.device) if staged else out


def reduced_bytes(n: int, columns: int, scalars: int, counts: int, world: int) -> int:
    """The bytes ``sum_over_ranks`` SUM-reduces for ``n`` Gaussians: the
    float buffer (the parameter gradients, 59 floats a Gaussian at SH 3,
    ``columns`` more floats a Gaussian, a slot a rank for each of
    ``scalars``) and the int32 buffer (the mask, a slot a rank for each of
    ``counts``)."""
    grads = sum(math.prod(d) if isinstance(d, tuple) else max(d, 1) for d in PARAM_DIMS.values())
    return 4 * (n * (grads + columns) + scalars * world + n + counts * world)


def sum_over_ranks(grads: dict, columns: list, scalars: list, mask: torch.Tensor,
                   counts: list, group=None):
    """Sum per-Gaussian tensors over ranks in one float and one int buffer.

    ``grads`` maps each parameter name to its gradient, ``columns`` are
    more (N_cap, ...) float tensors, ``scalars`` are this rank's float
    scalars (0-d tensors), ``mask`` (N_cap,) bool, ``counts`` this rank's
    integer scalars (0-d int32 tensors or ints: the pair count and the
    binning's requirements). Returns (summed grads as views of the reduced
    buffer, summed columns, ``(len(scalars), world)`` every rank's
    scalars, visible_count (N_cap,) int32, ``(len(counts), world)`` every
    rank's counts), all on the device: nothing here reads the host, and
    only the gloo branch's staging copies through it.
    """
    n = mask.shape[0]
    dev = mask.device
    b, r = dist.get_world_size(group), dist.get_rank(group)
    names = list(PARAM_DIMS)
    parts = [grads[k] for k in names] + list(columns)
    slots = torch.zeros((len(scalars), b), dtype=torch.float32, device=dev)
    for i, s in enumerate(scalars):
        slots[i, r] = s
    flat = torch.cat([p.reshape(-1) for p in parts] + [slots.reshape(-1)])
    ints = torch.zeros((n + len(counts) * b,), dtype=torch.int32, device=dev)
    ints[:n] = mask.to(torch.int32)
    for i, c in enumerate(counts):
        ints[n + i * b + r] = c
    all_reduce_sum_(flat, group)
    all_reduce_sum_(ints, group)
    out, off = [], 0
    for p in parts:
        out.append(flat[off:off + p.numel()].view(p.shape))
        off += p.numel()
    summed = dict(zip(names, out[:len(names)]))
    return (summed, out[len(names):], flat[off:].view(len(scalars), b), ints[:n],
            ints[n:].view(len(counts), b))
