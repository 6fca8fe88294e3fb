"""Visibility-masked Adam in place (``ops/adam.py::masked_adam_update``,
written back into the parameter and its moments).

One call steps one parameter group: rows where ``mask`` is True take the
Adam step, the others keep their parameter and moments bit for bit. CUDA
kernel: ``csrc/adam.cu`` (one pass: each stepped element's parameter,
gradient and moments read once and written back in place, the plain
version's f32 operations in its order, no FMA contraction, so its result
is bit-identical to the plain version's on the card). ``bias1``,
``bias2`` and a tensor ``lr`` are read from device memory, so a CUDA
graph's replay takes the iteration it was given.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import adam as adam_ops
from . import _build

# The f32 roundings of the Python doubles that torch's scalar path rounds
# in masked_adam_update: B1, 1.0 - B1, B2, 1.0 - B2, EPS.
_CONSTANTS = tuple(ctypes.c_float(x) for x in (
    adam_ops.B1, 1.0 - adam_ops.B1, adam_ops.B2, 1.0 - adam_ops.B2, adam_ops.EPS))


def masked_adam_update_plain(param, grad, m, v, mask, lr, bias1, bias2) -> None:
    """Plain PyTorch version: ``masked_adam_update``, then ``copy_`` of
    its three results into ``param``, ``m`` and ``v``."""
    new = adam_ops.masked_adam_update(param, grad, m, v, mask, lr, bias1, bias2)
    for t, x in zip((param, m, v), new):
        t.copy_(x)


def _check(name, param, grad, m, v, mask, lr, bias1, bias2) -> None:
    for t in (param, grad, m, v):
        if t.dtype != torch.float32 or t.shape != param.shape:
            raise ValueError(f"{name}: param, grad, m and v must be float32 of one shape, got "
                             f"{t.dtype} {tuple(t.shape)} against {tuple(param.shape)}")
    if param.dim() < 1 or mask.dtype != torch.bool or mask.shape != param.shape[:1]:
        raise ValueError(f"{name}: mask must be {tuple(param.shape[:1])} bool, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    scalars = (bias1, bias2) + ((lr,) if isinstance(lr, torch.Tensor) else ())
    for t in scalars:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"{name}: bias1, bias2 and a tensor lr must be one float32 each")
    for t in (param, grad, m, v, mask) + scalars:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def masked_adam_update_(param: torch.Tensor, grad: torch.Tensor, m: torch.Tensor,
                        v: torch.Tensor, mask: torch.Tensor, lr, bias1: torch.Tensor,
                        bias2: torch.Tensor) -> None:
    """One Adam step, in place, on the rows of ``param`` (N, ...) float32
    where ``mask`` (N,) bool is True, with ``grad``, ``m`` and ``v`` of its
    shape; ``lr`` a number or a () float32 tensor; ``bias1``, ``bias2`` ()
    float32 tensors. All contiguous. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel (which takes param, grad, m and v at
    16-byte aligned addresses)."""
    name = "masked_adam"
    _check(name, param, grad, m, v, mask, lr, bias1, bias2)
    if param.device.type == "cpu":
        masked_adam_update_plain(param, grad, m, v, mask, lr, bias1, bias2)
        return
    tensor_lr = isinstance(lr, torch.Tensor)
    _build.require_cuda(name, param, grad, m, v, mask, bias1, bias2, *((lr,) if tensor_lr else ()))
    if any(t.data_ptr() % 16 for t in (param, grad, m, v)):
        raise ValueError(f"{name}: param, grad, m and v must be 16-byte aligned")
    lib = _build.build()
    n = param.shape[0]
    err = lib.gs_masked_adam(
        param.data_ptr(), grad.data_ptr(), m.data_ptr(), v.data_ptr(), mask.data_ptr(), n,
        param.numel() // n if n else 1, bias1.data_ptr(), bias2.data_ptr(),
        lr.data_ptr() if tensor_lr else None, 0.0 if tensor_lr else -float(lr), *_CONSTANTS,
        _build.stream_ptr(param.device),
    )
    _build.check(err, name)
    _build.launches[name] += 1
