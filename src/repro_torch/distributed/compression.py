"""Gradient compression: int8 quantization with error feedback, as
``repro.distributed.compression``. The quantization residual is carried
to the next step, so the compression noise is unbiased over time. The
train loop applies it to the reduced gradients
(``TrainOptions.compress_grads``).

A leaf is quantized row by row along its last axis: ``scale =
max(amax, 1e-12) / 127``, ``q = clip(round(x / scale), -127, 127)``,
rounded half to even as ``jnp.round`` is, so a leaf compresses bit for
bit as the JAX package's does run eagerly. Leaves whose JAX rank is
below 2 pass through. A period leaf's JAX rank is its rank + 1 (JAX
stacks the periods on axis 0, ``optim.groups``), so a period's 1-D norm
scale is compressed, one row, and ``final_norm``'s is not. A ZeRO-3
shard holds part of each row: ``amax_group(path)`` names the group over
which that leaf's row maximum is taken.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.models.module import unflatten
from repro_torch.optim.groups import paths

__all__ = ["compress_with_feedback", "dequantize_int8", "quantize_int8"]


def quantize_int8(x: torch.Tensor, group=None):
    """fp32 ``x`` -> (int8 ``q``, fp32 ``scale`` with the last axis 1);
    with a ``group``, each row's maximum is taken over its ranks."""
    amax = x.abs().amax(dim=-1, keepdim=True) if x.dim() else x.abs()
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _jax_rank(path, x: torch.Tensor) -> int:
    return x.dim() + int(len(path) > 1 and path[0] == "periods"
                         and isinstance(path[1], int))


def compress_with_feedback(grads, error=None, *,
                           amax_group: Optional[Callable] = None):
    """grads + carried error -> (compressed-and-restored grads, new
    error), both trees shaped as ``grads``. ``error`` None starts from
    zeros. The returned grads have passed an int8 round trip (what the
    wire would carry); the residual is the next step's error feedback."""
    flat_g = list(paths(grads))
    flat_e = ([None] * len(flat_g) if error is None
              else [e for _, e in paths(error)])
    new_g, new_e = [], []
    for (path, g), e in zip(flat_g, flat_e):
        if _jax_rank(path, g) < 2:
            new_g.append(g)
            new_e.append(torch.zeros(g.shape, dtype=torch.float32,
                                     device=g.device))
            continue
        x = g.float() if e is None else g.float() + e
        q, s = quantize_int8(x, amax_group(path) if amax_group else None)
        out = dequantize_int8(q, s)
        new_g.append(out.to(g.dtype))
        new_e.append(x - out)
    return unflatten(grads, new_g), unflatten(grads, new_e)
