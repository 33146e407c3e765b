"""The collectives of expert parallelism as ``torch.autograd.Function``s.

In the JAX package the MoE layer runs inside ``shard_map``, and JAX
differentiates its collectives by their transpose rules. Each function
here is one such collective with its transpose as the backward pass:

* ``all_to_all``: an All-to-All with equal splits along dim 0 (chunk
  ``j`` goes to rank ``j``); its transpose is the same All-to-All of the
  cotangent. Both run synchronously (the serial schedule of
  ``core.pipeline_moe``).
* ``start_all_to_all``: the same All-to-All outside autograd, issued
  asynchronously with a :class:`Pending` whose ``wait`` must be called
  before the output is read: the overlapped schedule of
  ``core.pipeline_moe`` cuts its chunks at their collectives and issues
  each one itself, the gradients' in its backward pass too.
* ``scatter_seq``: this rank's slice of the sequence (dim 1); backward
  all-gathers the slices' cotangents over the group, because each
  rank's slice feeds a loss that every rank of the group computes.
* ``gather_seq``: all-gather the slices along dim 1; backward takes
  this rank's slice of the cotangent (every rank of the group computes
  the same loss from the gathered tensor, so its own slice's cotangent
  is the whole of it).
* ``all_gather``: all-gather along a dim (a ZeRO-3 expert shard along
  its last, the dp group's batch rows along the first); backward
  reduce-scatters the cotangent (a sum over the group: each rank's
  cotangent of the whole tensor is its part of the loss's).
* ``mean``: the ``pmean`` of a value over a group; backward divides the
  cotangent by the group's size and sends nothing (every rank holds the
  same cotangent of the mean).

``group=None`` is the default (world) group.

``slowest`` wraps a measure function so that its result is the world's
maximum: what the train controller and the serving engine's resolver
rank candidates by, so that every rank picks the same one.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["Pending", "all_gather", "all_to_all", "gather_dim",
           "gather_seq", "mean", "scatter_seq", "slowest",
           "start_all_to_all"]


class Pending:
    """An asynchronous collective in flight: ``wait()`` before its output
    is read. ``Pending()`` has no work to wait for. ``keep`` holds the
    tensors the collective reads until it is waited on."""

    def __init__(self, work=None, keep=None):
        self.work = work
        self.keep = keep

    def wait(self) -> None:
        if self.work is not None:
            self.work.wait()
            self.work = None
        self.keep = None


def _a2a(x: torch.Tensor, group, async_op: bool = False):
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    work = dist.all_to_all_single(out, x.contiguous(), group=group,
                                  async_op=async_op)
    return out, work


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)[0]

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group)[0], None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """All-to-All of ``x`` (dim 0 split into equal chunks, one a
    rank)."""
    return _AllToAll.apply(x, group)


def start_all_to_all(x: torch.Tensor, group
                     ) -> Tuple[torch.Tensor, Pending]:
    """The All-to-All of ``all_to_all``, issued asynchronously and
    without autograd: (output, :class:`Pending`)."""
    src = x.detach().contiguous()
    out, work = _a2a(src, group, async_op=True)
    return out, Pending(work, keep=src)


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in rank order (no
    autograd)."""
    n = dist.get_world_size(group)
    buf = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(buf, x.contiguous(), group=group)
    return torch.cat(buf.chunk(n), dim=dim)


def _slice_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _slice_dim(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.group, 1), None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_dim(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _slice_dim(g, ctx.group, 1), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        parts = torch.cat(g.chunk(n, dim=ctx.dim))   # rank-major on dim 0
        out = parts.new_empty((parts.shape[0] // n,) + parts.shape[1:])
        dist.reduce_scatter_tensor(out, parts.contiguous(), group=ctx.group)
        return out, None, None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def scatter_seq(x: torch.Tensor, group) -> torch.Tensor:
    """``x [B, S, ...]`` -> this rank's ``[B, S / n, ...]``."""
    return _ScatterSeq.apply(x, group)


def gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``[B, S / n, ...]`` -> ``[B, S, ...]``."""
    return _GatherSeq.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` (a ZeRO-3 shard
    ``[..., D / n]`` -> the whole leaf ``[..., D]``)."""
    return _AllGather.apply(x, group, dim % x.dim())


def mean(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group``."""
    return _Mean.apply(x, group)


def slowest(measure_fn: Callable[..., float], device) -> Callable[..., float]:
    """``measure_fn`` whose result is the maximum over the world: the
    ranks' clocks differ, and each must pick the same candidate."""
    def measure(*args) -> float:
        t = torch.tensor(float(measure_fn(*args)), dtype=torch.float64,
                         device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)
    return measure
