"""Memory-reuse strategies S1–S4 of the MoE chunk, as
``repro.core.strategies`` maps them onto ``jax.checkpoint`` policies.

The JAX package wraps the chunk function in ``jax.checkpoint`` with
``save_only_these_names``: everything in the chunk is recomputed in the
backward pass except the tagged residuals it saves (``t_di``, the
dispatched expert input, and ``t_m``, the expert hidden activation), and
offloaded names go to pinned host memory. Here:

* ``NONE`` runs the chunk without a wrapper: autograd keeps what it
  saves.
* ``S2`` and ``S4`` run it under ``torch.utils.checkpoint`` (non-
  reentrant): the whole chunk is recomputed in the backward pass, the
  dispatch included, so ``T_DI`` is rebuilt ("re-communication": under
  expert parallelism the dispatch All-to-All runs again; on one device
  the re-dispatch is what remains).
* ``S1`` and ``S3`` run it under the same checkpoint, but ``T_DI`` is
  copied to pinned host memory in the forward pass and copied back in
  the recompute instead of being re-dispatched (``_restore_t_di``).

Under expert parallelism ``T_DI`` is the buffer after the dispatch
All-to-All (the JAX package tags it there). The serial schedule (one
device too) runs each chunk under the checkpoint. The overlapped
schedule interleaves the chunks around their collectives, so no
checkpoint can hold one chunk: ``core.pipeline_moe`` runs the layer's
chunks in one autograd function, whose backward pass recomputes and
differentiates them stage by stage between the collectives and issues
those asynchronously, so that one chunk's All-to-Alls run under another
chunk's expert FFN (``pipeline_moe.backward_order``); a stash (S1/S3)
and ``undispatch`` serve it as they serve the checkpoint. The serial
schedule keeps the checkpoint on one device because it holds less:
through a split recompute, full-width moe-gpt3-s's S4 training peak on
an H100 rose from 37.3 to 38.2 GB, and the ``dots`` and ``full`` remat
policies no longer lowered it (``chip_smoke.py`` phase 15).

``T_M`` is restored by recompute under every strategy: the fused
``grouped_ffn`` kernel never writes it, and its backward rebuilds it
from ``T_DI``. S1/S3 and S2/S4 therefore differ only in how ``T_DI``
comes back. The analytic core keeps the paper's Q-vectors
(``types.Q_TABLE``), so Eq. 10's host terms for S1/S2 count ``T_M``
copies the port never makes.

Offload needs a CUDA tensor: on the CPU the offloaded ``T_DI`` stays
where it is (``TdiStash.keep``), as the JAX package turns an offload into
a device save where the backend has no pinned host memory
(``strategies.py:44-48`` there).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import Strategy
from repro_torch.distributed import collectives as C


def host_offload_supported() -> bool:
    """True when a CUDA device is present: an offload goes to pinned host
    memory (``TdiStash``), which needs one. The counterpart of the JAX
    package's check for a ``pinned_host`` memory kind."""
    return torch.cuda.is_available()


class TdiStash:
    """Where one chunk's ``T_DI`` waits between its forward pass and the
    recompute of its backward pass: pinned host memory for a CUDA
    tensor, else the tensor itself."""

    def __init__(self):
        self.saved: Optional[torch.Tensor] = None

    def keep(self, t: torch.Tensor) -> None:
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            self.saved = host
        else:
            self.saved = t

    def fetch(self, device: torch.device) -> torch.Tensor:
        return self.saved.to(device, non_blocking=True)


def undispatch(g: torch.Tensor, dest: torch.Tensor, t: int) -> torch.Tensor:
    """The dispatch's transpose: ``g`` ``[E, C, M]`` (a cotangent of the
    dispatched buffer) -> ``[t, M]``, ``d tokens[t] = sum_j g[dest[t*k +
    j]]`` (a route past capacity, ``dest = E*C``, reads zeros)."""
    e, c, m = g.shape
    flat = torch.cat([g.reshape(e * c, m), g.new_zeros((1, m))], dim=0)
    k = dest.shape[0] // t
    return flat[dest.long()].reshape(t, k, m).sum(1)


class _RestoreTdi(torch.autograd.Function):
    """Identity on ``buf`` (the dispatched ``T_DI``) whose backward is the
    dispatch's own: ``d tokens[t] = sum_j d buf[dest[t*k + j]]``, after
    the reverse All-to-All over ``group`` when ``buf`` was received
    through one. It lets the recompute take ``T_DI`` from the stash
    instead of re-running the dispatch, while the gradient still reaches
    the chunk's tokens."""

    @staticmethod
    def forward(ctx, tokens, dest, buf, group):
        ctx.save_for_backward(dest)
        ctx.t = tokens.shape[0]
        ctx.group = group
        return buf

    @staticmethod
    def backward(ctx, g):
        (dest,) = ctx.saved_tensors
        if ctx.group is not None:
            g = C.all_to_all(g, ctx.group)
        return undispatch(g, dest, ctx.t), None, None, None


def restore_t_di(tokens, dest, dispatch_fn: Callable[[], torch.Tensor],
                 stash: Optional[TdiStash], group=None) -> torch.Tensor:
    """``T_DI`` for a chunk. Without a stash: ``dispatch_fn()`` under
    autograd. With one: the first call (the forward pass) dispatches
    without a graph and keeps the result in the stash; a second call (the
    checkpoint's recompute) fetches it back. Both calls build the same
    graph (one ``_RestoreTdi``), as the checkpoint requires. ``group``:
    the EP group whose dispatch All-to-All ``dispatch_fn`` ends with
    (``None``: one device)."""
    if stash is None:
        return dispatch_fn()
    if stash.saved is None:
        with torch.no_grad():
            buf = dispatch_fn()
        stash.keep(buf)
    else:
        buf = stash.fetch(tokens.device)
    return _RestoreTdi.apply(tokens, dest, buf, group)


def wrap_chunk(fn: Callable, strategy: Strategy) -> Callable:
    """Apply the strategy to a per-chunk function ``fn(params, chunk,
    stash=None)``; returns ``fn'(params, chunk)``."""
    if strategy == Strategy.NONE:
        return fn
    keeps_t_di = "t_di" in strategy.offloads

    def wrapped(params, chunk):
        stash = TdiStash() if keeps_t_di else None
        return checkpoint(fn, params, chunk, stash, use_reentrant=False)

    return wrapped
