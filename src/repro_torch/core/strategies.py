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
  dispatch included, so ``T_DI`` is rebuilt ("re-communication": one
  device has no All-to-All, the re-dispatch is what remains).
* ``S1`` and ``S3`` run it under the same checkpoint, but ``T_DI`` is
  copied to pinned host memory in the forward pass and copied back in
  the recompute instead of being re-dispatched (``_restore_t_di``).

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


class _RestoreTdi(torch.autograd.Function):
    """Identity on ``buf`` (the dispatched ``T_DI``) whose backward is the
    dispatch's own: ``d tokens[t] = sum_j d buf[dest[t*k + j]]``. It lets
    the recompute take ``T_DI`` from the stash instead of re-running the
    dispatch, while the gradient still reaches the chunk's tokens."""

    @staticmethod
    def forward(ctx, tokens, dest, buf):
        ctx.save_for_backward(dest)
        ctx.t = tokens.shape[0]
        return buf

    @staticmethod
    def backward(ctx, g):
        (dest,) = ctx.saved_tensors
        e, c, m = g.shape
        flat = torch.cat([g.reshape(e * c, m), g.new_zeros((1, m))], dim=0)
        k = dest.shape[0] // ctx.t
        return flat[dest.long()].reshape(ctx.t, k, m).sum(1), None, None


def restore_t_di(tokens, dest, dispatch_fn: Callable[[], torch.Tensor],
                 stash: Optional[TdiStash]) -> torch.Tensor:
    """``T_DI`` for a chunk. Without a stash: ``dispatch_fn()`` under
    autograd. With one: the first call (the forward pass) dispatches
    without a graph and keeps the result in the stash; a second call (the
    checkpoint's recompute) fetches it back. Both calls build the same
    graph (one ``_RestoreTdi``), as the checkpoint requires."""
    if stash is None:
        return dispatch_fn()
    if stash.saved is None:
        with torch.no_grad():
            buf = dispatch_fn()
        stash.keep(buf)
    else:
        buf = stash.fetch(tokens.device)
    return _RestoreTdi.apply(tokens, dest, buf)


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
