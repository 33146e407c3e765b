"""Token dispatch/combine by sort, as in ``repro.moe.dispatch``: a stable
argsort of tokens by destination expert, each token's rank within its
expert by searchsorted, and a scatter-add into an ``[E*C+1, M]`` buffer
whose last row takes the tokens past capacity and is dropped."""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_router.ref import plan_ref


def dispatch_plan(expert_idx: torch.Tensor, num_experts: int,
                  capacity: int):
    """expert_idx ``[T, k]`` -> (dest ``[T*k]`` int32, valid ``[T*k]``).

    ``dest[t*k+j]`` is the flat position in the ``[E*C]`` buffer that
    route j of token t writes to; overflow routes get ``E*C``. The MoE
    chunk takes its plan from the router's launch
    (``router.route_and_plan``); this is the same arithmetic in PyTorch,
    the router kernel's plain version.
    """
    return plan_ref(expert_idx, num_experts, capacity)


def dispatch(tokens: torch.Tensor, dest: torch.Tensor, num_experts: int,
             capacity: int) -> torch.Tensor:
    """tokens ``[T, M]``; dest ``[T*k]`` -> buffer ``[E, C, M]``."""
    t, m = tokens.shape
    k = dest.shape[0] // t
    src = tokens.repeat_interleave(k, dim=0) if k > 1 else tokens
    buf = torch.zeros((num_experts * capacity + 1, m), dtype=tokens.dtype,
                      device=tokens.device)
    buf.index_add_(0, dest.long(), src)
    return buf[:-1].reshape(num_experts, capacity, m)


def combine(buffer: torch.Tensor, dest: torch.Tensor, probs: torch.Tensor,
            t: int) -> torch.Tensor:
    """buffer ``[E, C, M]``; dest ``[T*k]``; probs ``[T,k]`` -> ``[T, M]``."""
    e, c, m = buffer.shape
    flat = torch.cat([buffer.reshape(e * c, m),
                      buffer.new_zeros((1, m))], dim=0)
    gathered = flat[dest.long()]                          # [T*k, M]
    k = dest.shape[0] // t
    gathered = gathered.reshape(t, k, m)
    return torch.einsum("tkm,tk->tm", gathered, probs.to(buffer.dtype))
