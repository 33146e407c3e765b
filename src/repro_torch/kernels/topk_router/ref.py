"""Plain PyTorch versions of the top-k router kernel.

``topk_router_ref``: fp32 softmax, then k rounds of argmax and mask (ties
to the lowest index), renormalised when k > 1 — the function of the JAX
package's ``repro.kernels.topk_router`` kernel and of its
``topk_router_ref``. ``route_plan_ref`` adds what the fused launch
computes beside it: the dispatch plan (``plan_ref``, which
``moe.dispatch.dispatch_plan`` also runs) and the aux statistics of
``moe.router.route``. The CPU path uses them, and the CUDA kernel is held
against them on the card.
"""
from __future__ import annotations

import torch


def top_k_lowest_index(probs: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lowest index: ``k`` rounds
    of argmax (first maximum) and mask. ``torch.topk`` promises no order
    among equal values; ``argmax`` returns the first."""
    if k == 1:
        idx = probs.argmax(dim=-1, keepdim=True)
        return probs.gather(-1, idx), idx
    work = probs.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = work.argmax(dim=-1, keepdim=True)
        vals.append(probs.gather(-1, i))
        idxs.append(i)
        work.scatter_(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def topk_router_ref(logits: torch.Tensor, k: int):
    """logits ``[T, E]`` -> (probs ``[T, k]`` fp32, idx ``[T, k]``
    int32)."""
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = top_k_lowest_index(probs, k)
    if k > 1:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_i.to(torch.int32)


def plan_ref(idx: torch.Tensor, num_experts: int, capacity: int):
    """idx ``[T, k]`` -> (dest ``[T*k]`` int32, valid ``[T*k]`` bool), as
    the JAX package's ``repro.moe.dispatch.dispatch_plan``: a stable sort
    by expert, each route's rank within its expert, ``e*C + rank`` below
    capacity and ``E*C`` past it."""
    flat_e = idx.reshape(-1).long()
    n = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(n, device=flat_e.device) - first
    valid_sorted = rank < capacity
    dest_sorted = torch.where(valid_sorted, sorted_e * capacity + rank,
                              num_experts * capacity)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=flat_e.device)
    return dest_sorted[inv].to(torch.int32), valid_sorted[inv]


def route_plan_ref(logits: torch.Tensor, k: int, capacity: int, *,
                   stats: bool = False, aux_loss_weight: float = 1.0,
                   z_loss_weight: float = 1.0):
    """logits ``[T, E]`` -> (probs ``[T, k]`` fp32, idx ``[T, k]`` int32,
    dest ``[T*k]`` int32, valid ``[T*k]`` bool[, stats]). ``stats`` holds
    ``prob_sum`` ``[E]`` (the softmax summed over tokens), ``primary_count``
    ``[E]`` int32 (tokens whose first route goes to the expert),
    ``z_sq_sum`` (logsumexp squared, summed over tokens) and the two
    losses built from them with the weights as ``moe.router.route`` builds
    them: the Switch load balance ``E * sum_e f_e * p_e * w`` (f_e the
    share of primary routes, p_e the mean probability) and the z-loss
    ``mean(logsumexp^2) * w``. The sums are taken in float64 and rounded
    once."""
    t, e = logits.shape
    probs, idx = topk_router_ref(logits, k)
    dest, valid = plan_ref(idx, e, capacity)
    if not stats:
        return probs, idx, dest, valid
    x = logits.double()
    st = {"prob_sum": torch.softmax(x, dim=-1).sum(0).float(),
          "primary_count": torch.bincount(idx[:, 0].long(), minlength=e)
          .to(torch.int32),
          "z_sq_sum": (torch.logsumexp(x, dim=-1) ** 2).sum().float()}
    f_e = st["primary_count"].float() / t
    p_e = st["prob_sum"] / t
    st["aux_loss"] = e * torch.sum(f_e * p_e) * aux_loss_weight
    st["z_loss"] = st["z_sq_sum"] / t * z_loss_weight
    return probs, idx, dest, valid, st
