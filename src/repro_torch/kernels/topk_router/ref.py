"""Plain PyTorch version of the top-k router kernel: fp32 softmax, then
k rounds of argmax and mask (ties to the lowest index), renormalised
when k > 1 — the function of the JAX package's
``repro.kernels.topk_router`` kernel and of its ``topk_router_ref``. The
CPU path uses it, and the CUDA kernel is held against it on the card."""
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
