"""Top-k gating network with Switch/GShard auxiliary losses, as in
``repro.moe.router``: the gate runs in fp32 whatever the compute dtype,
routing is deterministic, and ties go to the lowest expert index (what
``lax.top_k`` does; ``torch.topk`` does not promise it, ``argmax`` does).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.module import Spec


def specs(cfg: ArchConfig):
    m = cfg.moe
    s = {"w_gate": Spec((cfg.d_model, m.num_experts), ("embed", "experts"),
                        "normal", 0.02)}
    if m.gate_bias:
        s["b_gate"] = Spec((m.num_experts,), ("experts",), "zeros")
    return s


def top_k_lowest_index(probs: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lowest index: ``k`` rounds
    of argmax (first maximum) and mask."""
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


def route(params, tokens: torch.Tensor, cfg: ArchConfig):
    """tokens ``[T, M]`` -> (probs ``[T,k]`` fp32, expert_idx ``[T,k]``
    int32, aux dict)."""
    m = cfg.moe
    logits = tokens.float() @ params["w_gate"].float()
    if m.gate_bias:
        logits = logits + params["b_gate"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k_lowest_index(probs, m.top_k)
    if m.top_k > 1:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load balance: E * sum_e f_e * p_e
    assign = torch.nn.functional.one_hot(top_i[:, 0], m.num_experts).float()
    f_e = assign.mean(dim=0)
    p_e = probs.mean(dim=0)
    aux_loss = m.num_experts * torch.sum(f_e * p_e) * m.aux_loss_weight
    z = torch.logsumexp(logits, dim=-1)
    z_loss = torch.mean(z ** 2) * m.z_loss_weight
    return top_p, top_i.to(torch.int32), {"aux_loss": aux_loss,
                                          "z_loss": z_loss}
