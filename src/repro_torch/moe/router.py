"""Top-k gating network with Switch/GShard auxiliary losses, as in
``repro.moe.router``: the gate runs in fp32 whatever the compute dtype,
routing is deterministic, and ties go to the lowest expert index (what
``lax.top_k`` does; ``torch.topk`` does not promise it, ``argmax`` does).

The top-k runs in the hand-written ``topk_router`` kernel on the card
(its plain version on the CPU). The full softmax stays plain PyTorch:
the auxiliary losses need all E probabilities.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.topk_router import topk_router
from repro_torch.models.module import Spec


def specs(cfg: ArchConfig):
    m = cfg.moe
    s = {"w_gate": Spec((cfg.d_model, m.num_experts), ("embed", "experts"),
                        "normal", 0.02)}
    if m.gate_bias:
        s["b_gate"] = Spec((m.num_experts,), ("experts",), "zeros")
    return s


def route(params, tokens: torch.Tensor, cfg: ArchConfig):
    """tokens ``[T, M]`` -> (probs ``[T,k]`` fp32, expert_idx ``[T,k]``
    int32, aux dict)."""
    m = cfg.moe
    logits = tokens.float() @ params["w_gate"].float()
    if m.gate_bias:
        logits = logits + params["b_gate"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = topk_router(logits, m.top_k)   # renormalised if k > 1

    # Switch-style load balance: E * sum_e f_e * p_e
    assign = torch.nn.functional.one_hot(top_i[:, 0].long(),
                                         m.num_experts).float()
    f_e = assign.mean(dim=0)
    p_e = probs.mean(dim=0)
    aux_loss = m.num_experts * torch.sum(f_e * p_e) * m.aux_loss_weight
    z = torch.logsumexp(logits, dim=-1)
    z_loss = torch.mean(z ** 2) * m.z_loss_weight
    return top_p, top_i, {"aux_loss": aux_loss, "z_loss": z_loss}
