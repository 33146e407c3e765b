"""Top-k gating network with Switch/GShard auxiliary losses, as in
``repro.moe.router``: the gate runs in fp32 whatever the compute dtype,
routing is deterministic, and ties go to the lowest expert index (what
``lax.top_k`` does; ``torch.topk`` does not promise it, ``argmax`` does).

The top-k runs in the hand-written ``topk_router`` kernel on the card
(its plain version on the CPU). ``route`` keeps the full softmax and the
auxiliary losses in plain PyTorch. ``route_and_plan``, what the MoE chunk
calls, also takes the dispatch plan from the same launch and, where no
gradient is needed (serving), the auxiliary losses too, built from the
statistics that launch sums; under autograd (training) it keeps
``route``'s PyTorch losses, whose gradients reach the gate.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.topk_router import route_plan, topk_router
from repro_torch.models.module import Spec


def specs(cfg: ArchConfig):
    m = cfg.moe
    s = {"w_gate": Spec((cfg.d_model, m.num_experts), ("embed", "experts"),
                        "normal", 0.02)}
    if m.gate_bias:
        s["b_gate"] = Spec((m.num_experts,), ("experts",), "zeros")
    return s


def _logits(params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    logits = tokens.float() @ params["w_gate"].float()
    if cfg.moe.gate_bias:
        logits = logits + params["b_gate"].float()
    return logits


def _aux_losses(logits: torch.Tensor, top_i: torch.Tensor, m) -> dict:
    """Switch-style load balance ``E * sum_e f_e * p_e`` and the router
    z-loss, in PyTorch (differentiable in ``logits``)."""
    probs = torch.softmax(logits, dim=-1)
    assign = torch.nn.functional.one_hot(top_i[:, 0].long(),
                                         m.num_experts).float()
    f_e = assign.mean(dim=0)
    p_e = probs.mean(dim=0)
    aux_loss = m.num_experts * torch.sum(f_e * p_e) * m.aux_loss_weight
    z = torch.logsumexp(logits, dim=-1)
    z_loss = torch.mean(z ** 2) * m.z_loss_weight
    return {"aux_loss": aux_loss, "z_loss": z_loss}


def route(params, tokens: torch.Tensor, cfg: ArchConfig):
    """tokens ``[T, M]`` -> (probs ``[T,k]`` fp32, expert_idx ``[T,k]``
    int32, aux dict)."""
    logits = _logits(params, tokens, cfg)
    top_p, top_i = topk_router(logits, cfg.moe.top_k)  # renormalised if k > 1
    return top_p, top_i, _aux_losses(logits, top_i, cfg.moe)


def route_and_plan(params, tokens: torch.Tensor, cfg: ArchConfig,
                   capacity: int):
    """tokens ``[T, M]`` -> (probs ``[T,k]`` fp32, expert_idx ``[T,k]``
    int32, dest ``[T*k]`` int32, aux dict): ``route`` followed by
    ``dispatch.dispatch_plan(expert_idx, E, capacity)``, in one launch of
    the router kernel. When autograd tracks the logits the aux losses are
    ``route``'s PyTorch terms; otherwise the launch sums their statistics
    and builds them, and no further op runs."""
    m = cfg.moe
    logits = _logits(params, tokens, cfg)
    if logits.requires_grad:
        probs, idx, dest, _ = route_plan(logits, m.top_k, capacity)
        return probs, idx, dest, _aux_losses(logits, idx, m)
    probs, idx, dest, _, st = route_plan(
        logits, m.top_k, capacity, stats=True,
        aux_loss_weight=m.aux_loss_weight, z_loss_weight=m.z_loss_weight)
    return probs, idx, dest, {"aux_loss": st["aux_loss"],
                              "z_loss": st["z_loss"]}
