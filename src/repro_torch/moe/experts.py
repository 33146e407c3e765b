"""Expert FFN compute, as in ``repro.moe.experts``: grouped 2-GEMM
(optionally gated) as batched matmuls over the ``[E, C, M]`` buffer.

The JAX package computes this outside any Pallas kernel on the serving
path; the ``grouped_ffn`` kernel comes with ROADMAP.md's 'Training'
slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.ffn import ACTS
from repro_torch.models.module import Spec


def specs(cfg: ArchConfig):
    m = cfg.moe
    d = cfg.d_model
    s = {
        "w_up": Spec((m.num_experts, d, m.d_expert),
                     ("experts", "embed", "expert_mlp")),
        "w_down": Spec((m.num_experts, m.d_expert, d),
                       ("experts", "expert_mlp_c", "embed_out")),
    }
    if cfg.gated_ffn:
        s["w_gate"] = Spec((m.num_experts, d, m.d_expert),
                           ("experts", "embed", "expert_mlp"))
    return s


def shared_specs(cfg: ArchConfig):
    m = cfg.moe
    d = cfg.d_model
    dh = m.d_shared * m.num_shared_experts
    s = {"w_up": Spec((d, dh), ("embed", "mlp")),
         "w_down": Spec((dh, d), ("mlp_c", "embed_out"))}
    if cfg.gated_ffn:
        s["w_gate"] = Spec((d, dh), ("embed", "mlp"))
    return s


def apply_grouped(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x ``[E, C, M]`` -> ``[E, C, M]``."""
    act = ACTS[cfg.ffn_act]
    dt = x.dtype
    h = torch.bmm(x, params["w_up"].to(dt))
    if cfg.gated_ffn:
        h = act(torch.bmm(x, params["w_gate"].to(dt))) * h
    else:
        h = act(h)
    return torch.bmm(h, params["w_down"].to(dt))


def apply_shared(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Dense always-on shared experts. x ``[T, M]`` -> ``[T, M]``."""
    act = ACTS[cfg.ffn_act]
    dt = x.dtype
    h = x @ params["w_up"].to(dt)
    if cfg.gated_ffn:
        h = act(x @ params["w_gate"].to(dt)) * h
    else:
        h = act(h)
    return h @ params["w_down"].to(dt)
