"""Expert FFN compute, as in ``repro.moe.experts``: the grouped 2-GEMM
(optionally gated) over the ``[E, C, M]`` buffer.

``apply_grouped`` runs through the hand-written ``grouped_ffn`` kernel on
the card (its plain version on the CPU): the function of the JAX
package's ``apply_grouped(use_kernel=True)``, whose jnp branch computes
the same thing (``T_M`` is never stored; the backward rebuilds it).
The shared experts stay plain products.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.grouped_ffn import grouped_ffn
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
    """x ``[E, C, M]`` -> ``[E, C, M]``. The weights are cast to x's
    dtype here unless the caller cast them already (``pipelined_moe``
    does, once per layer)."""
    dt = x.dtype
    w_gate = params["w_gate"].to(dt) if cfg.gated_ffn else None
    return grouped_ffn(x, params["w_up"].to(dt), w_gate,
                       params["w_down"].to(dt), cfg.ffn_act)


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
