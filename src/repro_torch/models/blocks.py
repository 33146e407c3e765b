"""Transformer blocks: attention mixer + dense FFN or MoE, pre-norm, as
the attention roles of ``repro.models.blocks``. Mamba, xLSTM and cross-
attention blocks come with ROADMAP.md's 'Other architectures' slice."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import attention, ffn, norm
from repro_torch.moe import layer as moe_layer


def block_specs(cfg: ArchConfig, role: Dict):
    if role["mixer"] != "attn":
        raise NotImplementedError(
            f"mixer {role['mixer']!r} comes with ROADMAP.md's 'Other "
            f"architectures' slice")
    s = {"mixer_norm": norm.specs(cfg.d_model, cfg.norm),
         "mixer": attention.specs(cfg)}
    if role["moe"]:
        s["ffn_norm"] = norm.specs(cfg.d_model, cfg.norm)
        s["moe"] = moe_layer.specs(cfg)
        if cfg.moe.dense_residual and cfg.d_ff:
            s["ffn"] = ffn.specs(cfg.d_model, cfg.d_ff, cfg.gated_ffn)
    elif cfg.d_ff:
        s["ffn_norm"] = norm.specs(cfg.d_model, cfg.norm)
        s["ffn"] = ffn.specs(cfg.d_model, cfg.d_ff, cfg.gated_ffn)
    return s


def block_apply(params, x: torch.Tensor, *, cfg: ArchConfig, role: Dict,
                positions, mode: str = "prefill",
                cache: Optional[dict] = None, dist=None,
                replicated: bool = False):
    """Returns (x, aux, new_cache). ``dist``: the ``DistContext`` the MoE
    layer runs expert parallelism over (attention and dense layers run
    on this rank's rows, the same on every rank of an EP group);
    ``replicated``: the rows are the same on every rank of the dp group
    too (``moe.layer.apply``)."""
    h = norm.apply(params["mixer_norm"], x, cfg.norm)
    mix, new_cache = attention.apply(params["mixer"], h, cfg=cfg,
                                     positions=positions,
                                     is_global=role["global_attn"],
                                     mode=mode, cache=cache)
    x = x + mix
    aux = {}
    if role["moe"]:
        h = norm.apply(params["ffn_norm"], x, cfg.norm)
        moe_out, aux = moe_layer.apply(params["moe"], h, cfg=cfg, mode=mode,
                                       dist=dist, replicated=replicated)
        if cfg.moe.dense_residual and cfg.d_ff:
            moe_out = moe_out + ffn.apply(params["ffn"], h, act=cfg.ffn_act,
                                          gated=cfg.gated_ffn)
        x = x + moe_out
    elif cfg.d_ff:
        h = norm.apply(params["ffn_norm"], x, cfg.norm)
        x = x + ffn.apply(params["ffn"], h, act=cfg.ffn_act,
                          gated=cfg.gated_ffn)
    return x, aux, new_cache
