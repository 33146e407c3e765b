"""MoE layer on one device: router + dispatch + the pipelined engine, as
the single-device branch of ``repro.moe.layer.apply``. The expert-
parallel ``shard_map`` entry comes with ROADMAP.md's 'Expert
parallelism' slice."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.pipeline_moe import pipelined_moe
from repro_torch.moe import experts as E
from repro_torch.moe import router as R


def specs(cfg: ArchConfig):
    s = {"router": R.specs(cfg), "experts": E.specs(cfg)}
    if cfg.moe.num_shared_experts:
        s["shared"] = E.shared_specs(cfg)
    return s


def apply(params, x: torch.Tensor, *, cfg: ArchConfig,
          mode: str = "prefill") -> Tuple[torch.Tensor, dict]:
    """x ``[B, S, M]`` -> (``[B, S, M]``, aux)."""
    b, s, d = x.shape
    out, aux = pipelined_moe(params, x.reshape(b * s, d), cfg=cfg,
                             mode=mode)
    return out.reshape(b, s, d), aux
