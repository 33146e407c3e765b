"""Token embedding + output head (optionally tied), as in
``repro.models.layers.embedding``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.module import Spec


def specs(cfg: ArchConfig):
    s = {"tok": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                     "embed", 1.0)}
    if cfg.positional == "learned":
        s["pos"] = Spec((cfg.max_position, cfg.d_model), (None, "embed"),
                        "embed", 0.02)
    if not cfg.tie_embeddings:
        s["head"] = Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return s


def embed(params, tokens: torch.Tensor, cfg: ArchConfig, positions=None,
          dtype=None):
    x = params["tok"][tokens]
    if dtype is not None:
        x = x.to(dtype)
    if cfg.tie_embeddings:
        x = x * (cfg.d_model ** 0.5)          # gemma-style scaling
    if cfg.positional == "learned" and positions is not None:
        x = x + params["pos"][positions].to(x.dtype)
    return x


def logits(params, x: torch.Tensor, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return x @ params["tok"].to(x.dtype).t()
    return x @ params["head"].to(x.dtype)
