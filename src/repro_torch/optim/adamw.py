"""AdamW with fp32 moments, as ``repro.optim.adamw`` without the 8-bit
moments.

The update repeats the JAX package's arithmetic in the same order —
bias-corrected moments, then ``weight_decay * p`` added to the step
(decoupled decay), then ``p - lr * lr_scale * step`` — rather than
``torch.optim.AdamW``, which decays the parameter before the step and so
rounds differently. Scalars that JAX computes as float32 arrays (the
bias corrections, ``lr * lr_scale``) are computed as numpy float32 here.

Unlike the JAX package, which returns new trees, the update writes the
parameters and moments in place: the full-width model's fp32 weights and
moments are ~23 GB, and a second copy would not fit beside the
activations.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.models.module import leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zeros_like(v) for v in tree]
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def init(params, cfg: AdamWConfig) -> Dict:
    return {"m": _zeros_like(params), "v": _zeros_like(params), "count": 0}


@torch.no_grad()
def update(grads, state: Dict, params, cfg: AdamWConfig,
           lr_scale=1.0) -> Dict:
    """One AdamW step: ``params`` and the moments are updated in place;
    returns the new state. ``grads`` mirrors ``params`` (leaves may be
    None for a parameter that got no gradient: it is treated as zero)."""
    count = state["count"] + 1
    f32 = np.float32
    b1c = f32(1) - f32(cfg.b1) ** f32(count)
    b2c = f32(1) - f32(cfg.b2) ** f32(count)
    lr = float(f32(cfg.lr) * f32(lr_scale))
    b1c, b2c = float(b1c), float(b2c)
    for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                          leaves(state["v"]), leaves(params)):
        g = torch.zeros_like(m) if g is None else g.float()
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g * g * (1 - cfg.b2))
        step = (m / b1c) / ((v / b2c).sqrt_() + cfg.eps)
        if cfg.weight_decay:
            step.add_(p.float() * cfg.weight_decay)
        p.copy_(p.float() - step.mul_(lr))
    return {"m": state["m"], "v": state["v"], "count": count}
