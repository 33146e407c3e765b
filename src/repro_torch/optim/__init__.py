"""Optimizers and the LR schedule, as ``repro.optim``: AdamW with fp32
moments. The 8-bit AdamW and Adafactor are ROADMAP.md Queue 1 items."""
from __future__ import annotations

import math

import numpy as np

from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig


def get_optimizer(name: str, lr: float = 1e-3):
    """Returns (module, config) for ``'adamw'``; ``'adamw8bit'`` and
    ``'adafactor'`` are not ported yet."""
    if name == "adamw":
        return adamw, AdamWConfig(lr=lr)
    if name in ("adamw8bit", "adafactor"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP.md Queue 1, "
            f"'Optimizers')")
    raise ValueError(name)


def lr_schedule(step: int, *, base_lr: float = 1.0, warmup: int = 100,
                total: int = 10_000, min_ratio: float = 0.1) -> float:
    """Linear warmup + cosine decay multiplier (applied as lr_scale), in
    float32 as the JAX package computes it."""
    f32 = np.float32
    warm = min(f32(step) / f32(max(warmup, 1)), f32(1.0))
    progress = np.clip(f32(step - warmup) / f32(max(total - warmup, 1)),
                       f32(0.0), f32(1.0))
    cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * progress,
                                      dtype=np.float32))
    return float(f32(base_lr) * warm
                 * (f32(min_ratio) + f32(1 - min_ratio) * cos))


__all__ = ["adamw", "AdamWConfig", "get_optimizer", "lr_schedule"]
