"""Optimizers and the LR schedule, as ``repro.optim``: AdamW with fp32 or
8-bit moments, and Adafactor. Each takes the parameter tree and its
gradient tree; the two memory-lean ones read the period leaves as the
JAX package's stacked leaves (``optim.groups``)."""
from __future__ import annotations

import math

import numpy as np

from repro_torch.optim import adafactor, adamw
from repro_torch.optim.adafactor import AdafactorConfig
from repro_torch.optim.adamw import AdamWConfig


def get_optimizer(name: str, lr: float = 1e-3):
    """Returns (module, config) for 'adamw' | 'adamw8bit' | 'adafactor'."""
    if name == "adamw":
        return adamw, AdamWConfig(lr=lr)
    if name == "adamw8bit":
        return adamw, AdamWConfig(lr=lr, quantize_moments=True)
    if name == "adafactor":
        return adafactor, AdafactorConfig(lr=lr)
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


__all__ = ["adafactor", "adamw", "AdafactorConfig", "AdamWConfig",
           "get_optimizer", "lr_schedule"]
