"""Rotary position embeddings (standard RoPE), as
``repro.models.layers.rope``'s ``apply_rope``. M-RoPE comes with
ROADMAP.md's 'Other architectures' slice.

An angle is ``position * freq``, so one ulp of a frequency moves the
angle at position 4095 by ~6e-5 rad. Under ``jit`` (how the JAX model
always runs) XLA folds the JAX package's fp32 frequency formula as a
constant, which gives the float64 values rounded once to fp32; an fp32
``pow`` evaluated op by op misses by an ulp in 10 of 32 frequencies at
head_dim 64. So the port computes them in float64 and rounds (pinned by
``tests/test_torch_mla.py``).
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """The ``head_dim // 2`` rotation frequencies, made once per device
    (a decode step would otherwise launch five kernels a call for them)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float64, device=device) / half
    return (1.0 / (theta ** exps)).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x ``[..., S, H, D]``; positions broadcastable to ``[..., S]``.
    Returns x rotated, in x's dtype (the rotation is taken in fp32)."""
    half = x.shape[-1] // 2
    freqs = _freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs           # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                   # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
