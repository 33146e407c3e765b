"""Rotary position embeddings (standard RoPE), as
``repro.models.layers.rope``'s ``apply_rope``. M-RoPE comes with
ROADMAP.md's 'Other architectures' slice.

An angle is ``position * freq``, so one ulp of a frequency moves the
angle at position 4095 by ~6e-5 rad. Under ``jit`` (how the JAX model
always runs) XLA folds the JAX package's fp32 frequency formula as a
constant: it turns ``arange / half`` into ``arange * fp32(1 / half)``
(rounded to fp32, inexact where ``half`` is no power of two: head_dim 80
gives half 40), then evaluates the power and the reciprocal in float64
and rounds once to fp32. An fp32 ``pow`` evaluated op by op misses by an
ulp in 10 of 32 frequencies at head_dim 64, and an exact float64
exponent misses at head_dim 80. So the port follows the folding step by
step (pinned at head dims 8 to 256 and thetas 10k, 500k and 1M by
``tests/test_torch_mla.py`` and ``tests/test_torch_gqa_rope.py``).
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """The ``head_dim // 2`` rotation frequencies, made once per device
    (a decode step would otherwise launch five kernels a call for them)."""
    half = head_dim // 2
    exps = (torch.arange(half, dtype=torch.float32)
            * torch.tensor(1.0 / half, dtype=torch.float32))
    return (1.0 / (theta ** exps.double())).float().to(device)


def thetas(cfg) -> tuple:
    """The rotation bases ``cfg``'s GQA layers use: ``rope_theta`` and,
    where the config sets it, ``rope_local_theta`` (gemma3's local
    layers). Empty without rotary positions."""
    a = cfg.attn
    if cfg.positional != "rope" or a.rope_theta == 0.0 or a.mla is not None:
        return ()
    out = {a.rope_theta}
    if a.rope_local_theta and any(not r["global_attn"]
                                  for r in cfg.layer_roles()):
        out.add(a.rope_local_theta)
    return tuple(sorted(out))


def prepare(cfg, device) -> None:
    """Make every frequency table ``cfg``'s GQA layers read on
    ``device``, so that none is first made inside a CUDA graph capture
    (the table would live in the graph's memory pool)."""
    dev = torch.empty(0, device=device).device      # with its index
    for theta in thetas(cfg):
        _freqs(cfg.head_dim, theta, dev)


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
