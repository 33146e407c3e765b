"""Sampling for the serving engine: greedy, or temperature / top-k /
top-p, plus host-side stop matching — as in ``repro.serve.sampling``.

``temperature <= 0`` is greedy: the exact argmax of the fp32 logits,
ties to the lowest token id. Otherwise the keep set is decided by
*rank* in a stable descending sort (ties broken by token id), never by
comparing against a threshold value, so ``top_k=1`` over equal logits is
the argmax.

Determinism: each sampled token draws from a ``torch.Generator`` seeded
from ``(seed, position)``, where ``position`` is the index of the token
being generated — a function of the request alone, so its tokens do not
depend on batch composition, slot or preemption. The draws are not the
JAX package's (threefry bits cannot be reproduced), so parity across the
two packages covers greedy decoding only.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence, Tuple

import torch

NEG_INF = -1.0e30

__all__ = ["SamplingParams", "normalize_stops", "sample_tokens",
           "stop_hit"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs. ``temperature <= 0`` selects greedy
    decoding (the default); ``top_k <= 0`` and ``top_p`` outside (0, 1)
    disable the respective filter. ``seed`` names the request's private
    random stream."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def stream_seed(seed: int, position: int) -> int:
    """64-bit generator seed of token ``position`` of stream ``seed``."""
    digest = hashlib.blake2b(f"{int(seed)}:{int(position)}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def _sample_row(lg: torch.Tensor, sp: SamplingParams,
                position: int) -> torch.Tensor:
    """One row of fp32 logits ``[V]`` -> a sampled token id (0-d)."""
    v = lg.shape[-1]
    scaled = lg / sp.temperature
    sort_idx = torch.argsort(-scaled, stable=True)
    rank = torch.empty_like(sort_idx)
    rank[sort_idx] = torch.arange(v, device=lg.device)
    order = scaled[sort_idx]                               # descending
    k_eff = v if sp.top_k <= 0 else min(max(sp.top_k, 1), v)
    p_eff = 1.0 if (sp.top_p <= 0.0 or sp.top_p >= 1.0) else sp.top_p
    probs = torch.softmax(order, dim=-1)
    below = torch.cumsum(probs, dim=-1) - probs            # mass before
    n_keep = torch.clamp((below < p_eff).sum(), min=1, max=k_eff)
    masked = torch.where(rank < n_keep, scaled, NEG_INF)
    gen = torch.Generator(device=lg.device)
    gen.manual_seed(stream_seed(sp.seed, position))
    return torch.multinomial(torch.softmax(masked, dim=-1), 1,
                             generator=gen)[0]


def sample_tokens(logits: torch.Tensor,
                  params: Sequence[Optional[SamplingParams]],
                  positions: Sequence[int]) -> torch.Tensor:
    """One token per row of ``logits`` ``[S, V]``. ``params[i]`` is row
    i's sampling (None = an inactive row, sampled greedily and ignored);
    ``positions[i]`` the index of the token being generated. Rows are
    independent. Returns int64 ``[S]`` on the logits' device."""
    lg = logits.float()
    out = lg.argmax(dim=-1)
    for i, sp in enumerate(params):
        if sp is not None and not sp.greedy:
            out[i] = _sample_row(lg[i], sp, positions[i])
    return out


def normalize_stops(stop) -> Tuple[Tuple[int, ...], ...]:
    """Canonicalize stop sequences: tuple of non-empty int tuples."""
    if not stop:
        return ()
    out = []
    for s in stop:
        s = (int(s),) if isinstance(s, int) else tuple(int(t) for t in s)
        if s:
            out.append(s)
    return tuple(out)


def stop_hit(output: Sequence[int],
             stop: Sequence[Sequence[int]]) -> Optional[Tuple[int, ...]]:
    """The stop sequence the output now ends with, or None."""
    for s in stop:
        n = len(s)
        if n and len(output) >= n and tuple(output[-n:]) == tuple(s):
            return tuple(s)
    return None
