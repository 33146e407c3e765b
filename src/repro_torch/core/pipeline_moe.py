"""MPipeMoE's micro-batch pipelined MoE, forward only, one device.

The counterpart of ``repro.core.pipeline_moe`` with ``ep_size == 1``:
the token batch is split into ``n`` chunks along the token axis, and
each chunk is routed, dispatched into an ``[E, C, M]`` buffer, run
through the expert FFNs and combined, with the capacity ``C`` computed
from the chunk's token count. With one device there are no All-to-Alls;
the paper's overlap of chunk i+1's communication under chunk i's expert
GEMMs, its memory-reuse strategies S1–S4 and the expert-parallel layouts
come with ROADMAP.md's 'Training' and 'Expert parallelism' slices.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.moe import dispatch as D
from repro_torch.moe import experts as E
from repro_torch.moe import router as R

__all__ = ["capacity_for", "pipelined_moe"]


def capacity_for(tokens: int, top_k: int, cf: float, num_experts: int,
                 multiple: int = 8) -> int:
    cap = max(1, math.ceil(tokens * top_k * cf / num_experts))
    return -(-cap // multiple) * multiple


def _resolve_partitions(cfg: ArchConfig, t_local: int, mode: str) -> int:
    if mode == "decode" or not cfg.moe.pipeline:
        return 1
    n = cfg.moe.num_partitions or 4          # 0 = adaptive; default 4
    n = max(1, min(n, t_local))
    while t_local % n:
        n -= 1
    return n


def _chunk_fn(params, chunk: torch.Tensor, *, cfg: ArchConfig, cap: int):
    """route -> dispatch -> expert FFN -> combine (one device)."""
    m = cfg.moe
    t = chunk.shape[0]
    probs, eidx, aux = R.route(params["router"], chunk, cfg)
    dest, _ = D.dispatch_plan(eidx, m.num_experts, cap)
    buf = D.dispatch(chunk, dest, m.num_experts, cap)      # [E, cap, M]
    eout = E.apply_grouped(params["experts"], buf, cfg)
    out = D.combine(eout, dest, probs, t)
    if m.num_shared_experts:
        out = out + E.apply_shared(params["shared"], chunk, cfg)
    return out, aux


def pipelined_moe(params, tokens: torch.Tensor, *, cfg: ArchConfig,
                  mode: str = "prefill") -> Tuple[torch.Tensor, dict]:
    """tokens ``[T, M]`` -> (``[T, M]``, aux losses averaged over
    chunks). ``mode="decode"`` runs one chunk, as in the JAX package."""
    if mode == "train":
        raise NotImplementedError(
            "the training forward (strategies S1-S4) is ROADMAP.md's "
            "'Training' slice")
    m = cfg.moe
    t_local = tokens.shape[0]
    n = _resolve_partitions(cfg, t_local, mode)
    chunk_t = t_local // n
    cap = capacity_for(chunk_t, m.top_k, m.capacity_factor, m.num_experts)
    outs, auxes = [], []
    for i in range(n):
        o, a = _chunk_fn(params, tokens[i * chunk_t:(i + 1) * chunk_t],
                         cfg=cfg, cap=cap)
        outs.append(o)
        auxes.append(a)
    out = torch.cat(outs, dim=0) if n > 1 else outs[0]
    aux = {k: sum(a[k] for a in auxes) / float(n) for k in auxes[0]}
    return out, aux
