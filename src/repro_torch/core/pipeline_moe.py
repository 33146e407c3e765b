"""MPipeMoE's micro-batch pipelined MoE on one device.

The counterpart of ``repro.core.pipeline_moe`` with ``ep_size == 1``:
the token batch is split into ``n`` chunks along the token axis, and
each chunk is routed, dispatched into an ``[E, C, M]`` buffer (the
paper's ``T_DI``), run through the expert FFNs and combined, with the
capacity ``C`` computed from the chunk's token count. In ``mode="train"``
each chunk runs under the config's memory-reuse strategy
(``core.strategies``). The adaptive controller and the engine's prefill
buckets hand this layer a config with a concrete ``(n, strategy)``
(``core.selector``); a config that still holds the placeholders runs
``"adaptive"`` as ``Strategy.NONE`` and ``num_partitions`` 0 as n = 4,
as in the JAX package. With one device there are no All-to-
Alls; the overlap of chunk i+1's communication under chunk i's expert
GEMMs and the expert-parallel layouts come with ROADMAP.md's 'Expert
parallelism' slice.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.strategies import restore_t_di, wrap_chunk
from repro_torch.core.types import Strategy
from repro_torch.device import dtype_of
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


def strategy_of(cfg: ArchConfig) -> Strategy:
    """The config's memory-reuse strategy; an unresolved ``"adaptive"``
    runs as ``NONE``."""
    s = cfg.moe.memory_reuse_strategy
    return Strategy.NONE if s == "adaptive" else Strategy(s)


def _chunk_fn(params, chunk: torch.Tensor, stash=None, *, cfg: ArchConfig,
              cap: int):
    """route and plan (one router launch) -> dispatch -> expert FFN ->
    combine (one device). ``stash`` holds ``T_DI`` between the forward
    pass and its recompute under S1/S3 (``strategies.restore_t_di``)."""
    m = cfg.moe
    t = chunk.shape[0]
    probs, _, dest, aux = R.route_and_plan(params["router"], chunk, cfg, cap)
    buf = restore_t_di(                                    # [E, cap, M]
        chunk, dest, lambda: D.dispatch(chunk, dest, m.num_experts, cap),
        stash)
    eout = E.apply_grouped(params["experts"], buf, cfg)
    out = D.combine(eout, dest, probs, t)
    if m.num_shared_experts:
        out = out + E.apply_shared(params["shared"], chunk, cfg)
    return out, aux


def pipelined_moe(params, tokens: torch.Tensor, *, cfg: ArchConfig,
                  mode: str = "prefill") -> Tuple[torch.Tensor, dict]:
    """tokens ``[T, M]`` -> (``[T, M]``, aux losses averaged over
    chunks). ``mode="decode"`` runs one chunk, as in the JAX package;
    ``mode="train"`` wraps each chunk in the config's strategy.

    The expert weights are cast to the compute dtype once, before the
    chunk loop (as the JAX package gathers them once outside it): a cast
    inside a chunk would keep one copy per chunk alive for backward."""
    m = cfg.moe
    dt = dtype_of(cfg.compute_dtype)
    params = dict(params, experts={k: v.to(dt) for k, v in
                                   params["experts"].items()})
    t_local = tokens.shape[0]
    n = _resolve_partitions(cfg, t_local, mode)
    chunk_t = t_local // n
    cap = capacity_for(chunk_t, m.top_k, m.capacity_factor, m.num_experts)

    def chunk_fn(p, c, stash=None):
        return _chunk_fn(p, c, stash, cfg=cfg, cap=cap)

    if mode == "train":
        chunk_fn = wrap_chunk(chunk_fn, strategy_of(cfg))
    outs, auxes = [], []
    for i in range(n):
        o, a = chunk_fn(params, tokens[i * chunk_t:(i + 1) * chunk_t])
        outs.append(o)
        auxes.append(a)
    out = torch.cat(outs, dim=0) if n > 1 else outs[0]
    aux = {k: sum(a[k] for a in auxes) / float(n) for k in auxes[0]}
    return out, aux
