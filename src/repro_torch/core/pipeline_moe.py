"""MPipeMoE's micro-batch pipelined MoE, as ``repro.core.pipeline_moe``.

The local token batch is split into ``n`` chunks along the token axis,
and each chunk is routed, dispatched into an ``[E, C, M]`` buffer,
run through the expert FFNs and combined, with the capacity ``C``
computed from the chunk's (local) token count. In ``mode="train"`` each
chunk runs under the config's memory-reuse strategy
(``core.strategies``). The adaptive controller and the engine's prefill
buckets hand this layer a config with a concrete ``(n, strategy)``
(``core.selector``); a config that still holds the placeholders runs
``"adaptive"`` as ``Strategy.NONE`` and ``num_partitions`` 0 as n = 4,
as in the JAX package.

One chunk body serves one device and expert parallelism (``dist`` with
``ep_size > 1``, each rank holding ``E / ep`` experts), as the JAX
package's ``_chunk_fn`` does; it is split in three around its
collectives (``_dispatch``, ``_experts``, ``_combine``), which one
device skips:

* sharded (train, prefill): each rank routes its own tokens; the
  dispatch All-to-All turns ``[ep, e_local, cap, M]`` (by destination)
  into ``[ep(src), e_local, cap, M]``, the paper's ``T_DI``, which is
  laid out ``[e_local, ep·cap, M]`` for the expert FFN kernel; the
  combine All-to-All sends the outputs back. With
  ``cfg.moe.pipeline_unroll`` (the default) chunk i+1's dispatch
  All-to-All is issued asynchronously before chunk i's expert FFN and
  waited on just before chunk i+1's, and chunk i's combine All-to-All
  runs under chunk i+1's FFN (the paper's Fig. 5 pipeline; the JAX
  package leaves it to XLA's scheduler). ``pipeline_unroll=False``, and
  one device, run the chunks one after another, as the JAX package's
  ``lax.scan``: the same operations on the same data. The overlap
  covers the forward pass; autograd runs the backward's collectives in
  order.
* replicated (decode): every rank routes the same tokens, runs its own
  experts, and an ``all_reduce`` sums the outputs.

ZeRO-3 expert shards (``moe.layer.zero3_ok``: their last dim split over
``dp``) are gathered once, before the chunk loop, so the backward is
one reduce-scatter.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.strategies import (TdiStash, recompute, restore_t_di,
                                         wrap_chunk)
from repro_torch.core.types import Strategy
from repro_torch.device import dtype_of
from repro_torch.distributed import collectives as C
from repro_torch.moe import dispatch as D
from repro_torch.moe import experts as E
from repro_torch.moe import router as R

__all__ = ["capacity_for", "gather_expert_weights", "pipelined_moe"]


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


class _Chunk:
    """One chunk between its dispatch and its combine: routing results,
    the (received) ``T_DI`` and the collective in flight."""

    def __init__(self, tokens, probs, dest, aux, buf, pending):
        self.tokens, self.probs, self.dest, self.aux = tokens, probs, dest, aux
        self.buf, self.pending = buf, pending


def _dispatch(params, chunk, *, cfg: ArchConfig, cap: int, group,
              async_op: bool = False, stash=None) -> _Chunk:
    """route and plan (one router launch) -> dispatch -> under expert
    parallelism the dispatch All-to-All over ``group`` (``None``: one
    device, no collective). ``T_DI``: ``[ep(src)·e_local, cap, M]``. A
    ``stash`` (S1/S3) keeps ``T_DI`` between the forward pass and its
    recompute (``strategies.restore_t_di``)."""
    m = cfg.moe
    probs, _, dest, aux = R.route_and_plan(params["router"], chunk, cfg, cap)
    pending = C.Pending()

    def send():
        nonlocal pending
        buf = D.dispatch(chunk, dest, m.num_experts, cap)  # [E, cap, M]
        if group is not None:
            buf, pending = C.all_to_all(buf, group, async_op)
        return buf

    buf = restore_t_di(chunk, dest, send, stash, group)
    return _Chunk(chunk, probs, dest, aux, buf, pending)


def _experts(params, c: _Chunk, *, cfg: ArchConfig, cap: int, ep: int,
             group, async_op: bool = False):
    """``T_DI`` -> ``[e_local, ep·cap, M]`` -> expert FFN -> the combine
    All-to-All started (none on one device, where the layouts are
    views); returns (its output, its Pending)."""
    c.pending.wait()
    e_local = cfg.moe.num_experts // ep
    m = c.buf.shape[-1]
    ein = c.buf.reshape(ep, e_local, cap, m).transpose(0, 1).reshape(
        e_local, ep * cap, m)
    eout = E.apply_grouped(params["experts"], ein, cfg)   # paper's T_DO
    eout = eout.reshape(e_local, ep, cap, m).transpose(0, 1)
    if group is None:
        return eout, C.Pending()
    return C.all_to_all(eout, group, async_op)


def _combine(params, c: _Chunk, back, pending, *, cfg: ArchConfig,
             cap: int):
    pending.wait()
    m = cfg.moe
    out = D.combine(back.reshape(m.num_experts, cap, -1), c.dest, c.probs,
                    c.tokens.shape[0])
    if m.num_shared_experts:
        out = out + E.apply_shared(params["shared"], c.tokens, cfg)
    return out, c.aux


def _chunk_fn(params, chunk, stash=None, *, cfg: ArchConfig, cap: int,
              ep: int, group):
    """route -> dispatch -> A2A -> expert FFN -> A2A -> combine, its
    collectives synchronous: the serial schedule's body and what every
    strategy recomputes."""
    c = _dispatch(params, chunk, cfg=cfg, cap=cap, group=group, stash=stash)
    back, pending = _experts(params, c, cfg=cfg, cap=cap, ep=ep, group=group)
    return _combine(params, c, back, pending, cfg=cfg, cap=cap)


def _forward(params, chunks, stashes, *, cfg: ArchConfig, cap: int,
             ep: int, group, overlap: bool):
    """Every chunk, one after another, or with ``overlap`` in the
    pipeline's order: chunk i+1's dispatch is issued before chunk i's
    expert FFN, and chunk i's combine is waited on after chunk i+1's
    FFN. A stash (S1/S3) keeps each chunk's ``T_DI`` once it has
    arrived."""
    n = len(chunks)
    if not overlap:
        return [_chunk_fn(params, chunks[i], stashes[i], cfg=cfg, cap=cap,
                          ep=ep, group=group) for i in range(n)]
    kw = dict(cfg=cfg, cap=cap, group=group, async_op=True)
    outs = []
    cur = _dispatch(params, chunks[0], **kw)
    prev = None
    for i in range(n):
        nxt = _dispatch(params, chunks[i + 1], **kw) if i + 1 < n else None
        back, pending = _experts(params, cur, ep=ep, **kw)
        if stashes[i] is not None:
            stashes[i].keep(cur.buf)
        if prev is not None:
            outs.append(_combine(params, *prev, cfg=cfg, cap=cap))
        prev, cur = (cur, back, pending), nxt
    outs.append(_combine(params, *prev, cfg=cfg, cap=cap))
    return outs


def _replicated_decode(params, tokens, *, cfg: ArchConfig, ep: int,
                       ep_rank: int, group):
    """Decode: tokens replicated over the EP group; each rank runs its
    own experts on their rows of the full dispatch buffer and an
    ``all_reduce`` sums the outputs."""
    m = cfg.moe
    e_local = m.num_experts // ep
    t = tokens.shape[0]
    cap = capacity_for(t, m.top_k, max(m.capacity_factor, 2.0),
                       m.num_experts)
    probs, _, dest, aux = R.route_and_plan(params["router"], tokens, cfg,
                                           cap)
    buf = D.dispatch(tokens, dest, m.num_experts, cap)     # [E, cap, M]
    mine = slice(ep_rank * e_local, (ep_rank + 1) * e_local)
    full = torch.zeros_like(buf)
    full[mine] = E.apply_grouped(params["experts"], buf[mine].contiguous(),
                                 cfg)
    torch.distributed.all_reduce(full, group=group)
    out = D.combine(full, dest, probs, t)
    if m.num_shared_experts:
        out = out + E.apply_shared(params["shared"], tokens, cfg)
    return out, aux


def gather_expert_weights(params, dp_group):
    """The ZeRO-3 gather: expert shards split on their last dim over
    ``dp_group`` (``None``: whole leaves, nothing to gather) are
    all-gathered once, here, outside the chunk loop, so the backward
    pass is one reduce-scatter of the accumulated gradient."""
    if dp_group is None:
        return params
    return dict(params, experts={
        k: C.all_gather(v, dp_group, -1)
        for k, v in params["experts"].items()})


def _pipeline(params, chunks, *, cfg: ArchConfig, cap: int, ep: int,
              group, mode: str):
    """The chunks -> [(out, aux)] under the config's strategy
    (``core.strategies``). The serial schedule (one device, or
    ``pipeline_unroll=False``) wraps each chunk in ``wrap_chunk``'s
    checkpoint. The overlapped one interleaves the chunks' forward
    passes, so under a strategy other than NONE they run without a
    graph and each chunk is recomputed alone in the backward pass
    (``strategies.recompute``). Either way S2/S4 re-run the dispatch
    (and its All-to-All), and S1/S3 take ``T_DI`` from the stash and
    send its cotangent back through the reverse All-to-All."""
    strategy = strategy_of(cfg) if mode == "train" else Strategy.NONE
    overlap = group is not None and cfg.moe.pipeline_unroll
    if strategy == Strategy.NONE:
        return _forward(params, chunks, [None] * len(chunks), cfg=cfg,
                        cap=cap, ep=ep, group=group, overlap=overlap)

    def chunk_fn(p, c, stash=None):
        return _chunk_fn(p, c, stash, cfg=cfg, cap=cap, ep=ep, group=group)

    if not overlap:
        fn = wrap_chunk(chunk_fn, strategy)
        return [fn(params, c) for c in chunks]
    keeps = "t_di" in strategy.offloads
    stashes = [TdiStash() if keeps else None for _ in chunks]
    with torch.no_grad():
        results = _forward(params, chunks, stashes, cfg=cfg, cap=cap,
                           ep=ep, group=group, overlap=True)
    return [recompute(lambda p, c, s=s: chunk_fn(p, c, s), params, c, r)
            for c, s, r in zip(chunks, stashes, results)]


def pipelined_moe(params, tokens: torch.Tensor, *, cfg: ArchConfig,
                  mode: str = "prefill", dist=None, zero3: bool = False,
                  n: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """tokens ``[T_local, M]`` -> (``[T_local, M]``, aux losses averaged
    over chunks). ``mode="decode"`` runs one chunk, as in the JAX
    package; ``mode="train"`` wraps each chunk in the config's strategy.
    ``dist`` (a ``DistContext``): this rank holds ``E / ep`` experts
    (maybe ZeRO-3 shards of them) and its own tokens, or under
    ``mode="decode"`` the EP group's tokens; ``zero3``: its expert
    leaves are ZeRO-3 shards over the dp group (``moe.layer.zero3_ok``).
    ``n``: the chunk count (default: the config's, resolved on these
    tokens).

    The expert weights are cast to the compute dtype once, before the
    chunk loop (as the JAX package gathers them once outside it): a cast
    inside a chunk would keep one copy per chunk alive for backward."""
    m = cfg.moe
    dt = dtype_of(cfg.compute_dtype)
    params = gather_expert_weights(params, dist.dp_group if zero3 else None)
    params = dict(params, experts={k: v.to(dt) for k, v in
                                   params["experts"].items()})
    ep = dist.ep_size if dist is not None else 1
    if mode == "decode" and ep > 1:
        return _replicated_decode(params, tokens, cfg=cfg, ep=ep,
                                  ep_rank=dist.ep_rank, group=dist.ep_group)
    t_local = tokens.shape[0]
    n = n or _resolve_partitions(cfg, t_local, mode)
    chunk_t = t_local // n
    cap = capacity_for(chunk_t, m.top_k, m.capacity_factor, m.num_experts)
    chunks = [tokens[i * chunk_t:(i + 1) * chunk_t] for i in range(n)]
    outs = _pipeline(params, chunks, cfg=cfg, cap=cap, ep=ep,
                     group=dist.ep_group if ep > 1 else None, mode=mode)
    out = torch.cat([o for o, _ in outs], dim=0) if n > 1 else outs[0][0]
    aux = {k: sum(a[k] for _, a in outs) / float(n) for k in outs[0][1]}
    return out, aux
