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
  ``cfg.moe.pipeline_unroll`` (the default) the chunks overlap (the
  paper's Fig. 5 pipeline; the JAX package leaves it to XLA's
  scheduler): chunk i+1's dispatch All-to-All is issued asynchronously
  before chunk i's expert FFN and waited on just before chunk i+1's, and
  chunk i's combine All-to-All runs under chunk i+1's FFN. The backward
  pass overlaps too: the layer's chunks run as one autograd function
  (``_Overlapped``) cut at their collectives, whose backward
  differentiates one stage at a time in ``backward_order`` and issues
  every All-to-All between stages asynchronously (the recomputed
  dispatch and combine under S2/S4, the recomputed combine under S1/S3,
  the two gradient ones under every strategy), so that each chunk's
  expert FFN, in its recompute or its backward, runs with another
  chunk's All-to-All in flight: chunk k-1's dispatch gradient, or under
  S2/S4 chunk k+1's recomputed dispatch. ``pipeline_unroll=False``,
  and one device, run the chunks one after another, as the JAX
  package's ``lax.scan``, their backward in autograd's order: the same
  operations on the same data.
* replicated (decode): every rank routes the same tokens, runs its own
  experts, and an ``all_reduce`` sums the outputs.

ZeRO-3 expert shards (``moe.layer.zero3_ok``: their last dim split over
``dp``) are gathered once, before the chunk loop, so the backward is
one reduce-scatter.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.strategies import (TdiStash, restore_t_di, undispatch,
                                         wrap_chunk)
from repro_torch.core.types import Strategy
from repro_torch.device import dtype_of
from repro_torch.distributed import collectives as C
from repro_torch.models.module import leaves, unflatten
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
    """One chunk between its dispatch and its combine: routing results
    and the (received) ``T_DI``."""

    def __init__(self, tokens, probs, dest, aux, buf):
        self.tokens, self.probs, self.dest, self.aux = tokens, probs, dest, aux
        self.buf = buf


def _dispatch(params, chunk, *, cfg: ArchConfig, cap: int, group,
              stash=None) -> _Chunk:
    """route and plan (one router launch) -> dispatch -> under expert
    parallelism the dispatch All-to-All over ``group`` (``None``: one
    device, no collective). ``T_DI``: ``[ep(src)·e_local, cap, M]``. A
    ``stash`` (S1/S3) keeps ``T_DI`` between the forward pass and its
    recompute (``strategies.restore_t_di``)."""
    m = cfg.moe
    probs, _, dest, aux = R.route_and_plan(params["router"], chunk, cfg, cap)

    def send():
        buf = D.dispatch(chunk, dest, m.num_experts, cap)  # [E, cap, M]
        if group is not None:
            buf = C.all_to_all(buf, group)
        return buf

    buf = restore_t_di(chunk, dest, send, stash, group)
    return _Chunk(chunk, probs, dest, aux, buf)


def _experts(params, c: _Chunk, *, cfg: ArchConfig, cap: int, ep: int,
             group):
    """``T_DI`` -> ``[e_local, ep·cap, M]`` -> expert FFN -> the combine
    All-to-All (none on one device, where the layouts are views)."""
    e_local = cfg.moe.num_experts // ep
    m = c.buf.shape[-1]
    ein = c.buf.reshape(ep, e_local, cap, m).transpose(0, 1).reshape(
        e_local, ep * cap, m)
    eout = E.apply_grouped(params["experts"], ein, cfg)   # paper's T_DO
    eout = eout.reshape(e_local, ep, cap, m).transpose(0, 1)
    return eout if group is None else C.all_to_all(eout, group)


def _combine(params, c: _Chunk, back, *, cfg: ArchConfig, cap: int):
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
    strategy recomputes there."""
    c = _dispatch(params, chunk, cfg=cfg, cap=cap, group=group, stash=stash)
    back = _experts(params, c, cfg=cfg, cap=cap, ep=ep, group=group)
    return _combine(params, c, back, cfg=cfg, cap=cap)


# ---------------------------------------------------------------------------
# The overlapped schedule
# ---------------------------------------------------------------------------

def backward_order(n: int, strategy: Strategy) -> List[Tuple[str, int]]:
    """The overlapped backward pass's units, ``(name, chunk)`` in the
    order they run. A chunk's units: under NONE ``Cb`` (the combine's
    backward; issues the combine's gradient All-to-All), ``Fw`` (waits on
    it), ``Fb`` (the expert FFN's backward; issues the dispatch's
    gradient All-to-All) and ``Db`` (the route's and dispatch's
    backward); under S1-S4 first ``Rd`` (route and dispatch again;
    issues the recomputed dispatch All-to-All; S1/S3 ``Rs``: route
    again, ``T_DI`` from the stash), ``Rf`` (the expert FFN again;
    issues the recomputed combine All-to-All) and ``RcCb`` (the combine
    again and its backward) in place of ``Cb``.

    The collectives of one group run in the order they are issued, so a
    collective is in flight across chunk k's FFN only if it was issued
    after the one that FFN waits on. As in the forward pipeline, the
    next chunk's collective is issued between that wait and chunk k's
    FFN backward: under NONE chunk k+1's combine gradient, under S2/S4
    chunk k+1's recomputed dispatch; and under S1-S4 chunk k's dispatch
    gradient stays in flight across chunk k+1's FFN recompute. Each FFN
    unit so has at most one other collective in flight, whose two
    buffers are what the backward holds beyond the serial schedule's,
    besides (S2/S4) the next chunk's route stage."""
    if strategy == Strategy.NONE:
        out = [("Cb", 0)]
        for k in range(n):
            ahead = [("Cb", k + 1)] if k + 1 < n else []
            out += [("Fw", k)] + ahead + [("Fb", k), ("Db", k)]
        return out
    first = "Rs" if "t_di" in strategy.offloads else "Rd"
    out = [(first, 0), ("Rf", 0), ("RcCb", 0)]
    for k in range(n):
        out.append(("Fw", k))
        if k + 1 == n:
            return out + [("Fb", k), ("Db", k)]
        ahead = [(first, k + 1)]
        out += (ahead + [("Fb", k)] if first == "Rd"
                else [("Fb", k)] + ahead)
        out += [("Rf", k + 1), ("Db", k), ("RcCb", k + 1)]
    return out


class _Cut(torch.autograd.Function):
    """Identity on ``x`` whose node holds nothing: a stage's input whose
    gradient is read at its edge, so that the buffer can go as soon as
    the stage's forward pass has read it (a leaf that requires grad is
    held by its accumulator). ``anchor``: a 0-d leaf that makes the
    output require grad."""

    @staticmethod
    def forward(ctx, x, anchor):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, None


def _edge(t: torch.Tensor):
    return torch.autograd.graph.get_gradient_edge(t)


def _grads(outputs, inputs, grad_outputs) -> list:
    """``torch.autograd.grad`` whose inputs may include tensors that do
    not require grad (their gradient is None)."""
    live = [i for i, x in enumerate(inputs)
            if not isinstance(x, torch.Tensor) or x.requires_grad]
    got = torch.autograd.grad(outputs, [inputs[i] for i in live],
                              grad_outputs, allow_unused=True)
    out = [None] * len(inputs)
    for i, g in zip(live, got):
        out[i] = g
    return out


class _Stage:
    """One chunk of the overlapped schedule, cut at its collectives."""

    t = probs = dest = aux = recv = back = pending = None
    ein = fo = b = p = out = None           # the stage graphs' ends
    d_probs = d_shared = d_fo = None


class _Overlap:
    """One MoE layer's ``n`` chunks under the overlapped schedule. Each
    chunk is cut at its collectives into three stages on inputs of their
    own: route and dispatch (``D``), the expert FFN on ``T_DI`` in its
    ``[e_local, ep·cap, M]`` layout (``F``) and the combine with the
    shared experts (``C``); ``start_all_to_all`` carries each stage's
    output to the next. ``forward`` runs the chunks in the pipeline's
    order (chunk i+1's dispatch issued before chunk i's expert FFN, chunk
    i's combine waited on after chunk i+1's FFN), keeping each stage's
    graph when ``graph`` is set (NONE under autograd) and ``T_DI`` in the
    chunk's stash (S1/S3). ``backward`` runs ``backward_order``'s units:
    ``torch.autograd.grad`` on one stage at a time, and each All-to-All
    between stages issued asynchronously and waited on just before its
    result is read."""

    def __init__(self, template, n: int, chunk_t: int, *, cfg: ArchConfig,
                 cap: int, ep: int, group, strategy: Strategy):
        self.template, self.n, self.ct = template, n, chunk_t
        self.cfg, self.cap, self.ep, self.group = cfg, cap, ep, group
        self.strategy = strategy
        self.e_local = cfg.moe.num_experts // ep
        keeps = "t_di" in strategy.offloads
        self.stashes = [TdiStash() if keeps else None for _ in range(n)]
        self.stages = [_Stage() for _ in range(n)]
        idx = unflatten(template, list(range(len(leaves(template)))))
        self.idx = {k: leaves(v) for k, v in idx.items()}
        self.anchor = None

    # -- layouts: T_DI [E, cap, M] (by source rank) <-> the FFN's
    def _to_ffn(self, x):
        m = x.shape[-1]
        return x.reshape(self.ep, self.e_local, self.cap, m).transpose(
            0, 1).reshape(self.e_local, self.ep * self.cap, m)

    def _from_ffn(self, y):
        return y.reshape(self.e_local, self.ep, self.cap,
                         y.shape[-1]).transpose(0, 1)

    # -- the stages' forward passes ------------------------------------
    def route(self, k, params, tokens, graph):
        s = self.stages[k]
        t = tokens[k * self.ct:(k + 1) * self.ct]
        s.t = t.detach().requires_grad_(tokens.requires_grad) if graph else t
        with torch.set_grad_enabled(graph):
            s.probs, _, s.dest, s.aux = R.route_and_plan(
                params["router"], s.t, self.cfg, self.cap)

    def dispatch(self, k, params, tokens, graph):
        self.route(k, params, tokens, graph)
        s = self.stages[k]
        with torch.no_grad():
            buf = D.dispatch(s.t.detach(), s.dest, self.cfg.moe.num_experts,
                             self.cap)
        s.recv, s.pending = C.start_all_to_all(buf, self.group)

    def experts(self, k, params, graph, keep=False):
        s = self.stages[k]
        s.pending.wait()
        if keep and self.stashes[k] is not None:
            self.stashes[k].keep(s.recv)
        with torch.no_grad():
            ein = self._to_ffn(s.recv)
        s.recv = None
        with torch.set_grad_enabled(graph):
            if graph:
                s.ein = ein.requires_grad_()
            fo = E.apply_grouped(params["experts"], ein, self.cfg)
        if graph:
            s.fo = _edge(fo)
        s.back, s.pending = C.start_all_to_all(self._from_ffn(fo),
                                               self.group)

    def combine(self, k, params, graph):
        s = self.stages[k]
        s.pending.wait()
        back, s.back = s.back, None
        probs = s.probs
        with torch.set_grad_enabled(graph):
            if graph:
                if self.anchor is None:
                    self.anchor = torch.zeros((), device=back.device,
                                              requires_grad=True)
                back = _Cut.apply(back, self.anchor)
                s.b = _edge(back)
                s.p = probs = probs.detach().requires_grad_()
            m = self.cfg.moe
            out = D.combine(back.reshape(m.num_experts, self.cap, -1),
                            s.dest, probs, self.ct)
            if m.num_shared_experts:
                out = out + E.apply_shared(params["shared"], s.t, self.cfg)
        if graph:
            s.out = _edge(out)
        return out.detach(), s.aux

    def forward(self, params, tokens, graph: bool) -> list:
        """[(out, aux)] a chunk, in the pipeline's order."""
        n = self.n
        outs = [None] * n
        self.dispatch(0, params, tokens, graph)
        for i in range(n):
            if i + 1 < n:
                self.dispatch(i + 1, params, tokens, graph)
            self.experts(i, params, graph, keep=True)
            if i:
                outs[i - 1] = self.combine(i - 1, params, graph)
        outs[n - 1] = self.combine(n - 1, params, graph)
        return outs

    # -- the backward pass's units -------------------------------------
    def _add(self, key, grads):
        for i, g in zip(self.idx.get(key, ()), grads):
            if g is not None:
                if self.acc[i] is None:
                    self.acc[i] = g
                else:
                    self.acc[i].add_(g)

    def _Rd(self, k):
        self.dispatch(k, self.params, self.tokens, graph=True)

    def _Rs(self, k):
        self.route(k, self.params, self.tokens, graph=True)
        s = self.stages[k]
        s.recv = self.stashes[k].fetch(self.tokens.device)
        s.pending = C.Pending()

    def _Rf(self, k):
        self.experts(k, self.params, graph=True)

    def _RcCb(self, k):
        self.combine(k, self.params, graph=True)
        self._Cb(k)

    def _Cb(self, k):
        s = self.stages[k]
        shared = self.leaves("shared")
        d = self.d_out[k * self.ct:(k + 1) * self.ct]
        g = _grads([s.out], [s.b, s.p, s.t] + shared, [d])
        s.out = s.b = s.p = None
        s.d_probs, s.d_shared = g[1], g[2]
        self._add("shared", g[3:])
        s.back, s.pending = C.start_all_to_all(g[0], self.group)

    def _Fw(self, k):
        s = self.stages[k]
        s.pending.wait()
        s.d_fo = self._to_ffn(s.back)
        s.back = None

    def _Fb(self, k):
        s = self.stages[k]
        g = _grads([s.fo], [s.ein] + self.leaves("experts"), [s.d_fo])
        s.fo = s.ein = s.d_fo = None
        self._add("experts", g[1:])
        d_recv = self._from_ffn(g[0]).reshape(self.cfg.moe.num_experts,
                                              self.cap, -1)
        del g
        s.back, s.pending = C.start_all_to_all(d_recv, self.group)

    def _Db(self, k):
        s = self.stages[k]
        s.pending.wait()
        d_t = undispatch(s.back, s.dest, self.ct)
        s.back = None
        g = _grads([s.probs, s.aux["aux_loss"], s.aux["z_loss"]],
                   [s.t] + self.leaves("router"),
                   [s.d_probs, self.d_aux, self.d_z])
        self._add("router", g[1:])
        for part in (g[0], s.d_shared):
            if part is not None:
                d_t = d_t + part
        self.d_tokens[k] = d_t
        self.stages[k] = _Stage()

    def leaves(self, key) -> list:
        return [self.ws[i] for i in self.idx.get(key, ())]

    def backward(self, d_out, d_aux, d_z, ws, tokens):
        """The chunks' gradients: (d tokens, [d leaf] in ``leaves``
        order) of the layer's outputs' cotangents."""
        self.d_out, self.d_aux, self.d_z = d_out, d_aux, d_z
        self.ws, self.tokens = ws, tokens
        self.params = unflatten(self.template, ws)
        self.acc = [None] * len(ws)
        self.d_tokens = [None] * self.n
        with torch.enable_grad():
            for name, k in backward_order(self.n, self.strategy):
                getattr(self, "_" + name)(k)
        d_tokens = torch.cat(self.d_tokens) if tokens.requires_grad else None
        self.d_tokens = None
        return d_tokens, self.acc


class _Overlapped(torch.autograd.Function):
    """One MoE layer's chunks under the overlapped schedule as one node
    of the outer graph: forward ``_Overlap.forward`` (under NONE with
    its stage graphs, under S1-S4 without any), backward
    ``_Overlap.backward``. Returns (out, aux_loss, z_loss), the aux
    losses averaged over the chunks."""

    @staticmethod
    def forward(ctx, layer, tokens, *flat):
        ctx.layer = layer
        graph = layer.strategy == Strategy.NONE
        ws = [f.detach().requires_grad_(f.requires_grad and graph)
              for f in flat]
        x = tokens.detach().requires_grad_(tokens.requires_grad and graph)
        outs = layer.forward(unflatten(layer.template, ws), x, graph)
        if graph:
            layer.ws, layer.x = ws, x
        else:
            ctx.save_for_backward(tokens, *flat)
        n = layer.n
        out = torch.cat([o for o, _ in outs]) if n > 1 else outs[0][0]
        aux = [sum(a[k] for _, a in outs) / float(n)
               for k in ("aux_loss", "z_loss")]
        return (out, *aux)

    @staticmethod
    def backward(ctx, d_out, d_aux, d_z):
        layer = ctx.layer
        n = layer.n
        if layer.strategy == Strategy.NONE:
            ws, tokens = layer.ws, layer.x
        else:
            tokens, *flat = ctx.saved_tensors
            tokens = tokens.detach().requires_grad_(ctx.needs_input_grad[1])
            ws = [f.detach().requires_grad_(need)
                  for f, need in zip(flat, ctx.needs_input_grad[2:])]
        d_tokens, d_ws = layer.backward(d_out, d_aux / float(n),
                                        d_z / float(n), ws, tokens)
        ctx.layer = None
        return (None, d_tokens, *d_ws)


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


def _pipeline(params, tokens, n: int, *, cfg: ArchConfig, cap: int,
              ep: int, group, mode: str):
    """The local tokens in ``n`` chunks -> (out, aux averaged over the
    chunks) under the config's strategy (``core.strategies``). The
    serial schedule (one device, or ``pipeline_unroll=False``) runs the
    chunks one after another, each under ``wrap_chunk``'s checkpoint.
    The overlapped one runs the layer as ``_Overlapped`` where autograd
    needs a backward pass, else ``_Overlap.forward`` alone."""
    strategy = strategy_of(cfg) if mode == "train" else Strategy.NONE
    ct = tokens.shape[0] // n
    if group is not None and cfg.moe.pipeline_unroll:
        flat = leaves(params)
        grad = torch.is_grad_enabled() and (
            tokens.requires_grad or any(f.requires_grad for f in flat))
        layer = _Overlap(params, n, ct, cfg=cfg, cap=cap, ep=ep,
                         group=group,
                         strategy=strategy if grad else Strategy.NONE)
        if grad:
            out, aux_loss, z_loss = _Overlapped.apply(layer, tokens, *flat)
            return out, {"aux_loss": aux_loss, "z_loss": z_loss}
        outs = layer.forward(params, tokens, graph=False)
    else:
        fn = wrap_chunk(lambda p, c, stash=None: _chunk_fn(
            p, c, stash, cfg=cfg, cap=cap, ep=ep, group=group), strategy)
        outs = [fn(params, tokens[i * ct:(i + 1) * ct]) for i in range(n)]
    out = torch.cat([o for o, _ in outs], dim=0) if n > 1 else outs[0][0]
    aux = {k: sum(a[k] for _, a in outs) / float(n) for k in outs[0][1]}
    return out, aux


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
    cap = capacity_for(t_local // n, m.top_k, m.capacity_factor,
                       m.num_experts)
    return _pipeline(params, tokens, n, cfg=cfg, cap=cap, ep=ep,
                     group=dist.ep_group if ep > 1 else None, mode=mode)
