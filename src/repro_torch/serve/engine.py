"""Continuous-batching serving engine with preemptive scheduling, as
``repro.serve.engine``.

One :class:`Engine` owns the model params (a compute-dtype copy made
once at load), a :class:`~repro_torch.serve.paged_kv.PagedKVCache` and a
:class:`~repro_torch.serve.scheduler.Scheduler`. Each ``step()`` runs
either one chunked-prefill step for the head-of-line prefilling request
(padded to a power-of-two bucket) or one decode step over the whole slot
batch. Inactive decode slots are fed token 0 with their KV writes
masked into the sink page; they still route through the MoE, as in the
JAX engine, so the greedy tokens match it.

Decode step (``EngineOptions.decode_graph``, on by default): on the card
the step is captured once into a CUDA graph over inputs at fixed device
addresses and replayed every step (``serve.decode_step``), the port's
counterpart of the JAX engine's decode step jitted once; a failed
capture or replay raises. On the CPU, or with ``decode_graph=False``,
the same step runs eagerly over the same buffers. ``warmup()`` builds
the decode step and every reachable prefill bucket's step up front, as
the JAX engine's does.

Decode attention (``EngineOptions.attn_kernel``): ``"kernel"`` runs the
hand-written CUDA paged-decode kernel, ``"gather"`` the gather baseline,
and ``"auto"`` picks ``"kernel"`` on CUDA and ``"gather"`` on the CPU
(where the JAX engine picks its Pallas kernel on a TPU).

Overload (``EngineOptions.preempt``): with ``"auto"`` (the default, as
in the JAX engine), ``"recompute"`` or ``"offload"``, admission reserves
a request's prompt only and slots grow page by page; when the pool runs
dry the engine preempts the lowest-priority, then youngest, running
request. ``"auto"`` chooses per victim between recompute (drop the
pages, re-prefill at resume) and offload (the pages over the host link
and back) by ``core.memory_model.PreemptionCost``, where offload is
allowed (``allow_offload``; by default when the hardware spec has host
offload and a CUDA device gives pinned memory); ``"never"`` reserves
each request's whole budget at admission.

Prefill ``(n, strategy)`` per bucket (``EngineOptions.adaptive``, on
by default as in the JAX engine): each bucket's config is resolved once
by ``serve.adaptive.PrefillBucketAdaptive`` — Eq. 10 for the strategy
(inert at serving time), Algorithm 1 for ``n`` — measuring candidates by
wall clock on the card (``_wallclock_measure``: the candidate chunk runs
on the live pools with every KV write sent to the sink page) or with the
pipeline simulator on the CPU (``measure="auto"``). ``adaptive=False``
keeps the config's ``num_partitions``. Prefill runs eagerly: an LRU of
``cache_size`` prefill step functions keyed by (bucket, n, strategy)
stands where the JAX engine keeps its compiled steps.

Cross-request prefix cache (``EngineOptions.prefix_cache="on"``; off
by default): a refcounted page trie with copy-on-write
(``serve.paged_kv``). Admission binds a prompt's longest published
prefix and prefills the tail only; the end of prefill, retirement and
cancellation publish a slot's written full pages. Before a step writes,
``_ensure`` makes the written pages private (a device copy on the
current stream, queued before the step, eager or replayed), preempting
while the pool is dry. ``"off"`` gives the allocator's earlier page
tables exactly.

``cancel(req)`` ends a request from any live stage (queued, prefill,
decode, preempted), releases its slot, pages or host pages, and calls
its ``on_done`` hook; ``submit`` takes ``on_token`` / ``on_done``.
Cancelled requests are kept apart from ``done``.

Telemetry (``EngineOptions.obs``, a ``repro_torch.obs.Recorder``;
``None`` = a metrics-only registry and the no-op tracer): the JAX
engine's metric families and span taxonomy. The registry is always
real: ``stats()`` reads the queue, slot and free-unit gauges back from
it, and the ``/metrics`` exporter refreshes them through
``_refresh_gauges``, which reads host-side counts only (no CUDA call, so
a scrape never syncs the card mid-step nor breaks a capture). Spans and
counters are host events: telemetry on or off adds no kernel, CUDA event
or synchronize, and the captured step records the same launches. Two
families keep the JAX names for the port's counterparts of a trace and
a compile: ``repro_jit_traces_total{body="decode"}`` counts decode-graph
captures (``DecodeStep.captures``: 0 on the CPU, 1 on the card) and
``{body="prefill"}`` with ``repro_prefill_compiles_total`` the prefill
step functions built (``prefill_builds``); a ``jit.trace`` instant marks
each.

Over ranks (``EngineOptions.devices = N > 1``): the port's counterpart
of the JAX engine's ``(data=dp, model=ep)`` mesh is one ``Engine`` a
rank of a started ``torch.distributed`` group of ``N`` ranks
(``distributed.make_serving_context``: ``(dp, ep) = ep_split(N, E)``),
all in lockstep (SPMD):

* host state is the same on every rank: the allocator, the tries, the
  scheduler and the requests are whole on every rank, and every rank
  makes the same decisions in the same order. So every rank makes the
  same ``submit`` calls; ``serve.trace.replay`` decides arrivals on rank
  0. What a clock or a socket decides is decided once: a ``cancel`` is
  taken from rank 0 and applied on every rank at the start of the next
  step (``_agree``), and a wall-clock candidate's time is the world's
  maximum (``serve.adaptive``);
* device state is the rank's own: the expert weights are its EP shard
  (``convert.shard_tree``, no ZeRO-3 in serving) and, under
  ``kv_sharding="dp"``, its pools hold only its dp shard's pages
  (``serve.paged_kv``);
* a prefill chunk runs on every rank (the MoE splits its sequence over
  the EP group); only the owning shard's ranks write its KV. A decode
  step runs every slot on every rank over replicated pools, and only
  its shard's slots over dp-sharded ones; the MoE runs the replicated
  decode over the EP group;
* every scheduler sees the same tokens by construction: the sampled
  tokens go through one int64 all-gather, and each slot's token is taken
  from its shard's first rank (rank 0 over replicated pools).

The decode step runs eagerly over ranks (``decode_graph=True`` raises:
ROADMAP.md Queue 1 item 3d). ``stats()`` carries the JAX engine's mesh
keys (``devices``, ``ep_size``, ``dp_size``, ``kv_sharding``,
``kv_shards``, ``per_device_cache_bytes``,
``per_device_peak_kv_used_bytes``).

Threads: grad mode and the current CUDA stream are per thread in
PyTorch. ``step()`` and ``warmup()`` run under ``torch.no_grad()`` and,
on the card, on the stream current when the engine was built, so a
thread other than the one that built it (the ingress's engine thread)
launches on the stream the decode step was captured against and the
router's per-stream state was set up on. Only one thread may drive an
engine.

An option whose feature is not ported yet raises
``NotImplementedError`` naming the ROADMAP.md item that brings it; none
is accepted and then ignored.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import shard_tree
from repro_torch.core.memory_model import PreemptionCost
from repro_torch.core.strategies import host_offload_supported
from repro_torch.core.types import GPU_H100, HardwareSpec, Strategy
from repro_torch.device import dtype_of, resolve_device
from repro_torch.distributed.collectives import gather_dim
from repro_torch.distributed.context import make_serving_context
from repro_torch.models import lm
from repro_torch.models.api import check_servable
from repro_torch.models.layers.attention import ATTN_KERNELS as _KERNELS
from repro_torch.models.module import leaves
from repro_torch.obs import PID_ENGINE, PID_REQUESTS, Recorder, quantile
from repro_torch.serve.adaptive import PrefillBucketAdaptive, force_adaptive
from repro_torch.serve.decode_step import DecodeStep
from repro_torch.serve.paged_kv import PagedKVCache
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.sampling import SamplingParams, sample_tokens
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.state_cache import KV_SHARDINGS

log = logging.getLogger("repro_torch.serve")

__all__ = ["Engine", "EngineOptions", "quantile"]

PREEMPT_POLICIES = ("auto", "recompute", "offload", "never")
PREFIX_CACHE_MODES = ("on", "off")
ATTN_KERNELS = ("auto",) + _KERNELS


@dataclasses.dataclass
class EngineOptions:
    page_size: int = 16
    max_slots: int = 8                 # continuous-batch width (static)
    max_seq_len: int = 512             # per-request prompt + gen budget
    num_pages: int = 0                 # 0 = auto (worst case + sink page)
    chunk: int = 64                    # prefill chunk (tokens per step)
    min_bucket: int = 8
    hw: HardwareSpec = GPU_H100        # the resolver's device model
    devices: int = 0                   # 0/1 = one device; N > 1 = the
                                       # N ranks of the started group
    kv_sharding: str = "replicated"    # "replicated" | "dp": the pools
                                       # over the ranks' data axis
    ep_size: int = 1                   # resolver hints; the mesh's
    dp: int = 1                        # when devices > 1
    cache_size: int = 16               # LRU bound on prefill step fns
    adaptive: bool = True              # resolve (n, strategy) per bucket
    measure: str = "auto"              # auto | wallclock | simulate
    measure_steps: int = 2             # wallclock reps per candidate
    measure_fn: Optional[Callable] = None
    preempt: str = "auto"              # auto | recompute | offload | never
    allow_offload: Optional[bool] = None   # None = hw and pinned memory
    preempt_mfu: float = 0.5           # assumed MFU of a re-prefill (cost)
    attn_kernel: str = "auto"          # auto | kernel | gather
    decode_graph: bool = True          # CUDA: capture the decode step
    prefix_cache: str = "off"          # on | off: cross-request reuse
    storm_every: int = 0               # N > 0: preempt a victim every N
                                       # steps (preemption-storm tests)
    device: Optional[str] = None       # None = cuda (raises without CUDA)
    obs: Optional[Recorder] = None     # telemetry: None = metrics-only
                                       # registry + no-op tracer; pass
                                       # Recorder(tracer=Tracer()) to
                                       # record Perfetto spans

    @property
    def max_pages_per_seq(self) -> int:
        return -(-self.max_seq_len // self.page_size)

    def check(self) -> None:
        if self.preempt not in PREEMPT_POLICIES:
            raise ValueError(f"preempt must be one of {PREEMPT_POLICIES}")
        if self.attn_kernel not in ATTN_KERNELS:
            raise ValueError(f"attn_kernel must be one of {ATTN_KERNELS}")
        if self.measure not in ("auto", "wallclock", "simulate"):
            raise ValueError("measure must be auto, wallclock or simulate")
        if self.prefix_cache not in PREFIX_CACHE_MODES:
            raise ValueError(
                f"prefix_cache must be one of {PREFIX_CACHE_MODES}")
        if self.kv_sharding not in KV_SHARDINGS:
            raise ValueError(f"kv_sharding must be one of {KV_SHARDINGS}")


class Engine:
    def __init__(self, cfg: ArchConfig, params=None, *,
                 options: Optional[EngineOptions] = None, seed: int = 0):
        # as the JAX engine: the servability check comes first
        self.cache_kind = check_servable(cfg)
        self.opts = opts = options or EngineOptions()
        opts.check()
        self.device = resolve_device(opts.device)
        # the registry is always real (stats() reads it; /metrics and
        # stats() agree by construction); only the tracer is optional
        self.obs = opts.obs if opts.obs is not None else Recorder()
        # the stream every step launches on, whichever thread drives it
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self.attn_kernel = opts.attn_kernel
        if self.attn_kernel == "auto":
            self.attn_kernel = ("kernel" if self.device.type == "cuda"
                                else "gather")
        if opts.adaptive:
            cfg = force_adaptive(cfg)
        self.cfg = cfg
        # the ranks (devices > 1): expert weights sharded over EP, the
        # pools' layout by kv_sharding, the rest whole on every rank
        self.dist = make_serving_context(
            opts.devices, num_experts=cfg.moe.num_experts if cfg.moe else 0,
            device=self.device)
        if opts.kv_sharding == "dp" and self.dist is None:
            raise ValueError(
                "kv_sharding='dp' shards the KV pools over the ranks' data "
                "axis: a one-device engine has no ranks to shard over (set "
                "devices > 1 over a started group, or use 'replicated')")
        if params is None:       # never the fp32 tree beside its copy
            params = lm.init_compute(cfg, seed, device=self.device)
        elif any(t.device != self.device for t in leaves(params)):
            raise ValueError(f"params must lie on the engine's device "
                             f"{self.device}")
        else:
            params = lm.compute_params(params, cfg)
        if self.dist is not None and self.dist.ep_size > 1:
            params = shard_tree(params, cfg, self.dist, mode="decode")
        self.params = params
        del params
        self.kv = PagedKVCache(
            cfg, num_pages=opts.num_pages, page_size=opts.page_size,
            max_slots=opts.max_slots,
            max_pages_per_seq=opts.max_pages_per_seq,
            dtype=dtype_of(cfg.compute_dtype), device=self.device,
            dist=self.dist, kv_sharding=opts.kv_sharding,
            prefix_cache=(opts.prefix_cache == "on"))
        if opts.kv_sharding == "dp" and self.kv.n_shards == 1:
            log.warning(
                "kv_sharding='dp' but the ranks' data axis has extent 1 "
                "(ep_split gave every rank to the experts): the pools are "
                "the replicated layout, with none of dp's KV capacity")
        self._init_metrics()
        self.scheduler = Scheduler(self.kv, chunk=opts.chunk,
                                   full_reserve=(opts.preempt == "never"),
                                   obs=self.obs)
        measure_fn = opts.measure_fn
        mode = opts.measure
        if mode == "auto":
            mode = "wallclock" if self.device.type == "cuda" else "simulate"
        self.measure = "custom" if measure_fn is not None else mode
        if self.measure == "wallclock":
            # through a weak reference: the resolver must not keep the
            # engine, its params and its pools alive in a reference cycle
            engine = weakref.ref(self)

            def measure_fn(b: int, n: int, strategy: Strategy) -> float:
                return engine()._wallclock_measure(b, n, strategy)
        ep_size = self.dist.ep_size if self.dist else opts.ep_size
        self.adaptive = PrefillBucketAdaptive(
            cfg, hw=opts.hw, ep_size=ep_size,
            dp=self.dist.dp_size if self.dist else opts.dp,
            min_bucket=min(opts.min_bucket, opts.chunk),
            max_bucket=opts.chunk, measure_fn=measure_fn,
            shards=ep_size, obs=self.obs, dist=self.dist)
        self._prefill_fns: Dict[Tuple, Callable] = {}
        self.prefill_builds = 0
        jit, tracer = self._m_jit, self.obs.tracer     # not self: no cycle

        def on_capture() -> None:
            jit.labels(body="decode").inc()
            tracer.instant("jit.trace", args={"body": "decode"})
        self._decode = DecodeStep(self.params, self.kv, cfg,
                                  attn_kernel=self.attn_kernel,
                                  graph=opts.decode_graph, dist=self.dist,
                                  on_capture=on_capture)
        # forward FLOPs a token of the active parameters, for the
        # offload-vs-recompute preemption cost
        self._flops_per_token = 2.0 * lm.count_params(cfg, active_only=True)
        self.offload_allowed = opts.allow_offload
        if self.offload_allowed is None:
            self.offload_allowed = (opts.hw.has_host_offload
                                    and host_offload_supported())
        self._next_rid = 0
        self.step_count = 0
        self._storm_tick = 0
        self.preempts: Dict[str, int] = {"recompute": 0, "offload": 0}
        # the most requests running at once before the first preemption
        self.peak_running_preempt_free = 0
        # request ids whose cancel was asked for over ranks, applied at
        # the next step (_agree)
        self._cancels: List[int] = []
        # tokens this rank sampled otherwise than the agreed ones
        self.token_disagreements = 0
        # one entry per preemption: the victim, the mode applied and,
        # under "auto" with offload allowed, the two costs compared
        self.preempt_log: List[Dict[str, Any]] = []
        self.decode_tokens = 0
        self.step_s: Dict[str, List[float]] = {"prefill": [], "decode": []}
        self.done: List[Request] = []
        # cancelled requests are kept apart from ``done``: their output is
        # cut short (often empty), so they would skew the latency figures
        self.cancelled: List[Request] = []

    # -- telemetry -------------------------------------------------------
    def _init_metrics(self) -> None:
        """Register this engine's metric families, the JAX engine's
        (idempotent: a registry shared by several engines merges
        families)."""
        reg = self.obs.registry
        self._m_steps = reg.counter(
            "repro_engine_steps_total", "engine host steps", ["kind"])
        self._m_done = reg.counter(
            "repro_requests_done_total", "requests retired")
        self._m_tokens = reg.counter(
            "repro_tokens_generated_total", "tokens emitted to requests")
        self._m_prefill_tokens = reg.counter(
            "repro_prefill_tokens_total", "prompt tokens prefilled")
        self._m_preempts = reg.counter(
            "repro_preempts_total", "preemptions by mode", ["mode"])
        self._m_cancels = reg.counter(
            "repro_cancels_total",
            "cancelled requests by lifecycle stage", ["stage"])
        self._m_jit = reg.counter(
            "repro_jit_traces_total",
            "step programs built: decode-graph captures (body=decode), "
            "prefill step functions (body=prefill)", ["body"])
        self._m_compiles = reg.counter(
            "repro_prefill_compiles_total", "prefill step functions built")
        self._m_step_s = reg.histogram(
            "repro_step_seconds", "host wall time per engine step",
            ["kind"])
        self._m_lat = reg.histogram(
            "repro_latency_seconds", "request latency (submit to done)")
        self._m_ttft = reg.histogram(
            "repro_ttft_seconds", "time to first token")
        self._m_itl = reg.histogram(
            "repro_itl_seconds", "inter-token latency")
        # point-in-time gauges, filled by _refresh_gauges on demand
        reg.gauge("repro_waiting_requests", "admission queue depth")
        reg.gauge("repro_resuming_requests",
                  "preempted requests awaiting resume")
        reg.gauge("repro_running_slots", "occupied decode slots")
        self.obs.tracer.thread_name(PID_ENGINE, 1, "steps")
        self.kv.record_metrics(reg)

    def _refresh_gauges(self) -> None:
        """Pull point-in-time gauges into the registry: called by
        ``stats()`` and by the /metrics exporter's refresh hook (on its
        own thread), never per step. Host-side counts only: no tensor is
        read and no CUDA call made."""
        reg = self.obs.registry
        reg.gauge("repro_waiting_requests").set(
            len(self.scheduler.waiting))
        reg.gauge("repro_resuming_requests").set(
            len(self.scheduler.resuming))
        reg.gauge("repro_running_slots").set(
            len(self.scheduler.running))
        self.kv.record_metrics(reg)

    @contextlib.contextmanager
    def _thread_state(self):
        """The per-thread torch state every step runs under: no autograd
        and, on the card, the engine's stream (see the module
        docstring)."""
        with torch.no_grad():
            if self._stream is None:
                yield
            else:
                with torch.cuda.stream(self._stream):
                    yield

    # -- request API -----------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int = 32,
               eos_id: Optional[int] = None, stop=(),
               sampling: Optional[SamplingParams] = None,
               priority: int = 0, on_token=None, on_done=None,
               arrival_s: Optional[float] = None) -> Request:
        req = Request(rid=self._next_rid, prompt=np.asarray(prompt),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      stop=stop, sampling=sampling or SamplingParams(),
                      priority=priority, on_token=on_token,
                      on_done=on_done,
                      arrival_s=(time.perf_counter() if arrival_s is None
                                 else arrival_s))
        self._next_rid += 1
        if not self.kv.admissible(req.total_budget):
            raise ValueError(
                f"request {req.rid}: budget {req.total_budget} tokens "
                f"exceeds engine capacity "
                f"({self.kv.max_slot_tokens} tokens per slot)")
        self.scheduler.submit(req)
        return req

    def cancel(self, req: Request) -> bool:
        """Cancel ``req`` from whatever stage it is in, releasing its
        slot, pages or host pages, and call its ``on_done``. True if the
        request was live (now CANCELLED); False if it had already ended,
        a race every disconnect meets, so not an error. Call between
        steps, on the thread that drives the engine: a cancelled slot's
        page-table row is back at the sink before the next decode step
        copies the table in. Over ranks the cancel is decided on rank 0
        (a call on another rank only reports liveness) and takes effect
        on every rank at the start of the next step."""
        if req.state in (RequestState.DONE, RequestState.CANCELLED):
            return False
        if self.dist is not None:
            if self.dist.rank == 0 and req.rid not in self._cancels:
                self._cancels.append(req.rid)
            return True
        self._cancel_now(req)
        return True

    def _cancel_now(self, req: Request) -> None:
        stage = self.scheduler.cancel(req)
        req.state = RequestState.CANCELLED
        req.finish_reason = "cancelled"
        req.finish_s = time.perf_counter()
        tracer = self.obs.tracer
        if req.decode_span_open:
            tracer.end("DECODE", pid=PID_REQUESTS, tid=req.rid)
            req.decode_span_open = False
        tracer.instant("CANCEL", pid=PID_REQUESTS, tid=req.rid,
                       args={"stage": stage, "tokens": len(req.output)})
        self._m_cancels.labels(stage=stage).inc()
        self.cancelled.append(req)
        if req.on_done is not None:
            req.on_done(req)

    def _agree(self) -> None:
        """Over ranks, at the start of a step: rank 0's pending cancels
        (by request id) and its request count, broadcast; every rank
        applies the cancels, and a rank whose submissions differ from
        rank 0's raises instead of issuing other collectives."""
        sch = self.scheduler
        live = {r.rid: r for r in (list(sch.waiting) + sch.resuming
                                   + list(sch.running.values()))}
        payload = [(self._next_rid,
                    [rid for rid in self._cancels if rid in live])]
        torch.distributed.broadcast_object_list(payload, src=0)
        next_rid, rids = payload[0]
        self._cancels = []
        if next_rid != self._next_rid:
            raise RuntimeError(
                f"rank {self.dist.rank} holds {self._next_rid} submissions, "
                f"rank 0 {next_rid}: every rank must make the same submit "
                f"calls")
        for rid in rids:
            self._cancel_now(live[rid])

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def warmup(self) -> int:
        """Build the decode step and every reachable prefill bucket's
        step up front, as the JAX engine's ``warmup``, so the first
        requests meet no capture and no bucket resolution. The decode
        step runs once with every slot inactive over sink page-table
        rows (on the card: the run before the capture, then the capture);
        for each bucket that a chunk of 1 to ``chunk`` tokens pads to,
        the bucket's ``(n, strategy)`` is resolved and its prefill step
        built and run once over a sink row with no valid token. Every KV
        write lands in the sink page: pools (bar the sink page), lens and
        the page table are left as they were. Returns the programs built,
        1 + the prefill builds, as the JAX engine counts them."""
        kv = self.kv
        before = self.prefill_builds
        with self._thread_state():
            self._decode(np.zeros((kv.max_slots, 1), np.int64),
                         np.zeros((kv.max_slots,), bool), sink_only=True)
            buckets, c = set(), 1
            while c < self.scheduler.chunk:
                buckets.add(self.adaptive.bucket_of(c))
                c *= 2
            buckets.add(self.adaptive.bucket_of(self.scheduler.chunk))
            for b in sorted(buckets):
                fn = self._prefill_fn(b, self.adaptive.cfg_for(b))
                fn(kv.pools, kv.sink_page_table(),
                   torch.zeros((1,), dtype=torch.int32, device=self.device),
                   torch.zeros((1, b), dtype=torch.int64,
                               device=self.device), 0, kv.sink_row(0))
        return 1 + self.prefill_builds - before

    # -- prefill step functions ------------------------------------------
    def _prefill_fn(self, bucket: int, rcfg: ArchConfig) -> Callable:
        """The prefill step of one (bucket, n, strategy), from an LRU of
        ``cache_size`` entries (dicts iterate in insertion order)."""
        key = (bucket, rcfg.moe.num_partitions,
               rcfg.moe.memory_reuse_strategy) if rcfg.moe else (bucket,)
        fn = self._prefill_fns.pop(key, None)
        if fn is None:
            params, dist = self.params, self.dist     # not self: no cycle

            def fn(pools, page_table, pos0, tokens, valid_len, sink):
                return lm.prefill_chunk_paged(
                    params, pools, page_table, pos0, tokens, valid_len,
                    rcfg, write_sink=sink, dist=dist)
            self.prefill_builds += 1
            self._m_compiles.inc()
            self._m_jit.labels(body="prefill").inc()
            self.obs.tracer.instant("jit.trace", args={"body": "prefill"})
        self._prefill_fns[key] = fn
        while len(self._prefill_fns) > max(1, self.opts.cache_size):
            self._prefill_fns.pop(next(iter(self._prefill_fns)))
        return fn

    def _wallclock_measure(self, b: int, n: int,
                           strategy: Strategy) -> float:
        """Algorithm 1's measure function for prefill buckets: the
        seconds of a ``b``-token prefill chunk under candidate (n,
        strategy), run on the live pools through a page-table row that
        maps every position to the sink page (and with the sink as the
        masked-write target), so every KV write lands in the sink: no
        other page, no length and no page-table row changes. One warm-up
        call, then ``measure_steps`` timed calls: CUDA events on the
        current stream on the card, the host clock on the CPU. Over
        ranks the resolver takes the world's maximum of these."""
        rcfg = dataclasses.replace(
            self.cfg, moe=dataclasses.replace(
                self.cfg.moe, num_partitions=n,
                memory_reuse_strategy=strategy.value))
        fn = self._prefill_fn(b, rcfg)
        kv = self.kv
        args = (kv.sink_page_table(),
                torch.zeros((1,), dtype=torch.int32, device=self.device),
                torch.zeros((1, b), dtype=torch.int64, device=self.device),
                b, kv.sink_row(0))
        reps = max(1, self.opts.measure_steps)
        with torch.no_grad():
            fn(kv.pools, *args)                    # warm-up
            if self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    fn(kv.pools, *args)
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / 1e3 / reps
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(kv.pools, *args)
            return (time.perf_counter() - t0) / reps

    # -- preemption ------------------------------------------------------
    def _pick_victim(self, shard: Optional[int] = None
                     ) -> Optional[Request]:
        """Lowest priority, then youngest, among the running requests (on
        ``shard`` when given: a dry shard gains only from its own
        victims) that hold cache bytes exclusively (all of them when none
        does: with the prefix cache every page may be shared, and a
        victim's dropped references still make trie pages evictable)."""
        running = [r for r in self.scheduler.running.values()
                   if shard is None or self.kv.shard_of_slot(r.slot) == shard]
        cands = [r for r in running if self.kv.held_bytes(r.slot) > 0]
        cands = cands or running
        if not cands:
            return None
        return min(cands, key=lambda r: (r.priority, -r.rid))

    def _preempt_cost(self, req: Request) -> Optional[PreemptionCost]:
        """What preempting ``req`` costs by recompute and by offload, under
        ``"auto"`` where offload is allowed; None otherwise."""
        if self.opts.preempt != "auto" or not self.offload_allowed:
            return None
        hw = self.opts.hw
        return PreemptionCost(
            tokens_cached=int(self.kv.lens[req.slot]),
            bytes_held=self.kv.held_bytes(req.slot),
            flops_per_token=self._flops_per_token, flops=hw.flops,
            host_bw=hw.host_bw, mfu=self.opts.preempt_mfu,
            eta=hw.interference.eta_comp, link_shards=self.kv.n_shards)

    def _preempt_mode(self, cost: Optional[PreemptionCost]) -> str:
        """A fixed policy's mode, else the cost's choice; recompute where
        offload is not allowed."""
        if self.opts.preempt in ("recompute", "offload"):
            return self.opts.preempt
        return "recompute" if cost is None else cost.choice

    def _do_preempt(self, victim: Request) -> None:
        entry = dict(rid=victim.rid,
                     tokens_cached=int(self.kv.lens[victim.slot]),
                     bytes_held=self.kv.held_bytes(victim.slot))
        cost = self._preempt_cost(victim)
        if cost is not None:
            entry.update(recompute_s=cost.recompute_s,
                         offload_s=cost.offload_s, choice=cost.choice)
        mode = self.scheduler.preempt(victim, self._preempt_mode(cost))
        self.preempts[mode] += 1
        self._m_preempts.labels(mode=mode).inc()
        self.preempt_log.append(dict(entry, mode=mode))

    def _ensure(self, slot: int, tokens: int) -> bool:
        """Grow ``slot`` until it can hold ``tokens``, then make the pages
        it writes private (copy-on-write, a no-op with the prefix cache
        off), preempting victims on the slot's shard while it is dry.
        False if the slot's own request was chosen as the victim (it
        skips this step)."""
        while self.kv.slot_capacity(slot) < tokens:
            if self.kv.grow_slot(slot):
                continue
            if not self._preempt_for(slot, "no free pages"):
                return False
        while not self.kv.ensure_private(slot, tokens):
            if not self._preempt_for(slot, "no copy-on-write page"):
                return False
        return True

    def _preempt_for(self, slot: int, why: str) -> bool:
        """Preempt one victim on ``slot``'s shard for its sake; False if
        the victim was ``slot``'s own request."""
        shard = self.kv.shard_of_slot(slot)
        victim = self._pick_victim(shard)
        if victim is None:
            raise RuntimeError(f"page pool wedged: KV shard {shard}: {why} "
                               f"and no victim")
        vslot = victim.slot
        self._do_preempt(victim)
        return vslot != slot

    # -- engine iteration ------------------------------------------------
    def step(self) -> Dict[str, Any]:
        """Admit, then run one step (a prefill chunk or a decode)."""
        t0 = time.perf_counter()
        with self.obs.tracer.span("engine.step",
                                  args={"step": self.step_count}) as sp, \
                self._thread_state():
            if self.dist is not None:
                self._agree()
            # storm injection (tests): preempt a victim every
            # storm_every steps, whatever the pool holds
            if (self.opts.storm_every and self.opts.preempt != "never"
                    and self.scheduler.running):
                self._storm_tick += 1
                if self._storm_tick >= self.opts.storm_every:
                    self._storm_tick = 0
                    victim = self._pick_victim()
                    if victim is not None:
                        self._do_preempt(victim)
            self.scheduler.admit()
            if not (self.preempts["recompute"] or self.preempts["offload"]):
                self.peak_running_preempt_free = max(
                    self.peak_running_preempt_free,
                    len(self.scheduler.running))
            action, req = self.scheduler.next_action()
            sp["kind"] = action
            info: Dict[str, Any] = {"kind": action}
            if action == "prefill":
                info.update(self._run_prefill(req))
            elif action == "decode":
                info.update(self._run_decode())
            elif self.scheduler.waiting or self.scheduler.resuming:
                raise RuntimeError("scheduler idle with waiting requests "
                                   "— admission wedged")
        dt = time.perf_counter() - t0
        if info.get("tokens"):          # a step that ran the model
            self.step_s[action].append(dt)
        self.step_count += 1
        self._m_steps.labels(kind=action).inc()
        self._m_step_s.labels(kind=action).observe(dt)
        return info

    def _run_prefill(self, req: Request) -> Dict[str, Any]:
        kv, slot = self.kv, req.slot
        c = min(self.scheduler.chunk, req.remaining_prefill)
        if not self._ensure(slot, int(kv.lens[slot]) + c):
            return {"tokens": 0, "rid": req.rid, "self_preempted": True}
        bucket = self.adaptive.bucket_of(c)
        fn = self._prefill_fn(bucket, self.adaptive.cfg_for(bucket))
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :c] = req.prefill_tokens[req.prefill_pos:
                                         req.prefill_pos + c]
        tracer = self.obs.tracer
        with tracer.span("prefill", args={"rid": req.rid}), \
                tracer.span("PREFILL", pid=PID_REQUESTS, tid=req.rid,
                            args={"chunk": c, "bucket": bucket,
                                  "pos": req.prefill_pos}):
            logits, _ = fn(                    # the pools, written in place
                kv.pools, kv.device_page_table(slot), kv.device_lens(slot),
                torch.from_numpy(toks).to(self.device), c,
                kv.sink_row(slot))
            tok = self._exchange(sample_tokens(
                logits, [req.sampling], [len(req.output)]), slot=slot)[0]
        req.prefill_pos += c
        kv.lens[slot] += c
        self._m_prefill_tokens.inc(c)
        self.scheduler.prefill_advanced(req)
        if req.remaining_prefill == 0:
            # publish the finished prompt's full pages for later requests
            # that share the prefix (a no-op with the prefix cache off)
            kv.cache_slot_prefix(slot, req.prefill_tokens)
            req.state = RequestState.DECODE
            tracer.begin("DECODE", pid=PID_REQUESTS, tid=req.rid)
            req.decode_span_open = True
            # a recompute re-prefill replays tokens already emitted: its
            # final-chunk sample is the pending decode input, not new
            if not req.output and req.emit(tok, time.perf_counter()):
                self._retire(req)
        return {"tokens": c, "bucket": bucket, "rid": req.rid}

    def _run_decode(self) -> Dict[str, Any]:
        kv = self.kv
        # every decoding slot writes one KV position this step — grow
        # first, preempting victims if the pool is dry (a victim may be
        # one of the decoding slots)
        for s in list(self.scheduler.decode_slots()):
            req = self.scheduler.running.get(s)
            if req is None or req.state != RequestState.DECODE:
                continue
            self._ensure(s, int(kv.lens[s]) + 1)
        slots = self.scheduler.decode_slots()
        if not slots:
            return {"tokens": 0}
        tokens = np.zeros((kv.max_slots, 1), np.int64)
        active = np.zeros((kv.max_slots,), bool)
        by_slot: List[Optional[SamplingParams]] = [None] * kv.max_slots
        positions = [0] * kv.max_slots
        for s in slots:
            req = self.scheduler.running[s]
            tokens[s, 0] = req.output[-1]
            active[s] = True
            by_slot[s] = req.sampling
            positions[s] = len(req.output)
        rows = kv.decode_rows
        with self.obs.tracer.span("decode", args={"slots": len(slots)}):
            logits = self._decode(tokens, active)
            toks = self._exchange(sample_tokens(
                logits, by_slot[rows.start:rows.stop],
                positions[rows.start:rows.stop]))
        now = time.perf_counter()
        for s in slots:
            req = self.scheduler.running[s]
            kv.lens[s] += 1                  # the input token's KV slot
            if req.emit(toks[s], now):
                self._retire(req)
        self.decode_tokens += len(slots)
        return {"tokens": len(slots)}

    def _exchange(self, toks: torch.Tensor,
                  slot: Optional[int] = None) -> List[int]:
        """This rank's sampled tokens (int64, on the device) -> the host
        list every scheduler reads. Over ranks, one all-gather over the
        world agrees on them: a prefill's token (``slot``) and each
        decode slot's come from its shard's first rank (rank 0 over
        replicated pools), so every rank sees the same tokens whatever
        its arithmetic; ``token_disagreements`` counts this rank's own
        samples of its shard's slots that differed."""
        if self.dist is None:
            return toks.tolist()
        parts = gather_dim(toks[None], None, 0).cpu()     # [world, n]
        kv, ep, mine = self.kv, self.dist.ep_size, parts[self.dist.rank]
        if kv.local_shard is None:
            agreed = ours = parts[0]
        elif slot is not None:
            shard = kv.shard_of_slot(slot)
            agreed = ours = parts[shard * ep]
            if shard != kv.local_shard:     # its KV is not on this rank
                mine = agreed
        else:
            agreed = torch.cat([parts[s * ep] for s in range(kv.n_shards)])
            rows = kv.decode_rows
            ours = agreed[rows.start:rows.stop]
        self.token_disagreements += int((ours != mine).sum())
        return agreed.tolist()

    def _retire(self, req: Request) -> None:
        # publish the written full pages (prompt and generated turn)
        # before the slot frees: the trie's reference keeps them for the
        # conversation's next turn
        self.kv.cache_slot_prefix(req.slot, req.prefill_tokens)
        tracer = self.obs.tracer
        if req.decode_span_open:
            tracer.end("DECODE", pid=PID_REQUESTS, tid=req.rid)
            req.decode_span_open = False
        tracer.instant("RETIRE", pid=PID_REQUESTS, tid=req.rid,
                       args={"reason": req.finish_reason})
        self.scheduler.finish(req)
        self.done.append(req)
        self._m_done.inc()
        self._m_tokens.inc(len(req.output))
        self._m_lat.observe(req.latency_s)
        self._m_ttft.observe(req.ttft_s)
        for g in req.itl_s:
            self._m_itl.observe(g)

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"no quiescence in {max_steps} steps")

    # -- reporting -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        lat = [r.latency_s for r in self.done]
        ttft = [r.ttft_s for r in self.done]
        itl = [g for r in self.done for g in r.itl_s]
        pre, dec = self.step_s["prefill"], self.step_s["decode"]
        self._refresh_gauges()
        reg = self.obs.registry
        prefill_tokens = int(self._m_prefill_tokens.value)
        return {
            "device": str(self.device),
            "attn_kernel": self.attn_kernel,
            "requests_done": len(self.done),
            "requests_cancelled": len(self.cancelled),
            "cancelled_by_stage": {
                dict(c.labels)["stage"]: int(c.value)
                for c in self._m_cancels.children()},
            "tokens_generated": sum(len(r.output) for r in self.done),
            "engine_steps": self.step_count,
            "prefill_steps": len(pre),
            "decode_steps": len(dec),
            "prefill_tokens": prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "prefill_s": sum(pre),
            "decode_s": sum(dec),
            "prefill_tok_per_s": prefill_tokens / max(sum(pre), 1e-12),
            "decode_tok_per_s": self.decode_tokens / max(sum(dec), 1e-12),
            "p50_decode_step_s": quantile(dec, 50),
            "p50_latency_s": quantile(lat, 50),
            "p99_latency_s": quantile(lat, 99),
            "p50_ttft_s": quantile(ttft, 50),
            "p99_ttft_s": quantile(ttft, 99),
            "p50_itl_s": quantile(itl, 50),
            "p99_itl_s": quantile(itl, 99),
            # live gauges, read back from the registry so /metrics and
            # stats() report the same values by construction
            "queue_waiting": int(reg.gauge("repro_waiting_requests").value),
            "queue_resuming": int(
                reg.gauge("repro_resuming_requests").value),
            "running_slots": int(reg.gauge("repro_running_slots").value),
            "free_units_by_shard": {
                dict(c.labels)["shard"]: int(c.value)
                for c in reg.get("repro_kv_free_units").children()},
            "devices": 1 if self.dist is None else self.dist.world_size,
            "ep_size": 1 if self.dist is None else self.dist.ep_size,
            "dp_size": 1 if self.dist is None else self.dist.dp_size,
            "kv_sharding": self.opts.kv_sharding,
            "kv_shards": self.kv.n_shards,
            "decode_graph": self._decode.use_graph,
            "token_disagreements": self.token_disagreements,
            "decode_captures": self._decode.captures,
            "decode_replays": self._decode.replays,
            "prefix_cache": self.opts.prefix_cache,
            "prefix_hits": self.kv.prefix_hits,
            "prefix_misses": self.kv.prefix_misses,
            "prefix_hit_tokens": self.kv.prefix_hit_tokens,
            "prefix_hit_rate": (
                self.kv.prefix_hits
                / max(1, self.kv.prefix_hits + self.kv.prefix_misses)),
            "prefix_cow_copies": self.kv.prefix_cow_copies,
            "prefix_cow_bytes": self.kv.prefix_cow_bytes,
            "prefix_evicted_pages": self.kv.prefix_evicted_pages,
            "prefix_cached_pages": self.kv.prefix_cached_pages,
            "prefix_shared_pages": self.kv.prefix_shared_pages,
            "preempt_recompute": self.preempts["recompute"],
            "preempt_offload": self.preempts["offload"],
            "resumes": self.scheduler.resume_count,
            "swap_out_bytes": self.kv.swap_out_bytes,
            "swap_in_bytes": self.kv.swap_in_bytes,
            "cache_bytes": self.kv.cache_bytes,
            "peak_kv_used_bytes": self.kv.peak_used_bytes,
            "per_device_cache_bytes": self.kv.per_device_cache_bytes,
            "per_device_peak_kv_used_bytes":
                self.kv.per_device_peak_used_bytes,
            "peak_running_preempt_free": self.peak_running_preempt_free,
            "measure": self.measure,
            "prefill_builds": self.prefill_builds,
            "resolutions": {str(b): list(r) for b, r in
                            self.adaptive.resolutions.items()},
        }
