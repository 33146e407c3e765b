"""Continuous-batching serving engine with recompute preemption — the
single-device part of ``repro.serve.engine``.

One :class:`Engine` owns the model params (a compute-dtype copy made
once at load), a :class:`~repro_torch.serve.paged_kv.PagedKVCache` and a
:class:`~repro_torch.serve.scheduler.Scheduler`. Each ``step()`` runs
either one chunked-prefill step for the head-of-line prefilling request
(padded to a power-of-two bucket) or one decode step over the whole slot
batch. Inactive decode slots are fed token 0 with their KV writes
masked into the sink page; they still route through the MoE, as in the
JAX engine, so the greedy tokens match it.

Decode attention (``EngineOptions.attn_kernel``): ``"kernel"`` runs the
hand-written CUDA paged-decode kernel, ``"gather"`` the gather baseline,
and ``"auto"`` picks ``"kernel"`` on CUDA and ``"gather"`` on the CPU
(where the JAX engine picks its Pallas kernel on a TPU).

Options of the JAX engine whose feature is not ported yet raise
``NotImplementedError`` naming the ROADMAP.md slice that brings it;
none is accepted and then ignored. PyTorch runs eagerly, so there is no
compile cache: each step calls the model functions directly.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import dtype_of, resolve_device
from repro_torch.models import lm
from repro_torch.models.layers.attention import ATTN_KERNELS as _KERNELS
from repro_torch.models.module import leaves
from repro_torch.serve.adaptive import bucket_of
from repro_torch.serve.paged_kv import PagedKVCache
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.sampling import SamplingParams, sample_tokens
from repro_torch.serve.scheduler import Scheduler

__all__ = ["Engine", "EngineOptions", "quantile"]

PREEMPT_POLICIES = ("recompute", "never")
ATTN_KERNELS = ("auto",) + _KERNELS


def quantile(xs: Sequence[float], p: float) -> float:
    """Nearest-rank p-th percentile (``p`` in [0, 100]); 0.0 when empty."""
    if not xs:
        return 0.0
    s = sorted(xs)
    rank = max(1, math.ceil(p / 100.0 * len(s)))
    return float(s[min(rank, len(s)) - 1])


@dataclasses.dataclass
class EngineOptions:
    page_size: int = 16
    max_slots: int = 8                 # continuous-batch width (static)
    max_seq_len: int = 512             # per-request prompt + gen budget
    num_pages: int = 0                 # 0 = auto (worst case + sink page)
    chunk: int = 64                    # prefill chunk (tokens per step)
    min_bucket: int = 8
    preempt: str = "recompute"         # recompute | never
    attn_kernel: str = "auto"          # auto | kernel | gather
    device: Optional[str] = None       # None = cuda (raises without CUDA)
    # not ported yet: each raises NotImplementedError when set
    adaptive: bool = False
    prefix_cache: str = "off"
    devices: int = 0

    @property
    def max_pages_per_seq(self) -> int:
        return -(-self.max_seq_len // self.page_size)

    def check(self) -> None:
        if self.preempt in ("auto", "offload"):
            raise NotImplementedError(
                f"preempt={self.preempt!r}: offload and auto preemption "
                f"come with ROADMAP.md's 'Offload and auto preemption' "
                f"slice")
        if self.preempt not in PREEMPT_POLICIES:
            raise ValueError(f"preempt must be one of {PREEMPT_POLICIES}")
        if self.attn_kernel not in ATTN_KERNELS:
            raise ValueError(f"attn_kernel must be one of {ATTN_KERNELS}")
        if self.adaptive:
            raise NotImplementedError(
                "adaptive (n, strategy) prefill resolution comes with "
                "ROADMAP.md's 'Adaptive prefill buckets' slice")
        if self.prefix_cache != "off":
            raise NotImplementedError(
                "the prefix cache comes with ROADMAP.md's 'Prefix cache "
                "and cancel' slice")
        if self.devices > 1:
            raise NotImplementedError(
                "multi-device serving comes with ROADMAP.md's 'Expert "
                "parallelism' slice")


class Engine:
    def __init__(self, cfg: ArchConfig, params=None, *,
                 options: Optional[EngineOptions] = None, seed: int = 0):
        self.opts = opts = options or EngineOptions()
        opts.check()
        self.device = resolve_device(opts.device)
        self.attn_kernel = opts.attn_kernel
        if self.attn_kernel == "auto":
            self.attn_kernel = ("kernel" if self.device.type == "cuda"
                                else "gather")
        self.cfg = cfg
        if params is None:       # never the fp32 tree beside its copy
            self.params = lm.init_compute(cfg, seed, device=self.device)
        elif any(t.device != self.device for t in leaves(params)):
            raise ValueError(f"params must lie on the engine's device "
                             f"{self.device}")
        else:
            self.params = lm.compute_params(params, cfg)
        del params
        self.kv = PagedKVCache(
            cfg, num_pages=opts.num_pages, page_size=opts.page_size,
            max_slots=opts.max_slots,
            max_pages_per_seq=opts.max_pages_per_seq,
            dtype=dtype_of(cfg.compute_dtype),
            device=self.device)
        self.scheduler = Scheduler(self.kv, chunk=opts.chunk,
                                   full_reserve=(opts.preempt == "never"))
        self.min_bucket = min(opts.min_bucket, opts.chunk)
        self._sinks = self.kv.device_sinks()
        self._next_rid = 0
        self.step_count = 0
        self.preempts = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.step_s: Dict[str, List[float]] = {"prefill": [], "decode": []}
        self.done: List[Request] = []

    # -- request API -----------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int = 32,
               eos_id: Optional[int] = None, stop=(),
               sampling: Optional[SamplingParams] = None,
               arrival_s: Optional[float] = None) -> Request:
        req = Request(rid=self._next_rid, prompt=np.asarray(prompt),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      stop=stop, sampling=sampling or SamplingParams(),
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

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    # -- preemption ------------------------------------------------------
    def _pick_victim(self) -> Optional[Request]:
        """The youngest running request that holds pages (the JAX
        engine's order when every request has the default priority)."""
        running = list(self.scheduler.running.values())
        cands = [r for r in running if self.kv.held_bytes(r.slot) > 0]
        cands = cands or running
        if not cands:
            return None
        return max(cands, key=lambda r: r.rid)

    def _ensure(self, slot: int, tokens: int) -> bool:
        """Grow ``slot`` until it can hold ``tokens``, preempting victims
        while the pool is dry. False if the slot's own request was
        chosen as the victim (it skips this step)."""
        while self.kv.slot_capacity(slot) < tokens:
            if self.kv.grow_slot(slot):
                continue
            victim = self._pick_victim()
            if victim is None:
                raise RuntimeError("page pool wedged: no free pages and "
                                   "no victim")
            vslot = victim.slot
            self.scheduler.preempt(victim)
            self.preempts += 1
            if vslot == slot:
                return False
        return True

    # -- engine iteration ------------------------------------------------
    def step(self) -> Dict[str, Any]:
        """Admit, then run one step (a prefill chunk or a decode)."""
        t0 = time.perf_counter()
        self.scheduler.admit()
        action, req = self.scheduler.next_action()
        info: Dict[str, Any] = {"kind": action}
        if action == "prefill":
            info.update(self._run_prefill(req))
        elif action == "decode":
            info.update(self._run_decode())
        elif self.scheduler.waiting or self.scheduler.resuming:
            raise RuntimeError("scheduler idle with waiting requests — "
                               "admission wedged")
        if info.get("tokens"):          # a step that ran the model
            self.step_s[action].append(time.perf_counter() - t0)
        self.step_count += 1
        return info

    def _run_prefill(self, req: Request) -> Dict[str, Any]:
        kv, slot = self.kv, req.slot
        c = min(self.scheduler.chunk, req.remaining_prefill)
        if not self._ensure(slot, int(kv.lens[slot]) + c):
            return {"tokens": 0, "rid": req.rid, "self_preempted": True}
        bucket = bucket_of(c, self.min_bucket, self.scheduler.chunk)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :c] = req.prefill_tokens[req.prefill_pos:
                                         req.prefill_pos + c]
        with torch.no_grad():
            logits, kv.pools = lm.prefill_chunk_paged(
                self.params, kv.pools, kv.device_page_table(slot),
                kv.device_lens(slot), torch.from_numpy(toks).to(self.device),
                c, self.cfg, write_sink=kv.sink_row(slot))
            tok = sample_tokens(logits, [req.sampling],
                                [len(req.output)]).tolist()[0]
        req.prefill_pos += c
        kv.lens[slot] += c
        self.prefill_tokens += c
        self.scheduler.prefill_advanced(req)
        if req.remaining_prefill == 0:
            req.state = RequestState.DECODE
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
        with torch.no_grad():
            logits, kv.pools = lm.decode_step_paged(
                self.params, kv.pools, kv.device_page_table(),
                kv.device_lens(), torch.from_numpy(tokens).to(self.device),
                self.cfg, active=torch.from_numpy(active).to(self.device),
                write_sink=self._sinks, attn_kernel=self.attn_kernel)
            toks = sample_tokens(logits, by_slot, positions).tolist()
        now = time.perf_counter()
        for s in slots:
            req = self.scheduler.running[s]
            kv.lens[s] += 1                  # the input token's KV slot
            if req.emit(toks[s], now):
                self._retire(req)
        self.decode_tokens += len(slots)
        return {"tokens": len(slots)}

    def _retire(self, req: Request) -> None:
        self.scheduler.finish(req)
        self.done.append(req)

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
        return {
            "device": str(self.device),
            "attn_kernel": self.attn_kernel,
            "requests_done": len(self.done),
            "tokens_generated": sum(len(r.output) for r in self.done),
            "engine_steps": self.step_count,
            "prefill_steps": len(pre),
            "decode_steps": len(dec),
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "prefill_s": sum(pre),
            "decode_s": sum(dec),
            "prefill_tok_per_s": self.prefill_tokens / max(sum(pre), 1e-12),
            "decode_tok_per_s": self.decode_tokens / max(sum(dec), 1e-12),
            "p50_decode_step_s": quantile(dec, 50),
            "p50_latency_s": quantile(lat, 50),
            "p99_latency_s": quantile(lat, 99),
            "p50_ttft_s": quantile(ttft, 50),
            "p99_ttft_s": quantile(ttft, 99),
            "p50_itl_s": quantile(itl, 50),
            "p99_itl_s": quantile(itl, 99),
            "preempt_recompute": self.preempts,
            "resumes": self.scheduler.resume_count,
            "cache_bytes": self.kv.cache_bytes,
            "peak_kv_used_bytes": self.kv.peak_used_bytes,
        }
