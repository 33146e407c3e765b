"""Continuous-batching scheduler: admission, placement, preemption,
interleave, as ``repro.serve.scheduler``.

* **Admission** is FCFS, in two reservation modes. ``full_reserve=True``
  admits a request only when its whole budget (prompt + max_new_tokens)
  can be reserved up front; ``full_reserve=False`` needs a free slot plus
  pages for the *prompt* only, decode grows page by page, and a dry pool
  makes the engine preempt a victim.
* **Placement** over the cache's shards (``kv_sharding="dp"``): a fresh
  request goes to the shard holding the longest cached prefix of its
  prompt (``match_prefix``), else to the least-loaded shard with a free
  slot that can reserve it (``best_shard``: most free pages, ties to the
  lowest id), and keeps that shard (``Request.kv_shard``) for life:
  every resume lands back on it. A resume blocked on its shard blocks
  fresh admissions too. With one shard this is the single-device
  behaviour.
* **Preemption** (:meth:`preempt`): the victim leaves its slot as
  PREEMPTED, either dropping its pages to re-prefill its prompt plus
  generated tokens at resume (*recompute*) or parking them in host
  memory (*offload*), and joins the resume queue. An offloaded request
  resumes into PREFILL or DECODE, where it stopped, once its pages fit
  again (``can_restore``). Resumes go strictly before fresh admissions,
  oldest first, with head-of-line blocking in both queues, so the
  oldest work always makes progress.
* **Prefix reuse**: fresh admissions and recompute resumes go through
  ``StateCache.alloc_slot_prefix`` (floored to a page under
  ``full_reserve``) and start prefill at the cached length; a hit may
  admit a request whose whole reservation ``can_admit`` would refuse
  (``match_prefix``). No-ops with the prefix cache off.
* **Cancellation** (:meth:`cancel`) releases whatever a request holds,
  from any live stage.
* **Interleaving**: prefill is chunked and alternates with decode when
  both have work, bounding decode-token latency by one chunk.
* **Telemetry** (``obs``, a ``repro_torch.obs.Recorder``): the JAX
  scheduler's ``repro_resumes_total`` and ``repro_admits_total{kind}``
  counters, and the ``ADMIT``, ``RESUME`` and ``PREEMPT`` instants on
  the request's trace track, with the ``DECODE`` span opened on a resume
  into decode and closed at preemption.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.obs import PID_REQUESTS, Recorder
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.state_cache import StateCache

__all__ = ["Scheduler"]


class Scheduler:
    def __init__(self, kv: StateCache, *, chunk: int = 64,
                 full_reserve: bool = False,
                 obs: Optional[Recorder] = None):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.kv = kv
        self.chunk = chunk
        self.full_reserve = full_reserve
        self.waiting: Deque[Request] = deque()
        self.resuming: List[Request] = []              # PREEMPTED requests
        self.running: Dict[int, Request] = {}          # slot -> request
        self._prefilling: Deque[int] = deque()         # slots, FCFS
        self._last_was_prefill = False
        self.resume_count = 0
        self.obs = obs if obs is not None else Recorder()
        self._m_resumes = self.obs.registry.counter(
            "repro_resumes_total", "preempted requests resumed")
        self._m_admits = self.obs.registry.counter(
            "repro_admits_total", "admissions by kind", ["kind"])

    # -- queue side ------------------------------------------------------
    def submit(self, req: Request) -> None:
        assert req.state == RequestState.QUEUED
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.resuming or self.running)

    def free_slots_of(self, shard: int) -> List[int]:
        return [s for s in self.kv.slots_of(shard)
                if s not in self.running]

    # -- admission -------------------------------------------------------
    def _place_fresh(self, req: Request
                     ) -> Optional[Tuple[int, int, int]]:
        """(shard, slot, tokens to reserve) for a fresh admission: the
        shard holding the longest cached prefix of the prompt, else the
        least-loaded shard with a free slot that fits the reservation;
        None when no shard can take it now."""
        need = req.total_budget if self.full_reserve else req.prompt_len
        by_shard = {s: self.free_slots_of(s)
                    for s in range(self.kv.n_shards)}
        cands = [s for s, slots in by_shard.items() if slots]
        # a cached prefix can make room the reservation lacks
        shard, _ = self.kv.match_prefix(req.prefill_tokens, need,
                                        candidates=cands)
        if shard is None:
            shard = self.kv.best_shard(need, candidates=cands)
        if shard is None:
            return None
        return shard, by_shard[shard][0], need

    def admit(self) -> List[Request]:
        """Move resumable, then QUEUED, requests into free slots while the
        page budget holds (FCFS, head-of-line blocking). Resumes go back
        to their own shard; fresh requests are placed by
        :meth:`_place_fresh`."""
        admitted = []
        while True:
            if self.resuming:
                req = min(self.resuming, key=lambda r: r.rid)
                slots = self.free_slots_of(req.kv_shard)
                if not slots:
                    break
                if req.preempt_mode == "offload":
                    if not self.kv.can_restore(req.rid):
                        break
                elif not self.kv.can_admit(req.prefill_len, req.kv_shard):
                    break
                slot = slots[0]
                self._admit_resume(req, slot)
            elif self.waiting:
                req = self.waiting[0]
                placement = self._place_fresh(req)
                if placement is None:
                    break
                shard, slot, need = placement
                cached = self.kv.alloc_slot_prefix(
                    slot, need, req.prefill_tokens,
                    page_aligned=self.full_reserve)
                req.prefill_pos = cached        # skip the cached prefix
                self.waiting.popleft()
                req.kv_shard = shard
                req.state = RequestState.PREFILL
                self._m_admits.labels(kind="fresh").inc()
                tracer = self.obs.tracer
                tracer.thread_name(PID_REQUESTS, req.rid, f"req {req.rid}")
                tracer.instant("ADMIT", pid=PID_REQUESTS, tid=req.rid,
                               args={"shard": shard, "slot": slot,
                                     "reserved_tokens": need,
                                     "cached_tokens": cached})
            else:
                break
            req.slot = slot
            self.running[slot] = req
            if req.state == RequestState.PREFILL:
                self._prefilling.append(slot)
            admitted.append(req)
        return admitted

    def _admit_resume(self, req: Request, slot: int) -> None:
        if req.preempt_mode == "offload":
            self.kv.restore_slot(req.rid, slot, req.cached_tokens)
            req.state = (RequestState.PREFILL if req.resume_to == "prefill"
                         else RequestState.DECODE)
        else:                                   # recompute: re-prefill
            req.prefill_pos = self.kv.alloc_slot_prefix(
                slot, req.prefill_len, req.prefill_tokens,
                page_aligned=self.full_reserve)
            req.state = RequestState.PREFILL
        self.resuming.remove(req)
        req.preempt_mode = ""
        req.cached_tokens = 0
        self.resume_count += 1
        self._m_resumes.inc()
        self._m_admits.labels(kind="resume").inc()
        tracer = self.obs.tracer
        tracer.instant("RESUME", pid=PID_REQUESTS, tid=req.rid,
                       args={"to": req.resume_to, "slot": slot})
        if req.state == RequestState.DECODE:
            tracer.begin("DECODE", pid=PID_REQUESTS, tid=req.rid)
            req.decode_span_open = True

    # -- preemption ------------------------------------------------------
    def preempt(self, req: Request, mode: str = "recompute") -> str:
        """Evict a running request: free (``"recompute"``) or offload
        (``"offload"``) its pages and move it to the resume queue.
        Returns the mode applied: an offload of a request with no cached
        tokens is a recompute. The request keeps its ``kv_shard``."""
        if mode not in ("recompute", "offload"):
            raise ValueError(f"preempt mode must be recompute or offload, "
                             f"got {mode!r}")
        slot = req.slot
        assert self.running.get(slot) is req, f"request {req.rid} not running"
        req.resume_to = ("prefill" if req.state == RequestState.PREFILL
                         else "decode")
        req.cached_tokens = int(self.kv.lens[slot])
        if mode == "offload" and req.cached_tokens > 0:
            self.kv.offload_slot(slot, req.rid)
        else:
            mode = "recompute"
            self.kv.free_slot(slot)
            req.prefill_pos = 0
            req.cached_tokens = 0
            req.resume_to = "prefill"
        if slot in self._prefilling:
            self._prefilling.remove(slot)
        del self.running[slot]
        req.slot = -1
        req.state = RequestState.PREEMPTED
        req.preempt_mode = mode
        req.preempt_count += 1
        self.resuming.append(req)
        tracer = self.obs.tracer
        if req.decode_span_open:
            tracer.end("DECODE", pid=PID_REQUESTS, tid=req.rid)
            req.decode_span_open = False
        tracer.instant("PREEMPT", pid=PID_REQUESTS, tid=req.rid,
                       args={"mode": mode, "resume_to": req.resume_to,
                             "cached_tokens": req.cached_tokens})
        return mode

    # -- cancellation ----------------------------------------------------
    def cancel(self, req: Request) -> str:
        """Release everything ``req`` holds and return the stage it was
        in ("queued" | "prefill" | "decode" | "preempted"); the engine
        owns the state change and the hook:

        * QUEUED: leave the waiting queue (nothing is allocated);
        * PREFILL / DECODE: publish the written full prefix pages (a
          later request with the same prompt still gains; a no-op with
          the prefix cache off), then free the slot;
        * PREEMPTED: leave the resume queue; an offload victim's host
          pages are dropped (its device pages went at offload).
        """
        stage = req.state.value
        if req.state == RequestState.QUEUED:
            self.waiting.remove(req)
        elif req.state in (RequestState.PREFILL, RequestState.DECODE):
            slot = req.slot
            assert self.running.get(slot) is req, \
                f"request {req.rid} not running in slot {slot}"
            self.kv.cache_slot_prefix(slot, req.prefill_tokens)
            self.kv.free_slot(slot)
            if slot in self._prefilling:
                self._prefilling.remove(slot)
            del self.running[slot]
            req.slot = -1
        elif req.state == RequestState.PREEMPTED:
            self.resuming.remove(req)
            if req.preempt_mode == "offload":
                self.kv.drop_offload(req.rid)
            req.preempt_mode = ""
            req.cached_tokens = 0
        else:
            raise ValueError(f"cancel of request {req.rid} in terminal "
                             f"state {req.state.value}")
        return stage

    # -- step planning ---------------------------------------------------
    def decode_slots(self) -> List[int]:
        return [s for s, r in self.running.items()
                if r.state == RequestState.DECODE]

    def next_action(self) -> Tuple[str, Optional[Request]]:
        """('prefill', request) | ('decode', None) | ('idle', None)."""
        has_prefill = bool(self._prefilling)
        has_decode = bool(self.decode_slots())
        if has_prefill and (not has_decode or not self._last_was_prefill):
            self._last_was_prefill = True
            return "prefill", self.running[self._prefilling[0]]
        if has_decode:
            self._last_was_prefill = False
            return "decode", None
        return "idle", None

    def prefill_advanced(self, req: Request) -> None:
        """Book-keeping after one prefill chunk of ``req`` ran."""
        if req.remaining_prefill <= 0:
            assert self._prefilling[0] == req.slot
            self._prefilling.popleft()

    def finish(self, req: Request) -> None:
        """Release a DONE request's slot and pages."""
        assert req.state == RequestState.DONE
        self.kv.free_slot(req.slot)
        self.running.pop(req.slot, None)
        req.slot = -1
