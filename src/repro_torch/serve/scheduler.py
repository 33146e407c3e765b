"""Continuous-batching scheduler: admission, preemption, interleave — the
single-device part of ``repro.serve.scheduler``.

* **Admission** is FCFS, in two reservation modes. ``full_reserve=True``
  admits a request only when its whole budget (prompt + max_new_tokens)
  can be reserved up front; ``full_reserve=False`` needs a free slot plus
  pages for the *prompt* only, decode grows page by page, and a dry pool
  makes the engine preempt a victim.
* **Preemption** (:meth:`preempt`) is *recompute*: the victim drops its
  pages and re-prefills its prompt plus generated tokens at resume.
  Resumes go strictly before fresh admissions, oldest first, with
  head-of-line blocking in both queues, so the oldest work always makes
  progress. Offload preemption comes with ROADMAP.md's 'Offload and
  auto preemption' slice.
* **Interleaving**: prefill is chunked and alternates with decode when
  both have work, bounding decode-token latency by one chunk.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.state_cache import StateCache

__all__ = ["Scheduler"]


class Scheduler:
    def __init__(self, kv: StateCache, *, chunk: int = 64,
                 full_reserve: bool = False):
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

    # -- queue side ------------------------------------------------------
    def submit(self, req: Request) -> None:
        assert req.state == RequestState.QUEUED
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.resuming or self.running)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.kv.max_slots) if s not in self.running]

    # -- admission -------------------------------------------------------
    def admit(self) -> List[Request]:
        """Move resumable, then QUEUED, requests into free slots while the
        page budget holds (FCFS, head-of-line blocking)."""
        admitted = []
        while True:
            slots = self.free_slots()
            if not slots:
                break
            slot = slots[0]
            if self.resuming:
                req = min(self.resuming, key=lambda r: r.rid)
                if not self.kv.can_admit(req.prefill_len):
                    break
                self.kv.alloc_slot(slot, req.prefill_len)
                self.resuming.remove(req)
                req.prefill_pos = 0
                self.resume_count += 1
            elif self.waiting:
                req = self.waiting[0]
                need = (req.total_budget if self.full_reserve
                        else req.prompt_len)
                if not self.kv.can_admit(need):
                    break
                self.kv.alloc_slot(slot, need)
                self.waiting.popleft()
                req.prefill_pos = 0
            else:
                break
            req.state = RequestState.PREFILL
            req.slot = slot
            self.running[slot] = req
            self._prefilling.append(slot)
            admitted.append(req)
        return admitted

    # -- preemption ------------------------------------------------------
    def preempt(self, req: Request) -> None:
        """Evict a running request by recompute: free its pages and move
        it to the resume queue."""
        slot = req.slot
        assert self.running.get(slot) is req, f"request {req.rid} not running"
        self.kv.free_slot(slot)
        if slot in self._prefilling:
            self._prefilling.remove(slot)
        del self.running[slot]
        req.slot = -1
        req.prefill_pos = 0
        req.state = RequestState.PREEMPTED
        req.preempt_count += 1
        self.resuming.append(req)

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
