"""Request/response API of the serving engine, as in
``repro.serve.request``.

A request moves QUEUED -> PREFILL -> DECODE -> DONE, possibly bouncing
through PREEMPTED (back to the scheduler's resume queue) when the paged
KV pool runs dry: by recompute (it re-prefills at resume) or by offload
(its pages wait in host memory and it resumes where it stopped).
``Engine.cancel`` ends a request from any of these stages as CANCELLED.
Stopping (``max_new_tokens``, ``eos_id``, ``stop`` sequences) is applied
host-side; the ``on_token`` hook sees every emitted token and
``on_done`` the request's end (done or cancelled), once. Every emitted
token is timestamped, so TTFT and inter-token latency are reported
apart: a preemption stall shows as one long inter-token gap.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.serve.sampling import SamplingParams, normalize_stops, \
    stop_hit

__all__ = ["Request", "RequestState"]


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    PREEMPTED = "preempted"
    DONE = "done"
    CANCELLED = "cancelled"            # terminal: the client went away


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                     # [L] int32 token ids
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    stop: Sequence[Sequence[int]] = ()     # token-id stop sequences
    sampling: SamplingParams = SamplingParams()
    priority: int = 0                      # higher = preempted later
    on_token: Optional[Callable[[int, "Request"], None]] = None
    on_done: Optional[Callable[["Request"], None]] = None
    arrival_s: float = 0.0                 # submit timestamp (perf_counter)

    # -- runtime state (owned by the scheduler/engine) -------------------
    state: RequestState = RequestState.QUEUED
    slot: int = -1                         # continuous-batch slot index
    prefill_pos: int = 0                   # source tokens already cached
    output: List[int] = dataclasses.field(default_factory=list)
    finish_reason: str = ""    # "eos" | "length" | "stop" | "cancelled"
    first_token_s: float = 0.0
    finish_s: float = 0.0
    token_times: List[float] = dataclasses.field(default_factory=list)

    # -- preemption state ------------------------------------------------
    preempt_mode: str = ""                 # "recompute" | "offload" | ""
    resume_to: str = ""                    # "prefill" | "decode"
    cached_tokens: int = 0                 # KV tokens parked in host memory
    preempt_count: int = 0
    # the KV shard placed at the first admission and kept for the
    # request's life: every resume lands back on it (-1 = not placed)
    kv_shard: int = -1
    # telemetry: a DECODE B-span is open on the request's trace track
    # (repro_torch.obs); its closer (preempt, retire or cancel) must
    # balance it
    decode_span_open: bool = False

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        self.stop = normalize_stops(self.stop)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def total_budget(self) -> int:
        """KV positions this request may ever occupy."""
        return self.prompt_len + self.max_new_tokens

    # After a recompute preemption mid-decode, "prefill" replays the
    # prompt plus every generated token except the last (the last one is
    # the pending decode input — its KV is written by the decode step that
    # consumes it, exactly as in the never-preempted run).
    @property
    def prefill_len(self) -> int:
        return self.prompt_len + max(0, len(self.output) - 1)

    @property
    def prefill_tokens(self) -> np.ndarray:
        if not self.output:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.output[:-1], np.int32)])

    @property
    def remaining_prefill(self) -> int:
        return self.prefill_len - self.prefill_pos

    def emit(self, token: int, now: float) -> bool:
        """Record one generated token; True when the request is finished
        (EOS, stop sequence, or length)."""
        token = int(token)
        if not self.output:
            self.first_token_s = now
        self.output.append(token)
        self.token_times.append(now)
        if self.on_token is not None:
            self.on_token(token, self)
        if self.eos_id is not None and token == self.eos_id:
            self.finish_reason = "eos"
        elif self.stop and stop_hit(self.output, self.stop) is not None:
            self.finish_reason = "stop"
        elif len(self.output) >= self.max_new_tokens:
            self.finish_reason = "length"
        else:
            return False
        self.state = RequestState.DONE
        self.finish_s = now
        if self.on_done is not None:
            self.on_done(self)
        return True

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def ttft_s(self) -> float:
        """Time to first token."""
        return self.first_token_s - self.arrival_s

    @property
    def itl_s(self) -> List[float]:
        """Inter-token latencies (gaps between consecutive emits)."""
        t = self.token_times
        return [b - a for a, b in zip(t, t[1:])]
