"""Synthetic request traces, their replay and the dense greedy token
oracle, as ``repro.serve.trace``.

Poisson arrivals (exponential inter-arrival gaps at ``rate`` req/s) with
log-uniform-ish prompt lengths and uniform generation lengths, drawn from
numpy's Philox generator: deterministic in the seed and bit-equal to the
JAX package's trace for the same arguments, so a benchmark run replays
the same requests on either package.

``replay`` drives an engine through a trace in wall-clock time, its
latency clocks starting at each request's *scheduled* arrival (over
ranks, rank 0's clock decides the arrivals);
``run_poisson`` builds an engine, warms it up and replays a trace, the
shared body of the serving launcher's ``--rate`` path and of
``chip_smoke.py``'s replay. ``dense_greedy_reference`` decodes one
request at a time over a dense cache: the token oracle the paged,
batched, captured and preemptive engine is held to.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np

__all__ = ["TraceEntry", "dense_greedy_reference", "poisson_trace",
           "replay", "run_poisson"]


def dense_greedy_reference(params, cfg, prompt, max_new: int) -> List[int]:
    """Golden reference: prefill into a dense fp32 cache, then greedy
    decode, one request at a time (the fixed-batch loop at batch 1), on
    the device the weights live on. The token-exactness oracle the
    engine is held to; it shares no attention kernel with the engine's
    decode (dense decode attends in plain PyTorch)."""
    import torch

    from repro_torch.models import lm

    dev = params["embed"]["tok"].device
    toks = torch.as_tensor(np.asarray(prompt, np.int64)[None, :],
                           device=dev)
    with torch.no_grad():
        logits, cache = lm.prefill(params, toks, cfg,
                                   max_len=len(prompt) + max_new,
                                   dtype=torch.float32)
        out = [int(logits[0, -1].argmax())]
        for _ in range(max_new - 1):
            tok = torch.tensor([[out[-1]]], device=dev)
            lg, cache = lm.decode_step(params, cache, tok, cfg)
            out.append(int(lg[0].argmax()))
    return out


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    arrival_s: float
    prompt: np.ndarray                 # [L] int32
    max_new_tokens: int


def poisson_trace(num_requests: int, *, rate: float, vocab_size: int,
                  prompt_len_range=(8, 96), gen_len_range=(4, 48),
                  seed: int = 0) -> List[TraceEntry]:
    rng = np.random.Generator(np.random.Philox(key=seed))
    gaps = rng.exponential(1.0 / rate, size=num_requests)
    arrivals = np.cumsum(gaps) - gaps[0]          # first request at t=0
    lo, hi = prompt_len_range
    plens = np.exp(rng.uniform(np.log(lo), np.log(hi + 1),
                               size=num_requests)).astype(int).clip(lo, hi)
    glo, ghi = gen_len_range
    glens = rng.integers(glo, ghi + 1, size=num_requests)
    return [TraceEntry(arrival_s=float(arrivals[i]),
                       prompt=rng.integers(0, vocab_size, size=int(plens[i]),
                                           dtype=np.int32),
                       max_new_tokens=int(glens[i]))
            for i in range(num_requests)]


def run_poisson(cfg, options, *, requests: int, rate: float,
                prompt_max: int, gen_max: int, seed: int = 0,
                eos_id=None, time_scale: float = 1.0, sampling=None,
                params=None, on_engine: Optional[Callable] = None,
                weights_seed: int = 0):
    """Build an Engine for ``cfg``/``options``, replay a Poisson trace
    (prompts of 4 to ``prompt_max`` tokens, 2 to ``gen_max`` new tokens,
    drawn from ``seed``) through it, and return ``(engine, wall_s)``.
    ``sampling`` (a :class:`~repro_torch.serve.sampling.SamplingParams`)
    applies to every request; ``params`` reuses an existing parameter
    tree (else the engine draws its weights from ``weights_seed``);
    ``on_engine(engine)`` runs after ``warmup()`` but before the replay:
    the hook the launcher uses to start the ``/metrics`` exporter once
    the decode step is captured."""
    from repro_torch.serve.engine import Engine

    engine = Engine(cfg, params, options=options, seed=weights_seed)
    engine.warmup()        # steady-state numbers, not the capture
    if on_engine is not None:
        on_engine(engine)
    trace = poisson_trace(requests, rate=rate, vocab_size=cfg.vocab_size,
                          prompt_len_range=(4, prompt_max),
                          gen_len_range=(2, gen_max), seed=seed)
    t0 = time.perf_counter()
    replay(engine, trace, eos_id=eos_id, time_scale=time_scale,
           sampling=sampling)
    return engine, time.perf_counter() - t0


def replay(engine, trace: List[TraceEntry], *, eos_id=None,
           time_scale: float = 1.0, sampling=None):
    """Drive ``engine`` through ``trace`` in wall-clock time (arrival
    offsets multiplied by ``time_scale``; 0 submits everything up front).
    Over ranks (an engine with ``dist``) rank 0's clock decides: each
    turn it broadcasts how many entries have arrived, and every rank
    submits those. Returns the list of submitted Requests (done when
    this returns)."""
    t0 = time.perf_counter()
    pending = list(trace)
    requests = []
    kw = {} if sampling is None else {"sampling": sampling}
    ranks = getattr(engine, "dist", None) is not None
    while pending or engine.has_work:
        now = time.perf_counter() - t0
        arrived = 0
        while arrived < len(pending) and \
                pending[arrived].arrival_s * time_scale <= now:
            arrived += 1
        if ranks:
            import torch.distributed
            agreed = [arrived]
            torch.distributed.broadcast_object_list(agreed, src=0)
            arrived = agreed[0]
        for _ in range(arrived):
            e = pending.pop(0)
            # latency clocks start at the *scheduled* arrival, so
            # queueing delay accrued while the engine was mid-step is
            # part of the reported percentiles
            requests.append(engine.submit(
                e.prompt, max_new_tokens=e.max_new_tokens, eos_id=eos_id,
                arrival_s=t0 + e.arrival_s * time_scale, **kw))
        if engine.has_work:
            engine.step()
        elif pending:
            # idle until the next scheduled arrival, in one sleep; the
            # 0.05 s cap keeps very long gaps responsive to wall-clock
            # drift without degenerating into a busy poll
            time.sleep(max(0.0, min(
                0.05, pending[0].arrival_s * time_scale - now)))
    return requests
