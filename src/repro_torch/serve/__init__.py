"""``repro_torch.serve`` — continuous-batching serving over paged KV.

``engine.py``      :class:`Engine` / :class:`EngineOptions`: params,
                   page pools, scheduler; ``submit`` / ``cancel`` /
                   ``warmup`` / ``step`` / ``run_until_idle`` /
                   ``stats``; recompute, offload and auto preemption;
                   the prefix cache (``prefix_cache="on"``)
``decode_step.py`` :class:`DecodeStep`: the decode step over static
                   input buffers, captured once as a CUDA graph on the
                   card and replayed every step
``scheduler.py``   :class:`Scheduler`: FCFS admission in both
                   reservation modes with prefix reuse, preemption and
                   resume, cancellation, chunked-prefill / decode
                   interleave
``state_cache.py`` :class:`StateCache`: the protocol the engine and
                   scheduler program against; :class:`StaticInput`
``paged_kv.py``    :class:`PagedKVCache`: host page allocator over the
                   device pools, sink page, host offload, byte counters;
                   refcounted pages, the prefix trie, copy-on-write
``request.py``     :class:`Request` / :class:`RequestState`
``sampling.py``    greedy / temperature / top-k / top-p with seeded
                   per-request streams; host-side stop matching
``adaptive.py``    prefill bucketing and per-bucket adaptive
                   (n, strategy): :class:`PrefillBucketAdaptive`
``trace.py``       :class:`TraceEntry`, ``poisson_trace`` (bit-equal to
                   the JAX package's), ``replay``, ``run_poisson``,
                   ``dense_greedy_reference`` (the token oracle)
``ingress.py``     :class:`IngressServer` (HTTP/SSE over an engine
                   thread; disconnect -> ``Engine.cancel``; reject or
                   degrade shedding), :class:`IngressClient`

Telemetry (``EngineOptions.obs``) lives in ``repro_torch.obs``.
"""
from repro_torch.serve.engine import (PREFIX_CACHE_MODES, Engine,
                                      EngineOptions)
from repro_torch.serve.ingress import (SHED_POLICIES, IngressClient,
                                       IngressOptions, IngressServer,
                                       StreamResult)
from repro_torch.serve.paged_kv import PagedKVCache
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.sampling import SamplingParams, sample_tokens
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.state_cache import StateCache
from repro_torch.serve.trace import (TraceEntry, dense_greedy_reference,
                                     poisson_trace, replay, run_poisson)

__all__ = ["PREFIX_CACHE_MODES", "SHED_POLICIES", "Engine", "EngineOptions",
           "IngressClient", "IngressOptions", "IngressServer",
           "PagedKVCache", "Request", "RequestState", "SamplingParams",
           "Scheduler", "StateCache", "StreamResult", "TraceEntry",
           "dense_greedy_reference", "poisson_trace", "replay",
           "run_poisson", "sample_tokens"]
