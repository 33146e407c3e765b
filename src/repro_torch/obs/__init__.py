"""``repro_torch.obs`` — engine-wide telemetry, as ``repro.obs``: metrics
registry, span tracer, Perfetto export, live ``/metrics`` exporter.
Stdlib only, the port's own copy (the port imports nothing of
``repro``), with the JAX package's names, metric families and span
taxonomy, so a Prometheus scraper or a Perfetto reader written for the
JAX engine reads the port's output unchanged.

Module map:

- ``metrics``  — ``Registry`` of counters/gauges/ring-buffer
  histograms; shared nearest-rank ``quantile``; Prometheus ``render()``
  and JSON ``snapshot()``.
- ``trace``    — ``Tracer`` (Chrome trace-event spans/instants,
  Perfetto-loadable export) and the no-op ``NullTracer``.
- ``export``   — ``MetricsServer``: background HTTP thread serving
  ``/metrics`` + ``/healthz``.

The unit the rest of the port passes around is :class:`Recorder`: a
registry (always real, so ``Engine.stats()`` and ``/metrics`` read one
source of truth) plus a tracer (``NullTracer`` unless span recording was
requested). "Telemetry disabled", the default, means the null tracer and
no exporter thread. Neither the registry nor the tracer touches a tensor
or the CUDA API: counters are host numbers and events host timestamps,
so telemetry on or off adds no kernel, no CUDA event and no
synchronize to a step, and a captured decode step records the same
launches either way.
"""
from __future__ import annotations

from typing import Optional

from .export import MetricsServer
from .metrics import Counter, Gauge, Histogram, Registry, quantile
from .trace import (NullTracer, PID_ENGINE, PID_INGRESS, PID_REQUESTS,
                    PID_RESOLVER, Tracer)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsServer",
           "NullTracer", "PID_ENGINE", "PID_INGRESS", "PID_REQUESTS",
           "PID_RESOLVER", "Recorder", "Registry", "Tracer", "quantile"]


class Recorder:
    """Registry + tracer bundle threaded through engine, scheduler,
    caches, resolver and train controller. Construct with
    ``Recorder(tracer=Tracer())`` to record spans; the default is
    metrics-only with the no-op tracer."""

    def __init__(self, registry: Optional[Registry] = None,
                 tracer: Optional[NullTracer] = None):
        self.registry = registry if registry is not None else Registry()
        self.tracer = tracer if tracer is not None else NullTracer()

    @property
    def tracing(self) -> bool:
        return self.tracer.enabled
