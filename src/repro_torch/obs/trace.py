"""Span tracer: monotonic-clock spans and instant events exported as
Chrome trace-event JSON (the format Perfetto / chrome://tracing load),
as ``repro.obs.trace`` (stdlib only; the port's own copy).

Taxonomy (the JAX package's, so one Perfetto reader serves both):

* pid 1 "engine"   / tid 1 "steps"    — one ``engine.step`` X span per
  host step (arg ``kind``), with ``prefill``/``decode`` child X spans
  nested inside, plus ``jit.trace`` instants whenever the engine builds
  a step program: in the port a decode-graph capture (``body:
  "decode"``) or a prefill step function (``body: "prefill"``).
* pid 2 "requests" / tid = request id — the request lifecycle:
  ``ADMIT``/``RESUME``/``PREEMPT``/``RETIRE``/``CANCEL`` instants,
  ``PREFILL`` chunk X spans (args: chunk/bucket/pos) and a ``DECODE``
  B/E pair that opens when the request enters decode and closes at
  preemption, retirement or cancellation.
* pid 3 "resolver" / tid 1 "retune"   — ``resolver.resolve`` X spans
  (args: tokens/n/strategy) with ``candidate`` instants for each
  measured (n, strategy) timing inside the granularity search.
* pid 4 "ingress"  / tid = request id — ``STREAM`` B/E pairs,
  ``DISCONNECT`` instants; ``SHED`` instants on tid 0.

Two recorders share the interface: :class:`Tracer` buffers events in
memory and ``export()``s ``{"traceEvents": [...]}``;
:class:`NullTracer` is the disabled path: every method is a no-op and
``span()`` returns a shared inert context manager, so instrumented call
sites cost one attribute lookup plus a no-op call. Events are host
events on ``time.perf_counter()``: no CUDA event, no synchronize, no
kernel, so the tracer on or off leaves a step's launches unchanged.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

__all__ = ["NullTracer", "Tracer", "PID_ENGINE", "PID_INGRESS",
           "PID_REQUESTS", "PID_RESOLVER"]

PID_ENGINE = 1
PID_REQUESTS = 2
PID_RESOLVER = 3
PID_INGRESS = 4

_PROCESS_NAMES = {PID_ENGINE: "engine", PID_REQUESTS: "requests",
                  PID_RESOLVER: "resolver", PID_INGRESS: "ingress"}


def _now_us() -> float:
    return time.perf_counter() * 1e6


class _Span:
    """Context manager for an X (complete) event. Mutable mapping-ish:
    ``span["key"] = value`` attaches args discovered mid-span (the
    resolver's chosen (n, strategy) is only known at exit)."""

    __slots__ = ("_tracer", "name", "pid", "tid", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, pid: int, tid: int,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.pid = pid
        self.tid = tid
        self.args = dict(args) if args else {}
        self._t0 = 0.0

    def __setitem__(self, key: str, value: Any) -> None:
        self.args[key] = value

    def __enter__(self) -> "_Span":
        self._t0 = _now_us()
        return self

    def __exit__(self, *exc) -> None:
        t1 = _now_us()
        self._tracer._emit({
            "ph": "X", "name": self.name, "pid": self.pid,
            "tid": self.tid, "ts": self._t0,
            "dur": max(0.0, t1 - self._t0),
            **({"args": self.args} if self.args else {})})


class _NullSpan:
    """Inert span: accepts item assignment, does nothing."""

    __slots__ = ()

    def __setitem__(self, key: str, value: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


class NullTracer:
    """Disabled tracer — the default. Every method no-ops; ``enabled``
    is False so call sites can skip arg construction entirely."""

    enabled = False
    _SPAN = _NullSpan()

    def span(self, name: str, *, pid: int = PID_ENGINE, tid: int = 1,
             args: Optional[Dict[str, Any]] = None) -> _NullSpan:
        return self._SPAN

    def instant(self, name: str, *, pid: int = PID_ENGINE, tid: int = 1,
                args: Optional[Dict[str, Any]] = None) -> None:
        pass

    def begin(self, name: str, *, pid: int = PID_ENGINE, tid: int = 1,
              args: Optional[Dict[str, Any]] = None) -> None:
        pass

    def end(self, name: str, *, pid: int = PID_ENGINE,
            tid: int = 1) -> None:
        pass

    def thread_name(self, pid: int, tid: int, name: str) -> None:
        pass

    def export(self) -> Dict[str, Any]:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        pass


class Tracer(NullTracer):
    """In-memory Chrome trace-event recorder.

    Events carry microsecond ``ts`` from ``time.perf_counter()`` (one
    monotonic clock for the whole process, so spans from different
    pids interleave correctly on the Perfetto timeline).
    """

    enabled = True

    def __init__(self):
        self._events: List[Dict[str, Any]] = []
        self._thread_names: Dict[tuple, str] = {}

    # -- emission --------------------------------------------------------
    def _emit(self, ev: Dict[str, Any]) -> None:
        self._events.append(ev)

    def span(self, name, *, pid=PID_ENGINE, tid=1, args=None) -> _Span:
        return _Span(self, name, pid, tid, args)

    def instant(self, name, *, pid=PID_ENGINE, tid=1, args=None) -> None:
        self._emit({"ph": "i", "name": name, "pid": pid, "tid": tid,
                    "ts": _now_us(), "s": "t",
                    **({"args": dict(args)} if args else {})})

    def begin(self, name, *, pid=PID_ENGINE, tid=1, args=None) -> None:
        self._emit({"ph": "B", "name": name, "pid": pid, "tid": tid,
                    "ts": _now_us(),
                    **({"args": dict(args)} if args else {})})

    def end(self, name, *, pid=PID_ENGINE, tid=1) -> None:
        self._emit({"ph": "E", "name": name, "pid": pid, "tid": tid,
                    "ts": _now_us()})

    def thread_name(self, pid: int, tid: int, name: str) -> None:
        self._thread_names[(pid, tid)] = name

    # -- export ----------------------------------------------------------
    def export(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object. Real events sorted by ts
        (B before E at equal ts so zero-duration pairs stay nested);
        process/thread metadata (ph=M) prepended."""
        meta: List[Dict[str, Any]] = []
        pids = sorted({e["pid"] for e in self._events}
                      | set(_PROCESS_NAMES)
                      | {p for p, _ in self._thread_names})
        for pid in pids:
            meta.append({"ph": "M", "name": "process_name", "pid": pid,
                         "tid": 0, "ts": 0,
                         "args": {"name": _PROCESS_NAMES.get(
                             pid, f"pid{pid}")}})
        for (pid, tid), name in sorted(self._thread_names.items()):
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": tid, "ts": 0, "args": {"name": name}})
        order = {"B": 0, "X": 0, "i": 1, "E": 2}
        events = sorted(self._events,
                        key=lambda e: (e["ts"], order.get(e["ph"], 1)))
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export(), f)
