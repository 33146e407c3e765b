"""Metrics registry: named counters, gauges and ring-buffer histograms
with Prometheus text exposition, as ``repro.obs.metrics`` (stdlib only;
the port's own copy).

One :class:`Registry` is the single metrics surface of a process: the
serving engine, the scheduler, the page cache, the resolver and the
train-side adaptive controller all register into the same instance
(metric creation is idempotent: asking for an existing name returns the
same object, so independent subsystems share families without
coordination). ``render()`` emits the Prometheus text exposition format
served by :class:`repro_torch.obs.export.MetricsServer`; ``snapshot()``
returns the same data as a plain JSON-serializable dict.

Quantiles are **nearest-rank**: :func:`quantile` is the one shared
implementation (``Engine.stats()`` and the histograms both use it): the
index is ``ceil(p/100 * n) - 1`` into the sorted sample, so p50 of two
samples is the lower one.

Every value is a host number: nothing here touches a tensor or the
CUDA API, so the exporter thread can read the registry while the engine
steps (or captures its decode graph). Thread safety is GIL-level:
single attribute writes and deque appends are atomic, which is all the
exporter thread needs to read a consistent enough view; the registry is
a monitoring surface, not a ledger.
"""
from __future__ import annotations

import math
import re
from collections import deque
from typing import Any, Deque, Dict, Iterable, List, Optional, Sequence, \
    Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "quantile"]

_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def quantile(xs: Sequence[float], p: float) -> float:
    """Nearest-rank p-th percentile (``p`` in [0, 100]) of ``xs``.

    The nearest rank of percentile p over n samples is
    ``ceil(p/100 * n)`` (1-based), i.e. index ``ceil(p/100 * n) - 1``
    into the ascending sort — p0 is the min, p100 the max, and p50 of
    two samples is the *lower* one. Empty input returns 0.0.
    """
    if not xs:
        return 0.0
    assert 0.0 <= p <= 100.0, p
    s = sorted(xs)
    rank = max(1, math.ceil(p / 100.0 * len(s)))
    return float(s[min(rank, len(s)) - 1])


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render without the
    trailing .0 noise (page/slot counts read as integers)."""
    f = float(v)
    if f == int(f) and abs(f) < 2 ** 53:
        return str(int(f))
    return repr(f)


def _label_str(labels: Tuple[Tuple[str, str], ...],
               extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = labels + extra
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


class _Metric:
    """One child time series (a concrete label binding of a family)."""

    def __init__(self, labels: Tuple[Tuple[str, str], ...] = ()):
        self.labels = labels


class Counter(_Metric):
    """Monotonically increasing count."""

    def __init__(self, labels=()):
        super().__init__(labels)
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        assert n >= 0, f"counter decrement ({n})"
        self.value += n


class Gauge(_Metric):
    """Point-in-time value (set/inc/dec)."""

    def __init__(self, labels=()):
        super().__init__(labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram(_Metric):
    """Ring-buffer histogram: quantiles over the last ``window``
    observations, total count/sum over the full lifetime. Rendered as a
    Prometheus *summary* (quantile samples + ``_sum``/``_count``)."""

    QUANTILES = (50.0, 90.0, 99.0)

    def __init__(self, labels=(), *, window: int = 8192):
        super().__init__(labels)
        assert window > 0
        self.window = window
        self._ring: Deque[float] = deque(maxlen=window)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self._ring.append(v)
        self.count += 1
        self.sum += v

    def values(self) -> List[float]:
        return list(self._ring)

    def quantile(self, p: float) -> float:
        return quantile(self.values(), p)


class _Family:
    """A named metric plus its labelled children. A scalar metric is a
    family with one unlabelled child; ``labels()`` materializes keyed
    children on demand (e.g. ``free_pages{shard="0"}``)."""

    def __init__(self, cls, name: str, help: str, label_names: Tuple[str,
                 ...], **kwargs):
        self.cls = cls
        self.name = name
        self.help = help
        self.label_names = label_names
        self.kwargs = kwargs
        self._children: Dict[Tuple[Tuple[str, str], ...], _Metric] = {}
        if not label_names:                   # scalar: one default child
            self._default = self._child(())
        else:
            self._default = None

    def _child(self, key: Tuple[Tuple[str, str], ...]) -> _Metric:
        c = self._children.get(key)
        if c is None:
            c = self.cls(key, **self.kwargs)
            self._children[key] = c
        return c

    def labels(self, **kw) -> Any:
        assert tuple(sorted(kw)) == tuple(sorted(self.label_names)), \
            f"{self.name}: labels {sorted(kw)} != {sorted(self.label_names)}"
        key = tuple((k, str(kw[k])) for k in self.label_names)
        return self._child(key)

    def children(self) -> Iterable[_Metric]:
        return self._children.values()

    # scalar conveniences: a label-less family IS its one child --------
    def __getattr__(self, item):
        if self._default is not None:
            return getattr(self._default, item)
        raise AttributeError(
            f"{self.name} has labels {self.label_names}; "
            f"use .labels(...) before .{item}")


class Registry:
    """Named metric families, rendered to Prometheus text or a plain
    dict. Registration is idempotent: re-declaring a name returns the
    existing family (kind and label names must match)."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}

    def _register(self, cls, name: str, help: str,
                  labels: Sequence[str] = (), **kwargs) -> _Family:
        assert _NAME.match(name), f"bad metric name {name!r}"
        labels = tuple(labels)
        for ln in labels:
            assert _LABEL.match(ln), f"bad label name {ln!r}"
        fam = self._families.get(name)
        if fam is not None:
            assert fam.cls is cls, \
                f"{name} re-registered as {cls.__name__}, was " \
                f"{fam.cls.__name__}"
            assert fam.label_names == labels, \
                f"{name} re-registered with labels {labels}, was " \
                f"{fam.label_names}"
            return fam
        fam = _Family(cls, name, help, labels, **kwargs)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (), *,
                  window: int = 8192) -> _Family:
        return self._register(Histogram, name, help, labels,
                              window=window)

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    # -- exposition ------------------------------------------------------
    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        out: List[str] = []
        for fam in self._families.values():
            kind = {"Counter": "counter", "Gauge": "gauge",
                    "Histogram": "summary"}[fam.cls.__name__]
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {kind}")
            for child in fam.children():
                ls = child.labels
                if isinstance(child, Histogram):
                    vals = sorted(child.values())
                    for q in Histogram.QUANTILES:
                        qs = _label_str(ls, (("quantile", str(q / 100.0)),))
                        out.append(f"{fam.name}{qs} "
                                   f"{_fmt(quantile(vals, q))}")
                    out.append(f"{fam.name}_sum{_label_str(ls)} "
                               f"{_fmt(child.sum)}")
                    out.append(f"{fam.name}_count{_label_str(ls)} "
                               f"{child.count}")
                else:
                    out.append(f"{fam.name}{_label_str(ls)} "
                               f"{_fmt(child.value)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """Plain JSON-serializable view: scalar metrics map to their
        value, labelled families to a ``{label-string: value}`` dict,
        histograms to count/sum/quantile summaries."""
        out: Dict[str, Any] = {}
        for fam in self._families.values():
            def one(child):
                if isinstance(child, Histogram):
                    vals = child.values()
                    return {"count": child.count, "sum": child.sum,
                            **{f"p{int(q)}": quantile(vals, q)
                               for q in Histogram.QUANTILES}}
                return child.value

            if not fam.label_names:
                out[fam.name] = one(fam._default)
            else:
                out[fam.name] = {
                    ",".join(f'{k}="{v}"' for k, v in child.labels):
                        one(child)
                    for child in fam.children()}
        return out
