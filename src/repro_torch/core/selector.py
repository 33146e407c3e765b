"""Adaptive runtime configuration (paper §III-C + §III-E), as
``repro.core.selector``.

Resolves the two runtime knobs of MPipeMoE before a step runs:

* pipeline granularity ``n``  — Algorithm 1 over the injected measure
  function (wall clock on the card; the pipeline simulator otherwise);
* memory-reuse strategy       — Eq. 10 argmin, masked by hardware
  capacities (no host offload => S1–S3 unavailable).

Returns an updated ArchConfig; the training loop builds a new step when
the resolved (n, strategy) changes (a cache keyed by them).

:class:`Resolver` records into a ``repro_torch.obs.Recorder``, as the
JAX package's does: the ``repro_retunes_total``,
``repro_retune_seconds`` and ``repro_candidates_measured_total``
families, a ``resolver.resolve`` span (args ``tokens``, ``refresh``,
``n``, ``strategy``) and a ``candidate`` instant for each measured
timing. ``retunes``, ``retune_s`` and ``candidates_measured`` read the
registry back (a registry shared by several resolvers sums them).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence

from repro_torch.configs.base import ArchConfig
from repro_torch.core.granularity import GranularitySearcher
from repro_torch.core.perf_model import MoEWorkload, select_strategy
from repro_torch.core.pipeline_sim import simulate
from repro_torch.core.strategies import host_offload_supported
from repro_torch.core.types import HardwareSpec, Strategy
from repro_torch.obs import PID_RESOLVER, Recorder


def moe_workload(cfg: ArchConfig, local_tokens: int, ep_size: int,
                 dtype_bytes: int = 2, dp: int = 16) -> MoEWorkload:
    m = cfg.moe
    return MoEWorkload(b=local_tokens, m=cfg.d_model, h=m.d_expert,
                       k=m.top_k, ep=ep_size, dtype_bytes=dtype_bytes,
                       gated=cfg.gated_ffn,
                       e_local=max(1, m.num_experts // ep_size), dp=dp)


def make_searcher(cfg: ArchConfig, ep_size: int, hw: HardwareSpec,
                  measure_fn: Optional[Callable] = None,
                  strategy: Strategy = Strategy.NONE, dp: int = 16,
                  candidates: Optional[Sequence[int]] = None
                  ) -> GranularitySearcher:
    if measure_fn is None:
        def measure_fn(b: int, n: int) -> float:
            return simulate(moe_workload(cfg, b, ep_size, dp=dp), hw, n,
                            strategy)
    if candidates:
        return GranularitySearcher(measure_fn, candidates)
    return GranularitySearcher(measure_fn)


def resolve_strategy(cfg: ArchConfig, w: MoEWorkload, hw: HardwareSpec,
                     allow_offload: Optional[bool] = None) -> str:
    """Concrete strategy string for cfg.moe (Eq. 10 argmin when
    'adaptive', masked by hardware capacities — no host offload
    degrades the candidate set to the device-only strategies)."""
    strategy = cfg.moe.memory_reuse_strategy
    if strategy == "adaptive":
        if allow_offload is None:
            allow_offload = hw.has_host_offload and host_offload_supported()
        hw_eff = dataclasses.replace(hw, has_host_offload=allow_offload)
        strategy = select_strategy(w, hw_eff).value
    return strategy


def _resolve_with(cfg: ArchConfig, local_tokens: int, ep_size: int,
                  hw: HardwareSpec, dp: int,
                  allow_offload: Optional[bool],
                  searcher_for: Callable[[str], GranularitySearcher]
                  ) -> ArchConfig:
    """Shared resolution body: strategy via Eq. 10, n via Algorithm 1."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    w = moe_workload(cfg, local_tokens, ep_size, dp=dp)
    strategy = resolve_strategy(cfg, w, hw, allow_offload)
    n = m.num_partitions
    if n == 0:
        n = searcher_for(strategy).best_n(local_tokens)
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(m, num_partitions=n,
                                     memory_reuse_strategy=strategy))


def resolve(cfg: ArchConfig, *, local_tokens: int, ep_size: int,
            hw: HardwareSpec, searcher: Optional[GranularitySearcher] = None,
            allow_offload: Optional[bool] = None, dp: int = 16
            ) -> ArchConfig:
    """Fill in adaptive (n, strategy) -> concrete values in cfg.moe."""
    def searcher_for(strategy: str) -> GranularitySearcher:
        return searcher or make_searcher(cfg, ep_size, hw,
                                         strategy=Strategy(strategy),
                                         dp=dp)

    return _resolve_with(cfg, local_tokens, ep_size, hw, dp,
                         allow_offload, searcher_for)


class Resolver:
    """Incremental ``resolve`` for the online controller (§III-C).

    One persistent :class:`GranularitySearcher` per resolved strategy, so
    revisited token counts hit Algorithm 1's hash/range caches instead of
    re-measuring — the property that makes runtime retuning affordable.

    ``measure_fn(b, n, strategy) -> seconds`` overrides the analytic
    simulator; the training runtime and the serving engine inject
    wall-clock timing of candidate steps on the card here. It is looked
    up at each measurement, so a caller may wrap it after construction.
    """

    def __init__(self, cfg: ArchConfig, *, ep_size: int, hw: HardwareSpec,
                 measure_fn: Optional[Callable[[int, int, Strategy], float]]
                 = None, dp: int = 16,
                 allow_offload: Optional[bool] = None,
                 candidates: Optional[Sequence[int]] = None,
                 obs: Optional[Recorder] = None):
        self.cfg = cfg
        self.ep_size = ep_size
        self.hw = hw
        self.measure_fn = measure_fn
        self.dp = dp
        self.allow_offload = allow_offload
        self.candidates = tuple(candidates) if candidates else None
        self._searchers: Dict[str, GranularitySearcher] = {}
        # serve and train controllers thread the same Recorder through,
        # so resolver retunes land on one surface
        self.obs = obs if obs is not None else Recorder()
        reg = self.obs.registry
        self._m_retunes = reg.counter(
            "repro_retunes_total", "resolver (n, strategy) resolutions")
        self._m_retune_s = reg.histogram(
            "repro_retune_seconds", "wall time per resolver resolution")
        self._m_candidates = reg.counter(
            "repro_candidates_measured_total",
            "candidate (n, strategy) timings measured")
        self.obs.tracer.thread_name(PID_RESOLVER, 1, "retune")

    @property
    def candidates_measured(self) -> int:
        """``measure_fn`` calls (``repro_candidates_measured_total``)."""
        return int(self._m_candidates.value)

    @property
    def retunes(self) -> int:
        """``resolve()`` calls (``repro_retunes_total``)."""
        return int(self._m_retunes.value)

    @property
    def retune_s(self) -> float:
        """Their wall seconds, summed (``repro_retune_seconds``)."""
        return self._m_retune_s.sum

    def searcher_for(self, strategy: str) -> GranularitySearcher:
        s = self._searchers.get(strategy)
        if s is None:
            if self.measure_fn is not None:
                sv = Strategy(strategy)

                def fn(b: int, n: int, _s=sv) -> float:
                    dt = self.measure_fn(b, n, _s)
                    # measured candidate timing: Algorithm 1's probe
                    self._m_candidates.inc()
                    self.obs.tracer.instant(
                        "candidate", pid=PID_RESOLVER,
                        args={"b": b, "n": n, "strategy": _s.value,
                              "seconds": dt})
                    return dt

                s = GranularitySearcher(
                    fn, self.candidates) if self.candidates else \
                    GranularitySearcher(fn)
            else:
                s = make_searcher(self.cfg, self.ep_size, self.hw,
                                  strategy=Strategy(strategy), dp=self.dp,
                                  candidates=self.candidates)
            self._searchers[strategy] = s
        return s

    @property
    def search_calls(self) -> int:
        return sum(s.search_calls for s in self._searchers.values())

    def resolve(self, local_tokens: int,
                refresh: bool = False) -> ArchConfig:
        """``refresh=True`` drops the strategy's learned measurements
        first (timer-triggered retune: the cached timings are presumed
        stale under workload drift, so a cache hit would be inert)."""
        def searcher_for(strategy: str) -> GranularitySearcher:
            s = self.searcher_for(strategy)
            if refresh:
                s.reset()
            return s

        t0 = time.perf_counter()
        with self.obs.tracer.span(
                "resolver.resolve", pid=PID_RESOLVER,
                args={"tokens": local_tokens, "refresh": refresh}) as sp:
            out = _resolve_with(self.cfg, local_tokens, self.ep_size,
                                self.hw, self.dp, self.allow_offload,
                                searcher_for)
            if out.moe is not None:
                sp["n"] = out.moe.num_partitions
                sp["strategy"] = out.moe.memory_reuse_strategy
        self._m_retunes.inc()
        self._m_retune_s.observe(time.perf_counter() - t0)
        return out
