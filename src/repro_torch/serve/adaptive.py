"""Per-bucket adaptive (n, strategy) resolution for chunked prefill, as
``repro.serve.adaptive``.

Chunk token counts are padded up to power-of-two buckets (pad tokens
route through the MoE and take expert capacity, so the padding is the
JAX engine's), and MPipeMoE's Algorithm 1 resolves a different optimal
pipeline granularity ``n`` per token count. So each bucket is resolved
once through the persistent :class:`repro_torch.core.Resolver` (the same
hash/range-cached searcher the train-side controller uses).

``measure_fn(bucket_tokens, n, strategy) -> seconds`` injects the
measurement Algorithm 1 ranks candidates by: the analytic pipeline
simulator by default, or the engine's wall-clock candidate timer
(``EngineOptions.measure="wallclock"``, the auto choice on CUDA — the
same split the train-side ``AdaptiveOptions.measure`` makes). Over
ranks (``dist``) a given measure's result is the world's maximum
(``distributed.collectives.slowest``), as the train controller's: each
rank times its own candidate runs, and a rank that resolved another
``n`` would issue another sequence of All-to-Alls. At serving time the
strategy is inert: memory-reuse strategies change execution only under
training's ``wrap_chunk``.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core.pipeline_sim import simulate
from repro_torch.core.selector import Resolver, moe_workload
from repro_torch.core.types import GPU_H100, HardwareSpec, Strategy
from repro_torch.distributed.collectives import slowest
from repro_torch.obs import Recorder

log = logging.getLogger("repro_torch.serve")

__all__ = ["PrefillBucketAdaptive", "bucket_of", "force_adaptive"]


def bucket_of(ntok: int, min_bucket: int, max_bucket: int) -> int:
    """Smallest power-of-two multiple of ``min_bucket`` >= ``ntok``,
    clamped to ``max_bucket``."""
    b = min_bucket
    while b < ntok and b < max_bucket:
        b *= 2
    return min(b, max_bucket)


class PrefillBucketAdaptive:
    """Bucket prefill token counts -> concrete (n, strategy) configs."""

    def __init__(self, cfg: ArchConfig, *, hw: HardwareSpec = GPU_H100,
                 ep_size: int = 1, dp: int = 1, min_bucket: int = 8,
                 max_bucket: int = 512,
                 measure_fn: Optional[Callable[[int, int, Strategy], float]]
                 = None, shards: int = 1,
                 obs: Optional[Recorder] = None, dist=None):
        assert min_bucket > 0 and max_bucket >= min_bucket
        if dist is not None and measure_fn is not None:
            measure_fn = slowest(measure_fn, dist.device)
        self.cfg = cfg
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.shards = max(1, int(shards))
        if cfg.moe is not None and self.shards > 1 and measure_fn is None:
            # analytic path under a mesh: model the per-device share of
            # the bucket (the wall-clock path times the global chunk)
            def measure_fn(b: int, n: int, strategy: Strategy,
                           _cfg=cfg) -> float:
                w = moe_workload(_cfg, max(1, b // self.shards), ep_size,
                                 dp=dp)
                return simulate(w, hw, n, strategy)
        self.resolver = (Resolver(cfg, ep_size=ep_size, hw=hw,
                                  measure_fn=measure_fn, dp=dp, obs=obs)
                         if cfg.moe is not None else None)
        # bucket -> (n, strategy); insertion-ordered for reporting
        self.resolutions: Dict[int, Tuple[int, str]] = {}

    def bucket_of(self, ntok: int) -> int:
        """Smallest power-of-two bucket >= ntok, clamped to the range."""
        return bucket_of(ntok, self.min_bucket, self.max_bucket)

    def cfg_for(self, bucket: int) -> ArchConfig:
        """Concrete config for one bucket; resolves (and logs) once."""
        if self.resolver is None:                  # dense model: no knobs
            self.resolutions.setdefault(bucket, (1, "none"))
            return self.cfg
        rcfg = self.resolver.resolve(bucket)
        resolved = (rcfg.moe.num_partitions, rcfg.moe.memory_reuse_strategy)
        if self.resolutions.get(bucket) != resolved:
            log.info("serve adaptive: bucket %d -> n=%d strategy=%s",
                     bucket, *resolved)
            self.resolutions[bucket] = resolved
        return rcfg

    @property
    def search_calls(self) -> int:
        return self.resolver.search_calls if self.resolver else 0


def force_adaptive(cfg: ArchConfig) -> ArchConfig:
    """Reset cfg.moe to the adaptive placeholders so every bucket is
    resolved by Algorithm 1 / Eq. 10 instead of a baked-in (n, strategy)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_partitions=0, memory_reuse_strategy="adaptive"))
