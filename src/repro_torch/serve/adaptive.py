"""Prefill chunk bucketing, as in ``repro.serve.adaptive``.

Chunk token counts are padded up to power-of-two buckets. Pad tokens
route through the MoE and take expert capacity, so the same padding is
needed for the same numbers as the JAX engine. The per-bucket adaptive
(n, strategy) resolution needs the analytic core and comes with
ROADMAP.md's 'Adaptive prefill buckets' slice; until then prefill uses
the config's ``num_partitions`` as is.
"""
from __future__ import annotations


def bucket_of(ntok: int, min_bucket: int, max_bucket: int) -> int:
    """Smallest power-of-two multiple of ``min_bucket`` >= ``ntok``,
    clamped to ``max_bucket``."""
    b = min_bucket
    while b < ntok and b < max_bucket:
        b *= 2
    return min(b, max_bucket)
