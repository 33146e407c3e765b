"""Deterministic, seekable synthetic token pipeline, a copy of
``repro.data.synthetic``'s ``SyntheticTokens`` (numpy Philox) and
``VaryingSyntheticTokens``: every batch is a pure function of (seed,
step, host slice), byte-equal to the JAX package's. The audio and vision
stub frontends come with ROADMAP.md's 'Other architectures' slice."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.configs.base import ArchConfig


class SyntheticTokens:
    def __init__(self, cfg: ArchConfig, batch: int, seq: int,
                 seed: int = 0, num_hosts: int = 1, host_index: int = 0):
        assert batch % num_hosts == 0, (batch, num_hosts)
        if cfg.frontend != "none":
            raise NotImplementedError(
                f"frontend {cfg.frontend!r} comes with ROADMAP.md's "
                f"'Other architectures' slice")
        self.cfg = cfg
        self.global_batch = batch
        self.local_batch = batch // num_hosts
        self.seq = seq
        self.seed = seed
        self.host_index = host_index

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a global step (host-local slice)."""
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, self.host_index, step]))
        b, s = self.local_batch, self.seq
        vocab = self.cfg.vocab_size
        # "documents": markov-ish stream so the LM loss is learnable
        base = rng.integers(0, vocab, size=(b, s + 1), dtype=np.int32)
        repeat = rng.random((b, s + 1)) < 0.5
        base[:, 1:] = np.where(repeat[:, 1:], (base[:, :-1] + 1) % vocab,
                               base[:, 1:])
        return {"tokens": base[:, :-1], "labels": base[:, 1:].copy()}


class VaryingSyntheticTokens:
    """Seekable source whose per-step batch size follows ``trace``
    (cycled): traffic whose token count drifts, the workload the online
    adaptive controller retunes for (each distinct size is a new shape,
    and possibly a new optimal pipeline granularity)."""

    def __init__(self, cfg: ArchConfig, trace: Sequence[int], seq: int,
                 seed: int = 0, num_hosts: int = 1, host_index: int = 0):
        assert trace, "need at least one batch size"
        self.trace = tuple(int(b) for b in trace)
        self._sources = {
            b: SyntheticTokens(cfg, batch=b, seq=seq, seed=seed,
                               num_hosts=num_hosts, host_index=host_index)
            for b in set(self.trace)}

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return self._sources[self.trace[step % len(self.trace)]] \
            .batch_at(step)
