"""The serving engine's decode step as one captured CUDA graph — the
port's counterpart of the JAX engine's decode step, jitted once.

:class:`DecodeStep` runs ``lm.decode_step_paged`` over the whole slot
batch from inputs at fixed device addresses: the cache's page table,
lens and sinks (``StateCache.decode_inputs``) and its own tokens and
active mask, each a :class:`~repro_torch.serve.state_cache.StaticInput`
refreshed in place every step. The pools are written in place, so they
keep their addresses too. On the card the first call runs the step
eagerly on a side stream, which sets up every kernel's host-side state
for that stream (split counts, the GQA merge counters, shared-memory
opt-ins, the loaded libraries, cuBLAS's workspace; the RoPE frequency
tables are made before it, on the main stream), and then captures
the same step on that stream into a ``torch.cuda.CUDAGraph``; every later
call refreshes the inputs and replays it. The shapes are fixed by
``max_slots`` and the table width, so one capture serves the engine's
life: preemption, offload, restore and retirement change only the
buffers' contents. A failed capture or replay raises; nothing falls
back to the eager step. On the CPU, or with ``graph=False``, every call
runs the step eagerly over the same buffers.

Over ranks (``dist``) the step runs eagerly: the graph would hold the
MoE's collectives, and NCCL inside a captured graph is ROADMAP.md's
Queue 1 item 3d (gloo's collectives cannot be captured at all), so
``graph=True`` under a process group raises ``NotImplementedError``.
Each rank computes the slots of ``StateCache.decode_rows``: every slot
over replicated pools, its shard's over dp-sharded ones.

``on_capture`` (the engine's telemetry hook) runs after each capture.

Sampling stays outside the graph (its per-request generators live on
the host): the caller reads the returned logits before the next call,
which overwrites them.

A replay calls no wrapper, so it cannot count launches in
``kernels.build.LAUNCHES`` itself. The capture records the wrapper calls
of one step (``build.recording``) and each replay adds them
(``build.replayed``), so the counts go on meaning launches made.
"""
from __future__ import annotations

import collections
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import build
from repro_torch.models import lm
from repro_torch.models.layers import rope
from repro_torch.serve.state_cache import StateCache, StaticInput

__all__ = ["DecodeStep"]


class DecodeStep:
    def __init__(self, params, kv: StateCache, cfg: ArchConfig, *,
                 attn_kernel: str, graph: bool = True, dist=None,
                 on_capture: Optional[Callable[[], None]] = None):
        if graph and dist is not None:
            raise NotImplementedError(
                "a captured decode step over ranks needs NCCL collectives "
                "inside the CUDA graph: ROADMAP.md Queue 1 item 3d; pass "
                "decode_graph=False")
        self.params, self.kv, self.cfg = params, kv, cfg
        self.attn_kernel = attn_kernel
        self.dist = dist
        self.rows = kv.decode_rows
        n = len(self.rows)
        self.tokens = StaticInput((n, 1), torch.int64, kv.device)
        self.active = StaticInput((n,), torch.bool, kv.device)
        self.use_graph = graph and kv.device.type == "cuda"
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None   # the graph's output
        self.launches: collections.Counter = collections.Counter()
        self.captures = 0
        self.replays = 0
        self.on_capture = on_capture     # called after each capture

    def __call__(self, tokens: np.ndarray, active: np.ndarray, *,
                 sink_only: bool = False) -> torch.Tensor:
        """One decode step: ``tokens`` ``[max_slots, 1]``, ``active``
        ``[max_slots]`` (host arrays). Returns the last-token logits of
        the slots of ``rows`` (``[len(rows), vocab]``), valid until the
        next call. ``sink_only`` maps every page-table row to the sink
        and every length to 0."""
        table, lens, sinks = self.kv.decode_inputs(sink_only)
        rows = slice(self.rows.start, self.rows.stop)
        self.tokens.refresh(tokens[rows])
        self.active.refresh(active[rows])
        with torch.no_grad():
            if not self.use_graph:
                return self._forward(table, lens, sinks)
            if self.graph is None:
                return self._capture(table, lens, sinks)
            self.graph.replay()
        build.replayed(self.launches)
        self.replays += 1
        return self.logits

    def _forward(self, table, lens, sinks) -> torch.Tensor:
        logits, _ = lm.decode_step_paged(
            self.params, self.kv.pools, table, lens, self.tokens.tensor,
            self.cfg, active=self.active.tensor, write_sink=sinks,
            attn_kernel=self.attn_kernel, dist=self.dist,
            kv_sharded=self.kv.local_shard is not None)
        return logits

    def _capture(self, table, lens, sinks) -> torch.Tensor:
        """Run this step eagerly on a side stream (its launches are real
        and count), then capture the same step there. Returns the eager
        step's logits."""
        dev = self.kv.device
        rope.prepare(self.cfg, dev)   # its tables outside the graph's pool
        main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            logits = self._forward(table, lens, sinks)
        graph = torch.cuda.CUDAGraph()
        with build.recording() as recorded:
            with torch.cuda.graph(graph, stream=side):
                static = self._forward(table, lens, sinks)
        main.wait_stream(side)
        self.graph, self.logits, self.launches = graph, static, recorded
        self.captures += 1
        if self.on_capture is not None:
            self.on_capture()
        return logits
