"""Performance model for memory-reusing strategies (paper Eq. 10), a copy
of ``repro.core.perf_model``.

The end-to-end time of the pipelined MoE step is the max over three
"streams" — compute (expert GEMMs), collective (All-to-All), host copy
(offload traffic) — each being (amount of work) / (effective speed), where
effective speed carries the interference slowdown factors (mu, sigma, eta;
paper Fig. 3). Strategy choice = argmin cost, exactly as in §III-E.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.types import Q_TABLE, HardwareSpec, Strategy


@dataclasses.dataclass(frozen=True)
class MoEWorkload:
    """Per-device MoE layer workload (one direction of the layer).

    b: local tokens routed per step; m/h: model/hidden dims; k: top-k;
    ep: expert-parallel group size; dtype_bytes: activation bytes;
    e_local: experts resident per device; dp: data-parallel width (the
    expert-weight gradient psum crosses it once per *pipeline chunk* —
    a term the paper's model omits). At ``ep == 1`` (one device)
    ``v_comm`` is 0: there is no All-to-All for chunking to hide.
    """
    b: int
    m: int
    h: int
    k: int = 1
    ep: int = 16
    dtype_bytes: int = 2
    gated: bool = False
    e_local: int = 1
    dp: int = 16

    @property
    def weight_psum_bytes(self) -> float:
        """fp32 expert-weight grads psum'd over dp per chunk (backward)."""
        if self.dp <= 1:
            return 0.0
        gemms = 3 if self.gated else 2
        return gemms * self.e_local * self.m * self.h * 4.0

    @property
    def v_comp(self) -> float:
        """FLOPs of ONE expert GEMM pass over the dispatched tokens
        (paper's v0_comp = b*H*M, up to the factor-2 MAC convention)."""
        gemms = 3 if self.gated else 2          # up(+gate)+down counted by q1
        del gemms  # q1 in Q_TABLE already counts GEMMs; one unit here:
        return 2.0 * self.b * self.k * self.m * self.h

    @property
    def v_comm(self) -> float:
        """Bytes one All-to-All moves off-device: b*k tokens of M dims,
        (ep-1)/ep of which cross links."""
        return (self.b * self.k * self.m * self.dtype_bytes
                * (self.ep - 1) / self.ep)

    @property
    def v_mem(self) -> float:
        """Bytes of one T_DI host copy (paper's v0_mem = b*M)."""
        return self.b * self.k * self.m * self.dtype_bytes


def _q_scaled(strategy: Strategy, w: MoEWorkload):
    """Rescale Table II's q3 (which assumes H=4M) to the real H/M ratio,
    and q1 for gated experts (3 GEMMs instead of 2 in forward)."""
    (q1f, q2f, q3f), (q1b, q2b, q3b) = Q_TABLE[strategy]
    ratio = w.h / w.m / 4.0
    # q3 decomposes as [T_DI copies] + 4*[T_M copies]
    t_m_f = {Strategy.S1: 4, Strategy.S2: 4}.get(strategy, 0)
    t_di_f = q3f - t_m_f
    q3f = t_di_f + t_m_f * ratio
    t_m_b = t_m_f
    t_di_b = q3b - t_m_b
    q3b = t_di_b + t_m_b * ratio
    if w.gated:
        q1f, q1b = q1f * 1.5, q1b * 1.5
    return (q1f, q2f, q3f), (q1b, q2b, q3b)


def stream_times(strategy: Strategy, w: MoEWorkload, hw: HardwareSpec,
                 n_partitions: int = 1) -> Dict[str, float]:
    """Per-stream seconds for forward+backward of one MoE layer."""
    (q1f, q2f, q3f), (q1b, q2b, q3b) = _q_scaled(strategy, w)
    mu = hw.mu(strategy)
    eta = hw.eta(strategy)
    sigma = hw.interference.sigma
    comp = (q1f + q1b) * w.v_comp / (sigma * hw.flops)
    comm = (q2f + q2b) * w.v_comm / (mu * hw.ici_bw)
    mem = (q3f + q3b) * w.v_mem / (eta * hw.host_bw)
    # kernel-launch / collective-launch overhead grows with granularity
    ops_per_chunk = (q1f + q2f + q3f + q1b + q2b + q3b)
    overhead = n_partitions * ops_per_chunk * hw.launch_overhead_s
    return {"comp": comp, "comm": comm, "mem": mem, "overhead": overhead}


def cost(strategy: Strategy, w: MoEWorkload, hw: HardwareSpec,
         n_partitions: int = 1) -> float:
    """Eq. 10: pipeline time = slowest stream (+ launch overhead)."""
    t = stream_times(strategy, w, hw, n_partitions)
    return max(t["comp"], t["comm"], t["mem"]) + t["overhead"]


def select_strategy(w: MoEWorkload, hw: HardwareSpec,
                    n_partitions: int = 1,
                    allow: Optional[list] = None) -> Strategy:
    """Adaptive selection (§III-E): cheapest of the four memory-reusing
    strategies (reuse is MPipeMoE's point — NONE is the PipeMoE ablation,
    selectable explicitly), host-capacity aware; ties broken toward lower
    memory footprint."""
    cands = list(allow) if allow else [Strategy.S1, Strategy.S2,
                                       Strategy.S3, Strategy.S4]
    if not hw.has_host_offload:
        cands = [s for s in cands if not s.needs_host]
    if not cands:
        cands = [Strategy.S4]
    order = {Strategy.S4: 0, Strategy.S2: 1, Strategy.S3: 2,
             Strategy.S1: 3, Strategy.NONE: 4}
    best = min(cands, key=lambda s: (cost(s, w, hw, n_partitions),
                                     order[s]))
    return best


def all_costs(w: MoEWorkload, hw: HardwareSpec,
              n_partitions: int = 1) -> Dict[str, float]:
    return {s.value: cost(s, w, hw, n_partitions) for s in Strategy}
