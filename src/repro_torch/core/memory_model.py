"""Analytic memory models: MoE layer footprint + serving preemption cost,
a copy of ``repro.core.memory_model`` (the formulas as they are, the
negative ``phi`` of Eq. 5 at n = 1 included).

:class:`MoEMemory` is the paper's footprint model of an MoE layer
(Eqs. 1–6). All quantities in *elements* by default (paper convention);
multiply by ``bytes_per`` for bytes. B is the token batch, M model dim,
H hidden dim, E experts, n pipeline partitions.

:class:`PreemptionCost` extends the same capacity-vs-bandwidth trade to
the serving engine's state cache: when capacity runs dry, a victim
request is preempted either by *recompute* (drop its cached state, pay
the re-prefill FLOPs again) or by *offload* (round-trip its bytes over
the host link — the serving analogue of strategies S1–S3's activation
offload). The selector mirrors the paper's Eq. 7–10 structure: compare
seconds of redundant compute against seconds of host-link copies, masked
by hardware capability (no host offload ⇒ recompute only).

The same model covers both cache geometries behind the ``StateCache``
protocol (``repro_torch.serve.state_cache``). For a **paged** KV cache
``bytes_held`` grows linearly with ``tokens_cached`` (pages x page
bytes), so both sides of the trade scale with sequence length and the
offload/recompute choice is roughly length-independent. For a
**constant-state** cache (recurrent mixers: mamba / xLSTM) ``bytes_held``
is one fixed slot row regardless of how many tokens were absorbed into
it — recompute cost still grows with ``tokens_cached`` while offload
cost is flat, so past :func:`crossover_tokens` offload always wins.
That asymmetry is the quantitative reason recurrent models preempt so
cheaply: an O(1) snapshot buys back an O(len) re-prefill.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEMemory:
    b: int
    m: int
    h: int
    e: int
    n: int = 4
    bytes_per: float = 4.0
    optimizer_states: int = 4      # params + grads + adam m + adam v

    # -- Eq. 1: model states -------------------------------------------
    @property
    def m_ms(self) -> float:
        return self.optimizer_states * (self.e * self.m
                                        + 2 * self.h * self.m)

    # -- Eq. 2: activations (T_I, T_DI, T_DO, T_O are (B,M); T_M is (B,H))
    @property
    def m_act(self) -> float:
        return 4 * self.b * self.m + self.b * self.h

    # -- Eq. 3: temporary buffers (two adjacent gradient tensors live)
    @property
    def m_buf(self) -> float:
        return self.b * self.m + self.b * self.h

    # -- Eq. 4: with pipelining, peak temp = activations of the pipeline
    @property
    def m_buf_pipe(self) -> float:
        return self.m_act_pipe

    @property
    def m_act_pipe(self) -> float:
        return 4 * self.b * self.m + self.b * self.h

    # -- Eq. 5: savings from sharing partition buffers.
    # T_DI and T_DO shrink from m to 2m/n (double buffer), T_M to m/n.
    @property
    def delta_act(self) -> float:
        return self.b * (2 * self.m * (self.n - 2) / self.n
                         + self.h * (self.n - 1) / self.n)

    @property
    def delta_buf(self) -> float:
        return self.delta_act

    # -- Eq. 6: saving ratio -------------------------------------------
    @property
    def phi(self) -> float:
        return ((self.delta_act + self.delta_buf)
                / (self.m_ms + self.m_act_pipe + self.m_buf_pipe))

    # -- convenience ----------------------------------------------------
    def totals(self) -> dict:
        scale = self.bytes_per
        return {
            "model_states": self.m_ms * scale,
            "activations": self.m_act * scale,
            "temp_buffers": self.m_buf * scale,
            "act_reused": (self.m_act - self.delta_act) * scale,
            "buf_reused": (self.m_buf_pipe - self.delta_buf) * scale,
            "phi": self.phi,
        }


@dataclasses.dataclass(frozen=True)
class PreemptionCost:
    """Offload-vs-recompute decision for one preemption victim.

    * recompute: free the victim's KV pages now (cost ~0) and re-prefill
      its ``tokens_cached`` tokens at resume — pay the forward FLOPs once
      more, at ``mfu`` fraction of device peak;
    * offload: copy ``bytes_held`` of pages to host now and back at
      resume — pay ``2 * bytes / host_bw``, degraded by the memcpy
      interference factor ``eta`` (paper Fig. 3) and divided across
      ``link_shards`` concurrent swap streams.

    Both costs are *added latency for this request*; the engine picks the
    argmin per victim, gated by host-offload capability.

    Per-shard capacity (DP-sharded KV pools): with the pool split into
    ``dp`` independent per-device shards, pool-dry — and therefore
    preemption — fires per shard, so up to ``dp`` victims can be
    swapping over the one host link at once. ``link_shards`` models that
    contention: the effective per-victim link bandwidth is
    ``host_bw / link_shards``, which shifts the crossover toward
    recompute as the machine scales out. With replicated pools (one
    logical shard) it is 1 and the single-link model is recovered exactly.
    """
    tokens_cached: int
    bytes_held: int
    flops_per_token: float       # forward FLOPs per token (~2 x active P)
    flops: float                 # device peak FLOP/s
    host_bw: float               # host link B/s
    mfu: float = 0.5             # achieved fraction of peak at re-prefill
    eta: float = 0.95            # memcpy interference (Interference.eta)
    link_shards: int = 1         # KV shards contending for the host link

    @property
    def recompute_s(self) -> float:
        return self.tokens_cached * self.flops_per_token \
            / max(self.flops * self.mfu, 1.0)

    @property
    def offload_s(self) -> float:
        bw = self.host_bw * self.eta / max(self.link_shards, 1)
        return 2.0 * self.bytes_held / max(bw, 1.0)

    @property
    def choice(self) -> str:
        return "offload" if self.offload_s < self.recompute_s \
            else "recompute"


def crossover_tokens(bytes_held: float, flops_per_token: float,
                     flops: float, host_bw: float, *, mfu: float = 0.5,
                     eta: float = 0.95, link_shards: int = 1) -> float:
    """Cached-token count above which offloading ``bytes_held`` beats
    recomputing the prefill (``offload_s < recompute_s`` in
    :class:`PreemptionCost`, solved for ``tokens_cached``).

    For a constant-state cache ``bytes_held`` is the fixed per-slot state
    size, so this is a single number per model: every victim longer than
    it should offload. For a paged cache ``bytes_held`` itself grows with
    the sequence, so the comparison must be re-evaluated per victim —
    which is exactly what the engine does.
    """
    bw = host_bw * eta / max(link_shards, 1)
    seconds_per_token = flops_per_token / max(flops * mfu, 1.0)
    return (2.0 * bytes_held / max(bw, 1.0)) / max(seconds_per_token,
                                                   1e-30)
