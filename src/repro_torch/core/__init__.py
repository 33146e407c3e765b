"""MPipeMoE core on one device, as ``repro.core``: the analytic models
(``memory_model`` Eqs. 1–6 and the serving :class:`PreemptionCost`,
``perf_model`` Eqs. 7–10, ``pipeline_sim``), the runtime knob resolvers
(``granularity`` Algorithm 1, ``selector`` — one-shot :func:`resolve`
and the persistent :class:`Resolver`), the memory-reuse strategies S1–S4
(``strategies``) and the pipelined MoE layer itself (``pipeline_moe``).
"""
from repro_torch.core.granularity import GranularitySearcher
from repro_torch.core.memory_model import (MoEMemory, PreemptionCost,
                                           crossover_tokens)
from repro_torch.core.perf_model import (MoEWorkload, all_costs, cost,
                                         select_strategy, stream_times)
from repro_torch.core.pipeline_moe import capacity_for, pipelined_moe
from repro_torch.core.pipeline_sim import simulate, sweep_partitions
from repro_torch.core.selector import (Resolver, make_searcher,
                                       moe_workload, resolve,
                                       resolve_strategy)
from repro_torch.core.strategies import host_offload_supported, wrap_chunk
from repro_torch.core.types import (CPU_HOST, GPU_A100, GPU_H100, HW_SPECS,
                                    Q_TABLE, HardwareSpec, Interference,
                                    Strategy, resolve_hw)

__all__ = [
    "CPU_HOST", "GPU_A100", "GPU_H100", "GranularitySearcher", "HW_SPECS",
    "MoEMemory", "MoEWorkload", "PreemptionCost", "Q_TABLE", "HardwareSpec",
    "Interference", "Resolver", "Strategy", "all_costs", "capacity_for",
    "cost", "crossover_tokens", "host_offload_supported", "make_searcher",
    "moe_workload", "pipelined_moe", "resolve", "resolve_hw",
    "resolve_strategy", "select_strategy", "simulate", "stream_times",
    "sweep_partitions", "wrap_chunk",
]
