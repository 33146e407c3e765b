"""Core types, a copy of ``repro.core.types``: the memory-reuse
strategies (paper Table II), their Q-vectors and the hardware specs the
analytic core plans for.

The specs are those of the devices the port meets: ``GPU_H100``, the
port's card and the default of :class:`HardwareSpec`; ``GPU_A100`` and
``CPU_HOST`` as the JAX package defines them. ``resolve_hw("auto")``
asks ``torch.cuda`` where the JAX package asks its backend.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Tuple


class Strategy(enum.Enum):
    """How the overwritten ``T_DI`` (dispatched input) and ``T_M``
    (expert hidden) tensors are restored in the backward pass."""
    NONE = "none"   # keep activations on device (no reuse)
    S1 = "s1"       # T_DI: offload      T_M: offload
    S2 = "s2"       # T_DI: re-comm      T_M: offload
    S3 = "s3"       # T_DI: offload      T_M: recompute
    S4 = "s4"       # T_DI: re-comm      T_M: recompute

    @property
    def offloads(self) -> Tuple[str, ...]:
        return {"none": (), "s1": ("t_di", "t_m"), "s2": ("t_m",),
                "s3": ("t_di",), "s4": ()}[self.value]

    @property
    def saves(self) -> Tuple[str, ...]:
        return {"none": ("t_di", "t_m"), "s1": (), "s2": (),
                "s3": (), "s4": ()}[self.value]

    @property
    def needs_host(self) -> bool:
        return bool(self.offloads)


# Q-vectors from Table II: units of (v0_comp, v0_comm, v0_mem) per
# (forward, backward). q3 counts T_M copies as 4x (H = 4M convention);
# the perf model rescales for the actual H/M ratio. The port restores
# T_M by recompute under every strategy (``core/strategies.py``), so the
# T_M host terms of S1/S2 count traffic the port does not move; the
# table stays the paper's, as the reference model's is.
Q_TABLE: Dict[Strategy, Tuple[Tuple[int, int, int], Tuple[int, int, int]]] = {
    Strategy.NONE: ((2, 2, 0), (4, 2, 0)),
    Strategy.S1:   ((2, 2, 5), (4, 2, 5)),
    Strategy.S2:   ((2, 2, 4), (4, 3, 4)),
    Strategy.S3:   ((2, 2, 1), (5, 2, 1)),
    Strategy.S4:   ((2, 2, 0), (5, 3, 0)),
}


@dataclasses.dataclass(frozen=True)
class Interference:
    """Slowdown factors (paper Fig. 3), the paper's values. mu: comm
    slowdown, eta: memcpy slowdown, sigma: compute slowdown."""
    mu_comp: float = 0.85        # comm speed while compute runs
    mu_all: float = 0.70         # comm speed with compute + memcpy
    eta_all: float = 0.60        # memcpy speed with comm + compute
    eta_comp: float = 0.95       # memcpy speed with compute only
    sigma: float = 1.0


# One NVIDIA H100 80GB HBM3 at a 700.00 W power limit. eta_comp and sigma
# come from chip_smoke.py's ``eta_sigma``: one train chunk's T_DI
# (3.9 MB) copied between pinned host memory and the card on a side
# stream under the expert-shape bf16 GEMM, and that GEMM under the
# copies. mu (comm under compute) needs a second rank, which one card
# does not have: mu_comp, mu_all and eta_all (a copy beside comm) stay
# the paper's values, unmeasured on the H100.
H100_INTERFERENCE = Interference(
    mu_comp=0.85,                # paper Fig. 3; not measured (one rank)
    mu_all=0.70,                 # paper Fig. 3; not measured (one rank)
    eta_all=0.60,                # paper Fig. 3; not measured (one rank)
    eta_comp=0.9436,             # chip_smoke.py eta_sigma, H100 80GB
                                 # HBM3 at 700.00 W
    sigma=0.9743,                # chip_smoke.py eta_sigma, H100 80GB
                                 # HBM3 at 700.00 W
)


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Device rates the analytic core plans with. The defaults are one
    NVIDIA H100 SXM5 80GB (``GPU_H100``)."""
    name: str = "gpu-h100"
    flops: float = 989e12             # H100 SXM5 80GB, 700 W datasheet:
                                      # bf16 dense tensor-core FLOP/s
    hbm_bw: float = 3.35e12           # H100 SXM5 80GB datasheet: HBM3 B/s
    ici_bw: float = 450e9             # H100 SXM5 80GB datasheet: NVLink 4,
                                      # 900 GB/s both ways, 450 GB/s each
    host_bw: float = 49.63e9          # chip_smoke.py eta_sigma, H100 80GB
                                      # HBM3 at 700.00 W: pinned host <->
                                      # card copy B/s (3.9 MB each way)
    hbm_bytes: float = 80e9           # H100 SXM5 80GB datasheet
    has_host_offload: bool = True     # pinned host memory (TdiStash)
    launch_overhead_s: float = 6.746e-6  # chip_smoke.py eta_sigma, H100
                                      # 80GB HBM3 at 700.00 W: host seconds
                                      # of one eager launch
    interference: Interference = dataclasses.field(
        default=H100_INTERFERENCE)

    def mu(self, strategy: Strategy) -> float:
        i = self.interference
        return i.mu_all if strategy.needs_host else i.mu_comp

    def eta(self, strategy: Strategy) -> float:
        i = self.interference
        # S1/S2 copy while comm is also active -> eta_all
        return i.eta_all if strategy in (Strategy.S1, Strategy.S2) \
            else i.eta_comp


GPU_H100 = HardwareSpec()

# The JAX package's rough public-datasheet specs, field for field: the
# perf model only needs ratios of compute : interconnect : host bandwidth
# to rank (n, strategy) choices.
GPU_A100 = HardwareSpec(name="gpu-a100", flops=312e12, hbm_bw=2039e9,
                        ici_bw=300e9, host_bw=32e9, hbm_bytes=80e9,
                        has_host_offload=True, launch_overhead_s=3e-6,
                        interference=Interference())
CPU_HOST = HardwareSpec(name="cpu-host", flops=1e12, hbm_bw=50e9,
                        ici_bw=10e9, host_bw=10e9, hbm_bytes=16e9,
                        has_host_offload=False, launch_overhead_s=3e-6,
                        interference=Interference())

HW_SPECS: Dict[str, HardwareSpec] = {
    "gpu-h100": GPU_H100,
    "gpu-a100": GPU_A100,
    "cpu-host": CPU_HOST,
}


def resolve_hw(name: str = "auto") -> HardwareSpec:
    """Named :class:`HardwareSpec`, or ``"auto"``: ``gpu-h100`` when
    ``torch.cuda`` has a device, else ``cpu-host``."""
    if name != "auto":
        try:
            return HW_SPECS[name]
        except KeyError:
            raise KeyError(f"unknown hw {name!r}; one of "
                           f"{sorted(HW_SPECS)} or 'auto'") from None
    import torch

    return GPU_H100 if torch.cuda.is_available() else CPU_HOST
