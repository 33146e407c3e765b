"""Memory-reuse strategies (paper Table II), as ``Strategy`` in
``repro.core.types``. The rest of that module (hardware specs, the
Q-vectors of the analytic core) comes with ROADMAP.md's 'Adaptive
(n, strategy)' slice."""
from __future__ import annotations

import enum
from typing import Tuple


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
