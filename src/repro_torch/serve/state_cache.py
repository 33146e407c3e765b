"""The ``StateCache`` protocol: per-request device state behind one
slot-indexed surface, so ``Engine`` and ``Scheduler`` never see a
concrete cache — the single-device part of ``repro.serve.state_cache``.

What the engine needs from "the cache": slot lifecycle (``alloc_slot``
/ ``grow_slot`` / ``free_slot`` and the host ``lens`` array), admission
budgeting (``admissible``, ``can_admit``, ``held_bytes``), the step
inputs (``pools``, ``device_page_table``, ``device_lens``,
``device_sinks``, ``sink_row``) and byte accounting. The one
implementation here is :class:`~repro_torch.serve.paged_kv.PagedKVCache`;
the constant-state and composite caches come with ROADMAP.md's 'Other
architectures' slice, host offload with 'Offload and auto preemption'.
"""
from __future__ import annotations

import abc
from typing import Optional

import numpy as np
import torch

__all__ = ["StateCache"]


class StateCache(abc.ABC):
    """Abstract per-request device-state cache (see module docstring).

    The base class owns the slot count, the device, and the host
    ``lens`` array the engine mutates in place.
    """

    kind: str = "abstract"

    def __init__(self, *, max_slots: int, device):
        self.max_slots = int(max_slots)
        self.device = torch.device(device)
        self.lens = np.zeros((self.max_slots,), np.int32)

    # -- admission budget ------------------------------------------------
    @property
    @abc.abstractmethod
    def max_slot_tokens(self) -> int:
        """The most tokens any single slot can ever hold."""

    def admissible(self, total_tokens: int) -> bool:
        """Could a request of ``total_tokens`` ever be served?"""
        return 0 < int(total_tokens) <= self.max_slot_tokens

    @abc.abstractmethod
    def can_admit(self, total_tokens: int) -> bool:
        """Can ``total_tokens`` be reserved now?"""

    # -- slot lifecycle ---------------------------------------------------
    @abc.abstractmethod
    def alloc_slot(self, slot: int, tokens: int) -> None:
        """Bind ``slot`` with capacity for ``tokens``; lens resets to 0."""

    @abc.abstractmethod
    def grow_slot(self, slot: int) -> bool:
        """Extend the slot's capacity by one unit; False when dry."""

    @abc.abstractmethod
    def free_slot(self, slot: int) -> None:
        """Release the slot's state; lens resets to 0."""

    @abc.abstractmethod
    def slot_capacity(self, slot: int) -> int:
        """Tokens the slot can hold with its current reservation."""

    @abc.abstractmethod
    def held_bytes(self, slot: int) -> int:
        """Device bytes a preemption of this slot would release."""

    # -- step inputs -------------------------------------------------------
    def _upload(self, host: np.ndarray) -> torch.Tensor:
        # always copy first: torch.from_numpy is zero-copy, and the engine
        # mutates page_table/lens in place while an asynchronous
        # host-to-device copy may still be reading them
        return torch.from_numpy(host.copy()).to(self.device)

    def device_lens(self, slot: Optional[int] = None) -> torch.Tensor:
        """Device copy of ``lens`` (one slot's ``[1]`` row when given)."""
        if slot is None:
            return self._upload(self.lens)
        return self._upload(self.lens[slot:slot + 1])

    @abc.abstractmethod
    def device_page_table(self, slot: Optional[int] = None) -> torch.Tensor:
        """``[max_slots, W]`` (decode) or ``[1, W]`` (one slot) int32."""

    @abc.abstractmethod
    def device_sinks(self) -> torch.Tensor:
        """Per-slot masked-write sink ids ``[max_slots]`` for decode."""

    @abc.abstractmethod
    def sink_row(self, slot: int) -> torch.Tensor:
        """``[1]`` sink id for one slot's prefill chunk."""

    # -- accounting --------------------------------------------------------
    @property
    @abc.abstractmethod
    def cache_bytes(self) -> int:
        """Device bytes of the cache (constant)."""

    @property
    @abc.abstractmethod
    def used_bytes(self) -> int:
        """Bytes currently bound to live requests."""

    @property
    @abc.abstractmethod
    def peak_used_bytes(self) -> int:
        """High-water mark of ``used_bytes``."""
