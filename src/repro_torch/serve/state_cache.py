"""The ``StateCache`` protocol: per-request device state behind one
slot-indexed surface, so ``Engine`` and ``Scheduler`` never see a
concrete cache — the single-device part of ``repro.serve.state_cache``.

What the engine needs from "the cache": slot lifecycle (``alloc_slot``
/ ``grow_slot`` / ``free_slot`` and the host ``lens`` array), admission
budgeting (``admissible``, ``can_admit``, ``held_bytes``), preemption
by offload (``offload_slot`` / ``restore_slot`` / ``can_restore`` /
``drop_offload``: the slot's state parked in host memory), the prefix
cache (``match_prefix``, ``alloc_slot_prefix``, ``cache_slot_prefix``,
``ensure_private``: no-op defaults here), the step inputs (``pools``;
prefill's ``device_page_table``, ``device_lens``, ``sink_row``; decode's
``decode_inputs``), byte accounting and the telemetry gauges
(``record_metrics``). The one implementation here is
:class:`~repro_torch.serve.paged_kv.PagedKVCache`; the constant-state
and composite caches come with ROADMAP.md's 'Other architectures'
slice.

The decode step's inputs are :class:`StaticInput` buffers: device
tensors whose addresses never change, refreshed in place every step, so
a CUDA graph captured over them stays valid. Prefill makes fresh
tensors, since it runs eagerly.
"""
from __future__ import annotations

import abc
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["StateCache", "StaticInput"]


class StaticInput:
    """A device tensor that keeps its address while each step refreshes
    its contents from host data. On the card the data goes through a
    pinned staging tensor and an asynchronous copy on the current stream;
    before the staging tensor is written again, the host waits for the
    previous copy to have read it. On the CPU the copy is synchronous."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        self.tensor = torch.zeros(shape, dtype=dtype, device=device)
        cuda = self.tensor.device.type == "cuda"
        self._stage = torch.zeros(shape, dtype=dtype, pin_memory=cuda)
        self._copied = torch.cuda.Event() if cuda else None

    def refresh(self, host: np.ndarray) -> torch.Tensor:
        if self._copied is not None:
            self._copied.synchronize()
        # the copy into the stage is the host's own: torch.from_numpy
        # would alias arrays the engine mutates in place
        self._stage.numpy()[...] = host
        self.tensor.copy_(self._stage, non_blocking=True)
        if self._copied is not None:
            self._copied.record()
        return self.tensor


class StateCache(abc.ABC):
    """Abstract per-request device-state cache (see module docstring).

    The base class owns the slot count, the device, and the host
    ``lens`` array the engine mutates in place.
    """

    kind: str = "abstract"
    swap_out_bytes: int = 0            # cumulative offload traffic
    swap_in_bytes: int = 0             # cumulative restore traffic

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

    # -- preemption snapshot / restore ------------------------------------
    @abc.abstractmethod
    def offload_slot(self, slot: int, rid: int) -> int:
        """Snapshot the slot's state to host memory (keyed by request
        id), release the device side. Returns bytes copied."""

    @abc.abstractmethod
    def restore_slot(self, rid: int, slot: int, tokens: int) -> int:
        """Restore a parked request onto ``slot`` at length ``tokens``.
        Returns bytes copied."""

    @abc.abstractmethod
    def can_restore(self, rid: int) -> bool:
        """Is there room to restore the parked request now?"""

    @abc.abstractmethod
    def drop_offload(self, rid: int) -> None:
        """Discard a parked request's host snapshot (it will never
        resume); its device state was released at ``offload_slot``."""

    @property
    @abc.abstractmethod
    def offloaded_count(self) -> int:
        """Requests currently parked in host memory."""

    @property
    @abc.abstractmethod
    def host_bytes(self) -> int:
        """Bytes currently parked in host memory."""

    # -- cross-request prefix cache ----------------------------------------
    # No-op defaults, so the engine and scheduler never ask which cache
    # they hold: a cache without shareable page state never reports a
    # hit. PagedKVCache overrides them (refcounted pages, a trie,
    # copy-on-write) when built with ``prefix_cache=True``.

    prefix_enabled: bool = False
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefix_hit_tokens: int = 0
    prefix_evicted_pages: int = 0
    prefix_cow_copies: int = 0
    prefix_cow_bytes: int = 0
    prefix_cached_pages: int = 0
    prefix_shared_pages: int = 0

    def match_prefix(self, token_ids, total_tokens: int
                     ) -> Tuple[Optional[int], int]:
        """``(shard, cached_tokens)`` of a usable cached prefix of
        ``token_ids`` for a request of ``total_tokens``, or ``(None,
        0)`` on a miss (admission then goes by :meth:`can_admit`)."""
        return None, 0

    def alloc_slot_prefix(self, slot: int, tokens: int, token_ids,
                          *, page_aligned: bool = False) -> int:
        """:meth:`alloc_slot` that binds the longest cached prefix of
        ``token_ids`` instead of reserving it afresh. Returns the prefix
        tokens already cached (``lens[slot]`` is set to it): 0 here.
        ``page_aligned`` floors the hit to a page boundary, so no shared
        page is ever written (the full-reserve scheduler)."""
        self.alloc_slot(slot, tokens)
        return 0

    def cache_slot_prefix(self, slot: int, token_ids) -> None:
        """Publish the slot's written full pages into the prefix index
        (``token_ids``: the tokens written so far). A no-op here."""

    def ensure_private(self, slot: int, tokens: int) -> bool:
        """Make positions ``lens[slot]:tokens`` writable without touching
        state shared with other requests (copy-on-write). False when no
        page can be had for the copy: the caller preempts a victim and
        retries, as after :meth:`grow_slot`."""
        return True

    # -- step inputs -------------------------------------------------------
    def _upload(self, host: np.ndarray) -> torch.Tensor:
        # always copy first: torch.from_numpy is zero-copy, and the engine
        # mutates page_table/lens in place while an asynchronous
        # host-to-device copy may still be reading them
        return torch.from_numpy(host.copy()).to(self.device)

    def device_lens(self, slot: int) -> torch.Tensor:
        """One slot's ``[1]`` row of ``lens``, a fresh device tensor."""
        return self._upload(self.lens[slot:slot + 1])

    @abc.abstractmethod
    def device_page_table(self, slot: int) -> torch.Tensor:
        """One slot's ``[1, W]`` int32 page-table row, a fresh tensor."""

    @abc.abstractmethod
    def decode_inputs(self, sink_only: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The decode step's page table ``[max_slots, W]``, lens
        ``[max_slots]`` (int32) and per-slot sinks ``[max_slots]``: the
        same device tensors every call, refreshed in place from the host
        state (``sink_only``: every row mapped to the sink, lens 0)."""

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

    @property
    @abc.abstractmethod
    def free_units(self) -> int:
        """Free allocation units (pages for a paged cache)."""

    def record_metrics(self, registry) -> None:
        """Refresh this cache's point-in-time gauges into a
        ``repro_torch.obs`` registry (family registration is idempotent),
        with the JAX package's families. Called on demand (by
        ``Engine.stats()`` and the ``/metrics`` exporter's refresh hook),
        never per step. Every value is a host-side count: no tensor is
        read, so the exporter thread makes no CUDA call. Subclasses
        extend it through ``super()``."""
        g = registry.gauge
        g("repro_kv_cache_bytes",
          "allocated device state bytes").set(self.cache_bytes)
        g("repro_kv_used_bytes",
          "state bytes bound to live sequences").set(self.used_bytes)
        g("repro_kv_host_bytes",
          "bytes parked in the host offload pool").set(self.host_bytes)
        g("repro_kv_offloaded_requests",
          "requests parked in the host pool").set(self.offloaded_count)
        g("repro_swap_out_bytes",
          "cumulative device-to-host offload traffic").set(
            self.swap_out_bytes)
        g("repro_swap_in_bytes",
          "cumulative host-to-device restore traffic").set(
            self.swap_in_bytes)
        g("repro_kv_free_units",
          "free cache units (pages or slots) per shard",
          ["shard"]).labels(shard=0).set(self.free_units)
