"""The ``StateCache`` protocol: per-request device state behind one
slot-indexed surface, so ``Engine`` and ``Scheduler`` never see a
concrete cache — the paged part of ``repro.serve.state_cache``.

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

Shard topology (``kv_sharding``, the JAX module's ``:79-125``): slots
partition over ``n_shards`` — the mesh's dp extent under ``"dp"``, else
1, or the ``shards=`` override that tests the allocator without ranks —
and round up to a multiple of it; slot ``i`` belongs to shard ``i //
slots_per_shard`` (``shard_of_slot``, ``slots_of``). Placement asks
``can_admit(total, shard)`` and ``best_shard``. Over ranks (``dist``, a
``DistContext``) the host state is the same on every rank and every
rank makes the same calls; under ``"dp"`` with more than one shard this
rank's device pools hold only the pages of its shard ``local_shard``
(``dist.dp_rank``) and it decodes only that shard's slots
(``decode_rows``). Otherwise ``local_shard`` is None: the pools hold
every page and every slot is decoded.

The decode step's inputs are :class:`StaticInput` buffers: device
tensors whose addresses never change, refreshed in place every step, so
a CUDA graph captured over them stays valid. Prefill makes fresh
tensors, since it runs eagerly.
"""
from __future__ import annotations

import abc
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["KV_SHARDINGS", "StateCache", "StaticInput"]

KV_SHARDINGS = ("replicated", "dp")


def _round_up(x: int, mult: int) -> int:
    return -(-int(x) // mult) * mult


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

    The base class owns the shard topology, the slot count, the device,
    and the host ``lens`` array the engine mutates in place.
    """

    kind: str = "abstract"
    swap_out_bytes: int = 0            # cumulative offload traffic
    swap_in_bytes: int = 0             # cumulative restore traffic

    def __init__(self, *, max_slots: int, device, dist=None,
                 kv_sharding: str = "replicated", shards: int = 0):
        if kv_sharding not in KV_SHARDINGS:
            raise ValueError(f"kv_sharding must be one of {KV_SHARDINGS}")
        self.dist = dist
        self.kv_sharding = kv_sharding
        if shards:
            n_shards = int(shards)
        elif kv_sharding == "dp" and dist is not None:
            n_shards = dist.dp_size
        else:
            n_shards = 1
        self.n_shards = max(1, n_shards)
        # slots round up to the shard count so the shards split evenly
        self.max_slots = _round_up(max_slots, self.n_shards)
        self.slots_per_shard = self.max_slots // self.n_shards
        # the shard whose pages this rank's pools hold (None: all pages)
        self.local_shard = (dist.dp_rank if dist is not None
                            and kv_sharding == "dp" and self.n_shards > 1
                            else None)
        self.device = torch.device(device)
        self.lens = np.zeros((self.max_slots,), np.int32)

    # -- shard topology ----------------------------------------------------
    def shard_of_slot(self, slot: int) -> int:
        """Owning shard of ``slot`` (0 under the replicated layout)."""
        return slot // self.slots_per_shard

    def slots_of(self, shard: int) -> range:
        """The contiguous slot-id range owned by ``shard``."""
        return range(shard * self.slots_per_shard,
                     (shard + 1) * self.slots_per_shard)

    @property
    def decode_rows(self) -> range:
        """The slots this rank's decode step computes: its shard's under
        ``"dp"`` over ranks, else every slot."""
        if self.local_shard is None:
            return range(self.max_slots)
        return self.slots_of(self.local_shard)

    # -- admission budget ------------------------------------------------
    @property
    @abc.abstractmethod
    def max_slot_tokens(self) -> int:
        """The most tokens any single slot can ever hold."""

    def admissible(self, total_tokens: int) -> bool:
        """Could a request of ``total_tokens`` ever be served?"""
        return 0 < int(total_tokens) <= self.max_slot_tokens

    @abc.abstractmethod
    def can_admit(self, total_tokens: int,
                  shard: Optional[int] = None) -> bool:
        """Can ``total_tokens`` be reserved now, on ``shard``, or on the
        shard with the most room when None?"""

    @abc.abstractmethod
    def best_shard(self, total_tokens: int,
                   candidates: Optional[Sequence[int]] = None
                   ) -> Optional[int]:
        """Least-loaded placement among ``candidates`` (default: every
        shard); None when no shard fits."""

    # -- slot lifecycle ---------------------------------------------------
    @abc.abstractmethod
    def alloc_slot(self, slot: int, tokens: int) -> None:
        """Bind ``slot`` with capacity for ``tokens``; lens resets to 0."""

    @abc.abstractmethod
    def grow_slot(self, slot: int) -> bool:
        """Extend the slot's capacity by one unit; False when the slot's
        shard is dry."""

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
        """Restore a parked request onto ``slot`` of its own shard (the
        placement is sticky) at length ``tokens``. Returns bytes
        copied."""

    @abc.abstractmethod
    def can_restore(self, rid: int) -> bool:
        """Does the parked request's shard have room to restore now?"""

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

    def match_prefix(self, token_ids, total_tokens: int,
                     candidates: Optional[Sequence[int]] = None
                     ) -> Tuple[Optional[int], int]:
        """``(shard, cached_tokens)`` of the best usable cached prefix of
        ``token_ids`` for a request of ``total_tokens`` among
        ``candidates`` (default: every shard), or ``(None, 0)`` on a miss
        (placement then goes by :meth:`best_shard`)."""
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
        """One slot's ``[1, W]`` int32 page-table row in this rank's page
        ids, a fresh tensor."""

    @abc.abstractmethod
    def decode_inputs(self, sink_only: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The decode step's page table ``[R, W]``, lens ``[R]`` (int32)
        and per-slot sinks ``[R]`` of the ``R`` slots of
        :attr:`decode_rows`, in this rank's page ids: the same device
        tensors every call, refreshed in place from the host state
        (``sink_only``: every row mapped to the sink, lens 0)."""

    @abc.abstractmethod
    def sink_row(self, slot: int) -> torch.Tensor:
        """``[1]`` sink id, in this rank's page ids, for one slot's
        prefill chunk."""

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
    def per_device_cache_bytes(self) -> int:
        """State bytes resident on one device."""

    @property
    @abc.abstractmethod
    def per_device_peak_used_bytes(self) -> int:
        """Peak bytes resident on one device (the busiest shard's under
        ``"dp"``)."""

    @property
    @abc.abstractmethod
    def free_units(self) -> int:
        """Free allocation units (pages for a paged cache)."""

    @abc.abstractmethod
    def free_units_of(self, shard: int) -> int:
        """Free allocation units on one shard."""

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
        fam = g("repro_kv_free_units",
                "free cache units (pages or slots) per shard", ["shard"])
        for s in range(self.n_shards):
            fam.labels(shard=s).set(self.free_units_of(s))
