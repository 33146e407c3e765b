"""Paged KV cache: the host-side page allocator over the device page
pools — the single-device, prefix-free part of ``repro.serve.paged_kv``.

Device side (``models/kv_cache.init_paged_pools``): per attention layer
a global pool ``[num_pages, page_size, kv_heads, head_dim]`` for K and
for V. Host side (this module): a numpy free list of physical pages, a
``[max_slots, max_pages_per_seq]`` page table and per-slot lengths,
copied to the device each step as int32 tensors.

Invariants:
* page 0 is reserved — never allocated — as the write sink for masked
  (padding / inactive-slot) scatters;
* pages are allocated **up front** for a slot's whole reservation
  (``alloc_slot``) or **on demand** one page at a time (``grow_slot``,
  where a dry pool makes the engine preempt instead of deadlock);
* a freed slot's page-table row is reset to the sink, so its stale
  decode writes land in the sink, never in pages handed to another
  sequence.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import kv_cache
from repro_torch.serve.state_cache import StateCache

__all__ = ["PagedKVCache"]

SINK_PAGE = 0


class PagedKVCache(StateCache):
    kind = "paged"

    def __init__(self, cfg: ArchConfig, *, num_pages: int, page_size: int,
                 max_slots: int, max_pages_per_seq: int,
                 dtype=torch.bfloat16, device="cpu"):
        """``num_pages=0`` sizes the pool to the worst case: every slot's
        full ``max_pages_per_seq`` budget plus the sink page."""
        super().__init__(max_slots=max_slots, device=device)
        self.page_size = int(page_size)
        self.max_pages_per_seq = int(max_pages_per_seq)
        if num_pages == 0:
            num_pages = self.max_slots * self.max_pages_per_seq + 1
        self.num_pages = max(int(num_pages), 2)   # sink + >= 1 real page

        self.pools = kv_cache.init_paged_pools(cfg, self.num_pages,
                                               self.page_size, dtype,
                                               self.device)
        self._cache_bytes = kv_cache.pools_bytes(self.pools)
        # popping from the end hands out the lowest page first
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self.page_table = np.full((self.max_slots, self.max_pages_per_seq),
                                  SINK_PAGE, np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in
                                             range(self.max_slots)]
        self.peak_used_pages = 0

    # -- budget ----------------------------------------------------------
    def pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def capacity_pages(self) -> int:
        """Allocatable pages (the sink is reserved)."""
        return self.num_pages - 1

    @property
    def used_pages(self) -> int:
        return self.capacity_pages - len(self._free)

    @property
    def max_slot_tokens(self) -> int:
        """Per-request ceiling: the per-sequence page budget, or the whole
        pool, whichever binds first."""
        return self.page_size * min(self.max_pages_per_seq,
                                    self.capacity_pages)

    def can_admit(self, total_tokens: int) -> bool:
        need = self.pages_for(total_tokens)
        return (need <= self.free_pages
                and need <= self.max_pages_per_seq
                and total_tokens <= self.max_pages_per_seq * self.page_size)

    # -- slot lifecycle --------------------------------------------------
    def _note_peak(self) -> None:
        self.peak_used_pages = max(self.peak_used_pages, self.used_pages)

    def alloc_slot(self, slot: int, tokens: int) -> None:
        """Reserve ``pages_for(tokens)`` pages for ``slot``."""
        assert not self._slot_pages[slot], f"slot {slot} already allocated"
        assert self.can_admit(tokens), "alloc_slot without can_admit"
        pages = [self._free.pop() for _ in range(self.pages_for(tokens))]
        self._slot_pages[slot] = pages
        self.page_table[slot, :] = SINK_PAGE
        self.page_table[slot, :len(pages)] = pages
        self.lens[slot] = 0
        self._note_peak()

    def slot_page_count(self, slot: int) -> int:
        return len(self._slot_pages[slot])

    def slot_capacity(self, slot: int) -> int:
        return len(self._slot_pages[slot]) * self.page_size

    def held_bytes(self, slot: int) -> int:
        return self.slot_page_count(slot) * self.page_bytes

    def grow_slot(self, slot: int) -> bool:
        """Bind one more page; False when the pool is dry."""
        held = self._slot_pages[slot]
        assert len(held) < self.max_pages_per_seq, \
            f"slot {slot} grew past its per-sequence page budget"
        if not self._free:
            return False
        page = self._free.pop()
        self.page_table[slot, len(held)] = page
        held.append(page)
        self._note_peak()
        return True

    def free_slot(self, slot: int) -> None:
        self._free.extend(reversed(self._slot_pages[slot]))
        self._slot_pages[slot] = []
        self.page_table[slot, :] = SINK_PAGE
        self.lens[slot] = 0

    # -- step inputs -----------------------------------------------------
    def device_page_table(self, slot: Optional[int] = None) -> torch.Tensor:
        if slot is None:
            return self._upload(self.page_table)
        return self._upload(self.page_table[slot:slot + 1])

    def device_sinks(self) -> torch.Tensor:
        return self._upload(np.full((self.max_slots,), SINK_PAGE, np.int32))

    def sink_row(self, slot: int) -> torch.Tensor:
        return self._upload(np.asarray([SINK_PAGE], np.int32))

    def sink_page_table(self) -> torch.Tensor:
        """A ``[1, max_pages_per_seq]`` page-table row that maps every
        position to the sink page: a probe's KV writes all land there."""
        return self._upload(np.full((1, self.max_pages_per_seq), SINK_PAGE,
                                    np.int32))

    # -- accounting ------------------------------------------------------
    @property
    def cache_bytes(self) -> int:
        return self._cache_bytes

    @property
    def page_bytes(self) -> int:
        """Bytes of one page across all layers."""
        return self._cache_bytes // self.num_pages

    @property
    def used_bytes(self) -> int:
        return self.used_pages * self.page_bytes

    @property
    def peak_used_bytes(self) -> int:
        return self.peak_used_pages * self.page_bytes
