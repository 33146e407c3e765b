"""Paged KV cache: the host-side page allocator over the device page
pools — the single-device, prefix-free part of ``repro.serve.paged_kv``.

Device side (``models/kv_cache.init_paged_pools``): per attention layer
a global pool ``[num_pages, page_size, kv_heads, head_dim]`` for K and
for V. Host side (this module): a numpy free list of physical pages, a
``[max_slots, max_pages_per_seq]`` page table and per-slot lengths,
copied to the device each step as int32 tensors (the decode step's into
persistent buffers, ``decode_inputs``). Preempt-by-offload parks a
slot's written pages in host memory, keyed by request id, and restores
them into fresh pages (``offload_slot`` / ``restore_slot``).

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

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import kv_cache
from repro_torch.serve.state_cache import StateCache, StaticInput

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
        self._cache_bytes = kv_cache.tree_bytes(self.pools)
        # popping from the end hands out the lowest page first
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self.page_table = np.full((self.max_slots, self.max_pages_per_seq),
                                  SINK_PAGE, np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in
                                             range(self.max_slots)]
        self.peak_used_pages = 0
        # rid -> (host pages, page count)
        self._offloaded: Dict[int, Tuple[list, int]] = {}
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0
        # the decode step's inputs, at fixed device addresses
        self._decode_table = StaticInput(self.page_table.shape, torch.int32,
                                         self.device)
        self._decode_lens = StaticInput(self.lens.shape, torch.int32,
                                        self.device)
        self._sinks = torch.full((self.max_slots,), SINK_PAGE,
                                 dtype=torch.int32, device=self.device)

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

    def _bind(self, slot: int, pages: List[int], tokens: int) -> None:
        self._slot_pages[slot] = pages
        self.page_table[slot, :] = SINK_PAGE
        self.page_table[slot, :len(pages)] = pages
        self.lens[slot] = tokens
        self._note_peak()

    def alloc_slot(self, slot: int, tokens: int) -> None:
        """Reserve ``pages_for(tokens)`` pages for ``slot``."""
        assert not self._slot_pages[slot], f"slot {slot} already allocated"
        assert self.can_admit(tokens), "alloc_slot without can_admit"
        self._bind(slot, [self._free.pop()
                          for _ in range(self.pages_for(tokens))], 0)

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

    # -- preempt-by-offload ----------------------------------------------
    def offload_slot(self, slot: int, rid: int) -> int:
        """Swap the slot's pages out to host memory (keyed by request id)
        and free them. Only the pages covering ``lens[slot]`` are copied:
        growth can run ahead of a chunk that was then preempted away, and
        those tail pages hold nothing worth saving. Returns bytes
        copied."""
        pages = self._slot_pages[slot]
        need = self.pages_for(int(self.lens[slot]))
        assert pages and need >= 1, f"offload of empty slot {slot}"
        assert rid not in self._offloaded, f"rid {rid} already offloaded"
        assert need <= len(pages), \
            f"slot {slot} holds {len(pages)} pages < lens needs {need}"
        self._free.extend(reversed(pages[need:]))   # trim unwritten growth
        pages = self._slot_pages[slot] = pages[:need]
        host = kv_cache.extract_pages(self.pools, pages)
        nbytes = kv_cache.tree_bytes(host)
        self._offloaded[rid] = (host, len(pages))
        self.swap_out_bytes += nbytes
        self.free_slot(slot)
        return nbytes

    def offloaded_pages(self, rid: int) -> int:
        return self._offloaded[rid][1]

    def can_restore(self, rid: int) -> bool:
        return self._offloaded[rid][1] <= self.free_pages

    def drop_offload(self, rid: int) -> None:
        """Discard a parked request's host pages; its device pages were
        freed at offload time, so no page table changes."""
        del self._offloaded[rid]

    def restore_slot(self, rid: int, slot: int, tokens: int) -> int:
        """Swap a preempted request's pages back in: take fresh pages
        (the table re-maps), copy the host contents into the pools in
        place, and rebind the slot at length ``tokens``. Returns bytes
        copied."""
        host, need = self._offloaded[rid]
        # validate before popping: a refused restore keeps the pages
        assert not self._slot_pages[slot], f"slot {slot} already allocated"
        assert need <= self.free_pages, "restore_slot without can_restore"
        assert self.pages_for(tokens) == need, \
            f"restore of {tokens} tokens into {need} pages"
        del self._offloaded[rid]
        pages = [self._free.pop() for _ in range(need)]
        kv_cache.insert_pages(self.pools, pages, host)
        self._bind(slot, pages, tokens)
        nbytes = kv_cache.tree_bytes(host)
        self.swap_in_bytes += nbytes
        return nbytes

    @property
    def offloaded_count(self) -> int:
        return len(self._offloaded)

    @property
    def host_bytes(self) -> int:
        """Bytes currently parked in host memory."""
        return sum(kv_cache.tree_bytes(host)
                   for host, _ in self._offloaded.values())

    # -- step inputs -----------------------------------------------------
    def device_page_table(self, slot: int) -> torch.Tensor:
        return self._upload(self.page_table[slot:slot + 1])

    def decode_inputs(self, sink_only: bool = False):
        table, lens = self.page_table, self.lens
        if sink_only:
            table, lens = np.full_like(table, SINK_PAGE), np.zeros_like(lens)
        return (self._decode_table.refresh(table),
                self._decode_lens.refresh(lens), self._sinks)

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
