"""Paged KV cache: the host-side page allocator over the device page
pools — the single-device (one shard) part of ``repro.serve.paged_kv``.

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

Cross-request prefix cache (``prefix_cache=True``): every page carries a
refcount (the slots binding it, +1 while it is published in the prefix
trie), and a trie over **full-page token keys** maps the exact
``page_size`` token ids of logical page i, under the path of the pages
before it, to the physical page holding their K/V. Admission
(:meth:`alloc_slot_prefix`) binds the longest published prefix of the
prompt instead of recomputing it (``lens`` starts at the hit length, so
prefill runs the tail only), capped at ``len(prompt) - 1`` so at least
one token prefills to give the first sample's logits. The cap can end
mid-page, so the tail's first write may target a shared page:
:meth:`ensure_private` copies it on the device into a fresh page
(``models.kv_cache.copy_pages``, in place, on the stream the next step
runs on) or, when the pool is dry and the trie is the only other
referent, *steals* the entry (detaches it) instead. Retiring or
finishing prefill publishes the slot's written full pages
(:meth:`cache_slot_prefix`). A page frees only at refcount zero:
preemption (both modes) drops the victim's references, so a page that
another slot or the trie holds is never recycled. Eviction is LRU over
trie entries that no slot references (:meth:`_evict_one`), on demand
when an allocation finds the free list empty; ``free_pages`` therefore
counts free plus evictable pages. Several page-table rows may then
point at one physical page: the decode kernels only read through them.
With ``prefix_cache=False`` (the default) refcounts stay at most 1, the
trie stays empty and every path reduces to the refcount-free allocator:
the same free-list order and the same page tables.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import kv_cache
from repro_torch.serve.state_cache import StateCache, StaticInput

__all__ = ["PagedKVCache"]

SINK_PAGE = 0


class _TrieNode:
    """One published full page of the prefix trie: ``key`` is the exact
    ``page_size`` token ids at this depth (as bytes: content is the
    hash), ``page`` the physical page holding their K/V, ``tick`` the
    last match or publish time (LRU eviction order). The root is a
    keyless sentinel with ``page == -1``."""
    __slots__ = ("key", "page", "parent", "children", "tick")

    def __init__(self, key: bytes, page: int,
                 parent: Optional["_TrieNode"]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[bytes, "_TrieNode"] = {}
        self.tick = 0


class PagedKVCache(StateCache):
    kind = "paged"

    def __init__(self, cfg: ArchConfig, *, num_pages: int, page_size: int,
                 max_slots: int, max_pages_per_seq: int,
                 dtype=torch.bfloat16, device="cpu",
                 prefix_cache: bool = False):
        """``num_pages=0`` sizes the pool to the worst case: every slot's
        full ``max_pages_per_seq`` budget plus the sink page.
        ``prefix_cache=True`` turns on cross-request prefix reuse (see
        the module docstring)."""
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

        # -- cross-request prefix cache --------------------------------
        # refcount per physical page: the slots binding it, +1 while it
        # is published in the trie; the free pages are exactly those at 0
        self.prefix_enabled = bool(prefix_cache)
        self._refs = np.zeros(self.num_pages, np.int32)
        self._root = _TrieNode(b"", -1, None)
        self._node_of_page: Dict[int, _TrieNode] = {}
        self._tick = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.prefix_evicted_pages = 0
        self.prefix_cow_copies = 0
        self.prefix_cow_bytes = 0

    # -- budget ----------------------------------------------------------
    def pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)

    @property
    def free_pages(self) -> int:
        """*Allocatable* pages: the free list plus trie-only pages (no
        slot references them) that eviction reclaims on demand. The
        free list's length with the prefix cache off."""
        return len(self._free) + self._reclaimable()

    @property
    def free_units(self) -> int:
        return self.free_pages

    @property
    def capacity_pages(self) -> int:
        """Allocatable pages (the sink is reserved)."""
        return self.num_pages - 1

    @property
    def used_pages(self) -> int:
        """*Physical* occupancy: pages not on the free list. A page that
        several slots and the trie share counts once."""
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

    def _take_page(self) -> Optional[int]:
        """Pop a free page, evicting least-recently-matched trie-only
        entries when the free list runs dry. None when the pool is truly
        dry (the caller preempts)."""
        while not self._free:
            if not self._evict_one():
                return None
        page = self._free.pop()
        assert self._refs[page] == 0, f"free page {page} has references"
        self._refs[page] = 1
        return page

    def _release_page(self, page: int) -> None:
        """Drop one reference; a page frees only at refcount zero, so a
        page that another slot or the trie still holds is never
        recycled."""
        refs = int(self._refs[page]) - 1
        assert refs >= 0, f"double free of page {page}"
        self._refs[page] = refs
        if refs == 0:
            self._free.append(page)

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
        pages = [self._take_page() for _ in range(self.pages_for(tokens))]
        assert None not in pages, "the pool ran dry mid-alloc"
        self._bind(slot, pages, 0)

    def slot_page_count(self, slot: int) -> int:
        return len(self._slot_pages[slot])

    def slot_capacity(self, slot: int) -> int:
        return len(self._slot_pages[slot]) * self.page_size

    def held_bytes(self, slot: int) -> int:
        """Bytes this slot holds *exclusively*. With the prefix cache on
        a page shared with another slot is attributed to no slot
        (``used_pages`` counts it once); a page the slot shares only
        with the trie still counts as the slot's."""
        if not self.prefix_enabled:
            return self.slot_page_count(slot) * self.page_bytes
        mine = sum(
            1 for p in self._slot_pages[slot]
            if int(self._refs[p]) - (p in self._node_of_page) == 1)
        return mine * self.page_bytes

    def grow_slot(self, slot: int) -> bool:
        """Bind one more page; False when the pool is dry."""
        held = self._slot_pages[slot]
        assert len(held) < self.max_pages_per_seq, \
            f"slot {slot} grew past its per-sequence page budget"
        page = self._take_page()
        if page is None:
            return False
        self.page_table[slot, len(held)] = page
        held.append(page)
        self._note_peak()
        return True

    def free_slot(self, slot: int) -> None:
        for page in reversed(self._slot_pages[slot]):
            self._release_page(page)
        self._slot_pages[slot] = []
        self.page_table[slot, :] = SINK_PAGE
        self.lens[slot] = 0

    # -- preempt-by-offload ----------------------------------------------
    def offload_slot(self, slot: int, rid: int) -> int:
        """Swap the slot's pages out to host memory (keyed by request id)
        and release them. Only the pages covering ``lens[slot]`` are
        copied: growth can run ahead of a chunk that was then preempted
        away, and those tail pages hold nothing worth saving. A page
        that the trie or another slot holds loses this slot's reference
        only. Returns bytes copied."""
        pages = self._slot_pages[slot]
        need = self.pages_for(int(self.lens[slot]))
        assert pages and need >= 1, f"offload of empty slot {slot}"
        assert rid not in self._offloaded, f"rid {rid} already offloaded"
        assert need <= len(pages), \
            f"slot {slot} holds {len(pages)} pages < lens needs {need}"
        for page in reversed(pages[need:]):     # trim unwritten growth
            self._release_page(page)
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
        released at offload time, so no page table changes."""
        del self._offloaded[rid]

    def restore_slot(self, rid: int, slot: int, tokens: int) -> int:
        """Swap a preempted request's pages back in: take fresh pages
        (the table re-maps; no prefix hit is looked for), copy the host
        contents into the pools in place, and rebind the slot at length
        ``tokens``. Returns bytes copied."""
        host, need = self._offloaded[rid]
        # validate before popping: a refused restore keeps the pages
        assert not self._slot_pages[slot], f"slot {slot} already allocated"
        assert need <= self.free_pages, "restore_slot without can_restore"
        assert self.pages_for(tokens) == need, \
            f"restore of {tokens} tokens into {need} pages"
        del self._offloaded[rid]
        pages = [self._take_page() for _ in range(need)]
        assert None not in pages, "the pool ran dry mid-restore"
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

    # -- cross-request prefix cache --------------------------------------
    def _page_keys(self, token_ids) -> List[bytes]:
        """Full-page content keys: the exact ``page_size`` token ids of
        each fully covered page, as int32 bytes."""
        ids = np.ascontiguousarray(np.asarray(token_ids, np.int32))
        ps = self.page_size
        return [ids[i * ps:(i + 1) * ps].tobytes()
                for i in range(len(ids) // ps)]

    def _walk(self, keys: Sequence[bytes]) -> List[_TrieNode]:
        """Longest-prefix match: the published trie nodes for the
        leading full pages of ``keys``."""
        node, path = self._root, []
        for key in keys:
            child = node.children.get(key)
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def _reclaimable(self) -> int:
        """Trie-held pages no slot references: evictable on demand,
        hence allocatable."""
        return sum(1 for p in self._node_of_page if self._refs[p] == 1)

    def _detach(self, node: _TrieNode) -> int:
        """Unpublish ``node``'s whole subtree (children key on the full
        path, so they cannot outlive it). Slot-bound descendants lose the
        trie's reference only; unreferenced ones free. Returns the pages
        whose trie reference was dropped."""
        del node.parent.children[node.key]
        node.parent = None
        stack, dropped = [node], 0
        while stack:
            cur = stack.pop()
            stack.extend(cur.children.values())
            cur.children = {}
            del self._node_of_page[cur.page]
            self._release_page(cur.page)
            dropped += 1
        return dropped

    def _evict_one(self) -> bool:
        """Evict the least-recently-matched trie entry that no slot
        references (refcount 1: the trie only); frees >= 1 page. False
        when nothing is evictable."""
        victim = None
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if self._refs[node.page] == 1 and \
                    (victim is None or node.tick < victim.tick):
                victim = node
        if victim is None:
            return False
        self.prefix_evicted_pages += self._detach(victim)
        return True

    def match_prefix(self, token_ids, total_tokens: int
                     ) -> Tuple[Optional[int], int]:
        """Hit probe: ``(0, cached_tokens)`` when the trie holds a
        published prefix of ``token_ids`` and the rest of the
        ``total_tokens`` reservation still fits beside it, else
        ``(None, 0)`` (the caller then admits by :meth:`can_admit`).
        Read-only: :meth:`alloc_slot_prefix` binds."""
        if not self.prefix_enabled or len(token_ids) < 2:
            return None, 0
        need = self.pages_for(total_tokens)
        if need > self.max_pages_per_seq or \
                total_tokens > self.max_pages_per_seq * self.page_size:
            return None, 0
        path = self._walk(self._page_keys(token_ids))
        cached = min(len(path) * self.page_size, len(token_ids) - 1)
        if cached <= 0:
            return None, 0
        bound = self.pages_for(cached)
        # fresh pages still needed (+1 when the hit ends mid-page: that
        # shared page is copied on write before the tail writes into it)
        fresh = need - bound + (1 if cached % self.page_size else 0)
        avail = (len(self._free) + self._reclaimable()
                 - sum(1 for n in path[:bound] if self._refs[n.page] == 1))
        if fresh > avail:
            return None, 0
        return 0, cached

    def alloc_slot_prefix(self, slot: int, tokens: int, token_ids,
                          *, page_aligned: bool = False) -> int:
        """Admission with prefix reuse: bind the longest published
        prefix of ``token_ids`` (refcount +1 a hit page: their K/V is
        not recomputed), then take fresh pages for the rest of the
        ``tokens`` reservation. Returns the cached token count; the
        caller starts prefill there. The hit is capped at
        ``len(token_ids) - 1`` so the tail is never empty (the last
        prefill chunk gives the first sample's logits).

        ``page_aligned=True`` (the full-reserve scheduler) floors the hit
        to a page boundary: the tail then never writes a shared page, so
        a fully reserved slot never needs a copy-on-write page beyond its
        reservation."""
        if not self.prefix_enabled:
            self.alloc_slot(slot, tokens)
            return 0
        assert not self._slot_pages[slot], f"slot {slot} already allocated"
        path = self._walk(self._page_keys(token_ids))
        cached = min(len(path) * self.page_size, len(token_ids) - 1)
        if page_aligned:
            cached -= cached % self.page_size
        if cached <= 0:
            self.prefix_misses += 1
            self.alloc_slot(slot, tokens)
            return 0
        bound = self.pages_for(cached)
        path = path[:bound]
        # bind the hits *first*: a refcount >= 2 shields them (and their
        # ancestors) from the evictions the fresh takes below may run
        self._tick += 1
        for node in path:
            self._refs[node.page] += 1
            node.tick = self._tick
        pages = [node.page for node in path]
        for _ in range(self.pages_for(tokens) - bound):
            page = self._take_page()
            assert page is not None, \
                "alloc_slot_prefix without match_prefix feasibility"
            pages.append(page)
        self._bind(slot, pages, cached)
        self.prefix_hits += 1
        self.prefix_hit_tokens += cached
        return cached

    def cache_slot_prefix(self, slot: int, token_ids) -> None:
        """Publish the slot's written full pages into the trie (one trie
        reference each). Idempotent: pages already published under the
        same token path are only tick-refreshed. Only pages fully
        covered by both ``lens[slot]`` and ``token_ids`` qualify: a
        partial page is still being written."""
        if not self.prefix_enabled or not self._slot_pages[slot]:
            return
        n_tok = min(len(token_ids), int(self.lens[slot]))
        keys = self._page_keys(np.asarray(token_ids, np.int32)[:n_tok])
        self._tick += 1
        node = self._root
        for i, key in enumerate(keys):
            child = node.children.get(key)
            if child is None:
                page = self._slot_pages[slot][i]
                if page in self._node_of_page:
                    # already published elsewhere (a copy-on-write copy of
                    # a still cached page): never index a page twice
                    break
                child = _TrieNode(key, page, node)
                node.children[key] = child
                self._node_of_page[page] = child
                self._refs[page] += 1
            child.tick = self._tick
            node = child

    def ensure_private(self, slot: int, tokens: int) -> bool:
        """Copy-on-write: make every page that the next writes (through
        token position ``tokens``) land in exclusive to this slot. A
        shared page is copied on the device into a fresh page (the trie
        and other slots keep the original); when no copy target can be
        had and the trie is the only other referent, the entry is
        *stolen* (detached) instead: no copy, and the reason a sole
        request always makes progress. False only when another slot
        shares the page and no page can be freed: the engine then
        preempts a victim and retries. The copy goes on the current
        stream, before the step that writes, and the page table changes
        on the host only: the next step's inputs carry it."""
        if not self.prefix_enabled:
            return True
        pages = self._slot_pages[slot]
        lo = int(self.lens[slot]) // self.page_size
        hi = min(self.pages_for(tokens), len(pages))
        idx = [i for i in range(lo, hi) if self._refs[pages[i]] > 1]
        if not idx:
            return True
        copies: List[Tuple[int, int, int]] = []    # (pos, shared, fresh)
        for i in idx:
            page = pages[i]
            node = self._node_of_page.get(page)
            fresh = self._take_page()
            if fresh is None:
                if node is not None and int(self._refs[page]) == 2:
                    # dry, but only the trie shares it: steal the entry
                    self.prefix_evicted_pages += self._detach(node)
                    continue
                for _, _, taken in copies:   # roll back this call's takes
                    self._release_page(taken)
                return False
            copies.append((i, page, fresh))
        if copies:
            kv_cache.copy_pages(self.pools, [c[1] for c in copies],
                                [c[2] for c in copies])
            for i, shared, fresh in copies:
                pages[i] = fresh
                self.page_table[slot, i] = fresh
                self._release_page(shared)
            self.prefix_cow_copies += len(copies)
            self.prefix_cow_bytes += len(copies) * self.page_bytes
            self._note_peak()
        return True

    @property
    def prefix_cached_pages(self) -> int:
        """Pages currently published in the trie."""
        return len(self._node_of_page)

    @property
    def prefix_shared_pages(self) -> int:
        """Pages with more than one referent."""
        return int(np.count_nonzero(self._refs >= 2))

    def record_metrics(self, registry) -> None:
        super().record_metrics(registry)
        self.record_shard_metrics(registry)

    def record_shard_metrics(self, registry) -> None:
        """The paged gauges per shard (one shard, label "0") and, with
        the prefix cache on, the prefix cache's, as the JAX package's
        ``PagedKVCache.record_shard_metrics``. Host-side counts only."""
        free = registry.gauge("repro_kv_free_pages",
                              "free KV pages per shard", ["shard"])
        held = registry.gauge("repro_kv_held_bytes",
                              "resident KV bytes per shard", ["shard"])
        free.labels(shard=0).set(self.free_pages)
        held.labels(shard=0).set(self.used_pages * self.page_bytes)
        if not self.prefix_enabled:
            return
        g = registry.gauge
        g("repro_prefix_cached_pages", "pages published in the prefix trie",
          ["shard"]).labels(shard=0).set(self.prefix_cached_pages)
        g("repro_prefix_shared_pages", "pages with more than one referent",
          ["shard"]).labels(shard=0).set(self.prefix_shared_pages)
        g("repro_prefix_hits",
          "prefix-cache admission hits").set(self.prefix_hits)
        g("repro_prefix_misses",
          "prefix-cache admission misses").set(self.prefix_misses)
        g("repro_prefix_hit_tokens",
          "prompt tokens served from the prefix cache"
          ).set(self.prefix_hit_tokens)
        g("repro_prefix_evicted_pages",
          "trie references dropped by eviction/steal"
          ).set(self.prefix_evicted_pages)
        g("repro_prefix_cow_copies",
          "copy-on-write page duplications").set(self.prefix_cow_copies)
        g("repro_prefix_cow_bytes",
          "bytes duplicated by copy-on-write").set(self.prefix_cow_bytes)

    def check_integrity(self) -> None:
        """Refcount audit (a test hook): every page is free (refcount 0,
        on the free list exactly once), the reserved sink, or referenced
        with a refcount equal to its referents (binding slots + trie);
        the trie agrees with ``_node_of_page``. Raises AssertionError on
        any leak, double free or double booking."""
        refs = np.zeros(self.num_pages, np.int64)
        assert len(set(self._free)) == len(self._free), "free-list dupes"
        assert SINK_PAGE not in self._free, "sink page freed"
        for pages in self._slot_pages:
            for p in pages:
                refs[p] += 1
        n_nodes = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            n_nodes += 1
            assert self._node_of_page.get(node.page) is node, \
                f"trie index out of sync for page {node.page}"
            refs[node.page] += 1
        assert n_nodes == len(self._node_of_page), \
            "orphaned trie index entries"
        free = set(self._free)
        for p in range(self.num_pages):
            assert int(self._refs[p]) == int(refs[p]), \
                f"page {p}: refcount {int(self._refs[p])} != " \
                f"{int(refs[p])} referents"
            if p == SINK_PAGE:
                assert refs[p] == 0, f"sink page {p} bound"
            elif refs[p] == 0:
                assert p in free, f"page {p} leaked"
            else:
                assert p not in free, f"page {p} double-booked"

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
