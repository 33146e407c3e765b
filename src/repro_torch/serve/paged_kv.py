"""Paged KV cache: the host-side page allocator over the device page
pools, as ``repro.serve.paged_kv``.

Device side (``models/kv_cache.init_paged_pools``): per attention layer
a pool ``[pages, page_size, kv_heads, head_dim]`` for K and for V (MLA:
the latent pools). Host side (this module): per-shard free lists of
physical pages, a ``[max_slots, max_pages_per_seq]`` page table and
per-slot lengths, copied to the device each step as int32 tensors (the
decode step's into persistent buffers, ``decode_inputs``).
Preempt-by-offload parks a slot's written pages in host memory, keyed by
request id, and restores them into fresh pages of the same shard
(``offload_slot`` / ``restore_slot``).

Invariants, per shard (one shard, or ``dp`` shards under
``kv_sharding="dp"``):
* each shard's local page 0 is reserved, never allocated, as the write
  sink for that shard's masked (padding / inactive-slot) scatters; in
  global ids those are pages ``s * pages_per_shard``;
* pages are allocated **up front** for a slot's whole reservation
  (``alloc_slot``) or **on demand** one page at a time (``grow_slot``,
  where a dry shard makes the engine preempt a victim on that shard);
* a slot binds pages of its own shard only (slot ``i`` lives on shard
  ``i // slots_per_shard``), so no decode read or write crosses a shard;
* a freed slot's page-table row is reset to its shard's sink, so its
  stale decode writes land in the sink, never in pages handed to
  another sequence;
* an offloaded request holds no device page, and restores onto its own
  shard (placement is sticky for a request's life).

Over ranks (``dist``), the host state is the same on every rank: the
page table, free lists and tries hold **global** page ids, and every
rank makes the same calls. Under ``"dp"`` with more than one shard each
rank's pools hold only its shard's ``pages_per_shard`` pages (local id =
global id - ``shard * pages_per_shard``, local page 0 the sink), and
every device operation translates: the decode inputs are this shard's
rows in local ids, a prefill row of another shard's slot maps every
position to this rank's sink (only the owning shard's ranks write its
KV), and ``copy_pages``, offload's extract and restore's insert run on
the owning shard's ranks only (``_local``). Under ``"replicated"`` every
rank holds the whole pool and runs every device operation.
``cache_bytes`` / ``used_bytes`` are logical (every shard's pages);
``per_device_cache_bytes`` / ``per_device_peak_used_bytes`` what one
device holds.

Cross-request prefix cache (``prefix_cache=True``): every page carries a
refcount (the slots binding it, +1 while it is published in the prefix
trie), and each shard keeps a trie over **full-page token keys** that
maps the exact ``page_size`` token ids of logical page i, under the path
of the pages before it, to the physical page holding their K/V.
Admission (:meth:`alloc_slot_prefix`) binds the longest published prefix
of the prompt instead of recomputing it (``lens`` starts at the hit
length, so prefill runs the tail only), capped at ``len(prompt) - 1`` so
at least one token prefills to give the first sample's logits. The cap
can end mid-page, so the tail's first write may target a shared page:
:meth:`ensure_private` copies it on the device into a fresh page
(``models.kv_cache.copy_pages``, in place, on the stream the next step
runs on) or, when the shard is dry and the trie is the only other
referent, *steals* the entry (detaches it) instead. Retiring or
finishing prefill publishes the slot's written full pages
(:meth:`cache_slot_prefix`). A page frees only at refcount zero:
preemption (both modes) drops the victim's references, so a page that
another slot or the trie holds is never recycled. Eviction is LRU over a
shard's trie entries that no slot references (:meth:`_evict_one`), on
demand when an allocation finds the shard's free list empty;
``free_pages_of`` therefore counts free plus evictable pages.
:meth:`match_prefix` is the scheduler's cache-aware placement probe, so
hits are shard-local by construction. Several page-table rows may then
point at one physical page: the decode kernels only read through them.
With ``prefix_cache=False`` (the default) refcounts stay at most 1, the
tries stay empty and every path reduces to the refcount-free allocator.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import kv_cache
from repro_torch.serve.state_cache import StateCache, StaticInput, _round_up

__all__ = ["PagedKVCache"]

SINK_PAGE = 0          # each shard's sink: its local page 0


class _TrieNode:
    """One published full page of a shard's prefix trie: ``key`` is the
    exact ``page_size`` token ids at this depth (as bytes: content is
    the hash), ``page`` the physical page holding their K/V, ``tick``
    the last match or publish time (LRU eviction order). Each shard's
    root is a keyless sentinel with ``page == -1``."""
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
                 dtype=torch.bfloat16, device="cpu", dist=None,
                 kv_sharding: str = "replicated", shards: int = 0,
                 prefix_cache: bool = False):
        """``num_pages=0`` sizes the pool to the worst case: every slot's
        full ``max_pages_per_seq`` budget plus one sink page a shard.
        ``dist`` and ``kv_sharding`` place the pools over ranks and
        ``shards`` overrides the shard count (see the module docstring).
        ``prefix_cache=True`` turns on cross-request prefix reuse."""
        super().__init__(max_slots=max_slots, device=device, dist=dist,
                         kv_sharding=kv_sharding, shards=shards)
        self.page_size = int(page_size)
        self.max_pages_per_seq = int(max_pages_per_seq)
        if num_pages == 0:
            num_pages = self.max_slots * self.max_pages_per_seq \
                + self.n_shards
        # each shard needs its sink + >= 1 real page
        self.num_pages = max(_round_up(num_pages, self.n_shards),
                             2 * self.n_shards)
        self.pages_per_shard = self.num_pages // self.n_shards

        local_pages = (self.num_pages if self.local_shard is None
                       else self.pages_per_shard)
        self.pools = kv_cache.init_paged_pools(cfg, local_pages,
                                               self.page_size, dtype,
                                               self.device)
        self._page_bytes = kv_cache.tree_bytes(self.pools) // local_pages
        # per-shard free lists; popping from the end hands out a shard's
        # lowest page first, and its local page 0 is the sink
        self._free_by_shard: List[List[int]] = [
            list(range((s + 1) * self.pages_per_shard - 1,
                       s * self.pages_per_shard, -1))
            for s in range(self.n_shards)]
        self.page_table = np.zeros((self.max_slots, self.max_pages_per_seq),
                                   np.int32)
        for slot in range(self.max_slots):
            self.page_table[slot, :] = self.sink_page(
                self.shard_of_slot(slot))
        self._slot_pages: List[List[int]] = [[] for _ in
                                             range(self.max_slots)]
        self.peak_used_pages = 0
        self._peak_used_by_shard = [0] * self.n_shards
        # rid -> (host pages or None on another shard's ranks, page
        # count, owning shard)
        self._offloaded: Dict[int, Tuple[Optional[list], int, int]] = {}
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0
        # the decode step's inputs (this rank's rows), at fixed addresses
        rows = len(self.decode_rows)
        self._decode_table = StaticInput((rows, self.max_pages_per_seq),
                                         torch.int32, self.device)
        self._decode_lens = StaticInput((rows,), torch.int32, self.device)
        self._sinks = torch.as_tensor(
            [self._local_sink(self.shard_of_slot(s))
             for s in self.decode_rows], dtype=torch.int32).to(self.device)

        # -- cross-request prefix cache --------------------------------
        # refcount per physical page: the slots binding it, +1 while it
        # is published in a trie; the free pages are exactly those at 0
        self.prefix_enabled = bool(prefix_cache)
        self._refs = np.zeros(self.num_pages, np.int32)
        self._trie_roots: List[_TrieNode] = [
            _TrieNode(b"", -1, None) for _ in range(self.n_shards)]
        self._node_of_page: Dict[int, _TrieNode] = {}
        self._tick = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.prefix_evicted_pages = 0
        self.prefix_cow_copies = 0
        self.prefix_cow_bytes = 0

    # -- shard topology --------------------------------------------------
    def shard_of_page(self, page: int) -> int:
        return page // self.pages_per_shard

    def sink_page(self, shard: int) -> int:
        """The shard's reserved masked-write sink (its local page 0)."""
        return shard * self.pages_per_shard + SINK_PAGE

    @property
    def shard_capacity_pages(self) -> int:
        """Allocatable pages a shard (the sink is reserved)."""
        return self.pages_per_shard - 1

    def _local_sink(self, shard: int) -> int:
        """``shard``'s sink in this rank's page ids: local page 0 under
        ``"dp"`` over ranks (every rank's own sink), else global."""
        return (SINK_PAGE if self.local_shard is not None
                else self.sink_page(shard))

    def _local(self, pages: Sequence[int]) -> Optional[List[int]]:
        """Global page ids -> this rank's ids, or None when the pages
        live on another shard's ranks (this rank holds none of them and
        skips the device operation)."""
        if self.local_shard is None:
            return list(pages)
        base = self.local_shard * self.pages_per_shard
        if self.shard_of_page(pages[0]) != self.local_shard:
            return None
        return [p - base for p in pages]

    def _local_rows(self, table: np.ndarray) -> np.ndarray:
        """Page-table rows of this rank's shard -> local ids."""
        if self.local_shard is None:
            return table
        return table - self.local_shard * self.pages_per_shard

    # -- budget ----------------------------------------------------------
    def pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)

    def free_pages_of(self, shard: int) -> int:
        """*Allocatable* pages on ``shard``: the free list plus trie-only
        pages (no slot references them) that eviction reclaims on
        demand. The free list's length with the prefix cache off."""
        return len(self._free_by_shard[shard]) + self._reclaimable_of(shard)

    @property
    def _free(self) -> List[int]:
        """Every shard's free pages, flat (a read-only view)."""
        return [p for fl in self._free_by_shard for p in fl]

    @property
    def free_pages(self) -> int:
        return sum(self.free_pages_of(s) for s in range(self.n_shards))

    @property
    def free_units(self) -> int:
        return self.free_pages

    def free_units_of(self, shard: int) -> int:
        return self.free_pages_of(shard)

    @property
    def capacity_pages(self) -> int:
        """Allocatable pages over every shard (the sinks are reserved)."""
        return self.num_pages - self.n_shards

    @property
    def used_pages(self) -> int:
        """*Physical* occupancy: pages not on a free list. A page that
        several slots and the trie share counts once."""
        return self.capacity_pages - sum(len(fl) for fl in
                                         self._free_by_shard)

    def used_pages_of(self, shard: int) -> int:
        return self.shard_capacity_pages - len(self._free_by_shard[shard])

    @property
    def max_slot_tokens(self) -> int:
        """Per-request ceiling: the per-sequence page budget, or a whole
        shard's allocatable pages, whichever binds first."""
        return self.page_size * min(self.max_pages_per_seq,
                                    self.shard_capacity_pages)

    def can_admit(self, total_tokens: int,
                  shard: Optional[int] = None) -> bool:
        need = self.pages_for(total_tokens)
        free = (max(self.free_pages_of(s) for s in range(self.n_shards))
                if shard is None else self.free_pages_of(shard))
        return (need <= free
                and need <= self.max_pages_per_seq
                and total_tokens <= self.max_pages_per_seq * self.page_size)

    def best_shard(self, total_tokens: int,
                   candidates: Optional[Sequence[int]] = None
                   ) -> Optional[int]:
        """Among ``candidates`` (default: every shard), the one with the
        most free pages that can still admit ``total_tokens``; ties go
        to the lowest id. None when no shard fits."""
        cands = range(self.n_shards) if candidates is None else candidates
        best = None
        for s in cands:
            if not self.can_admit(total_tokens, s):
                continue
            if best is None or self.free_pages_of(s) > \
                    self.free_pages_of(best):
                best = s
        return best

    # -- slot lifecycle --------------------------------------------------
    def _note_peak(self, shard: int) -> None:
        self.peak_used_pages = max(self.peak_used_pages, self.used_pages)
        self._peak_used_by_shard[shard] = max(
            self._peak_used_by_shard[shard], self.used_pages_of(shard))

    def _take_page(self, shard: int) -> Optional[int]:
        """Pop a free page of ``shard``, evicting least-recently-matched
        trie-only entries when its free list runs dry. None when the
        shard is truly dry (the caller preempts)."""
        fl = self._free_by_shard[shard]
        while not fl:
            if not self._evict_one(shard):
                return None
        page = fl.pop()
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
            self._free_by_shard[self.shard_of_page(page)].append(page)

    def _bind(self, slot: int, pages: List[int], tokens: int) -> None:
        shard = self.shard_of_slot(slot)
        self._slot_pages[slot] = pages
        self.page_table[slot, :] = self.sink_page(shard)
        self.page_table[slot, :len(pages)] = pages
        self.lens[slot] = tokens
        self._note_peak(shard)

    def alloc_slot(self, slot: int, tokens: int) -> None:
        """Reserve ``pages_for(tokens)`` pages of the slot's shard."""
        assert not self._slot_pages[slot], f"slot {slot} already allocated"
        shard = self.shard_of_slot(slot)
        assert self.can_admit(tokens, shard), \
            f"alloc_slot without can_admit (shard {shard})"
        pages = [self._take_page(shard) for _ in range(self.pages_for(tokens))]
        assert None not in pages, f"shard {shard} ran dry mid-alloc"
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
        """Bind one more page of the slot's shard; False when that shard
        is dry (the caller preempts a victim on it)."""
        held = self._slot_pages[slot]
        assert len(held) < self.max_pages_per_seq, \
            f"slot {slot} grew past its per-sequence page budget"
        shard = self.shard_of_slot(slot)
        page = self._take_page(shard)
        if page is None:
            return False
        self.page_table[slot, len(held)] = page
        held.append(page)
        self._note_peak(shard)
        return True

    def free_slot(self, slot: int) -> None:
        for page in reversed(self._slot_pages[slot]):
            self._release_page(page)
        self._slot_pages[slot] = []
        self.page_table[slot, :] = self.sink_page(self.shard_of_slot(slot))
        self.lens[slot] = 0

    # -- preempt-by-offload ----------------------------------------------
    def offload_slot(self, slot: int, rid: int) -> int:
        """Swap the slot's pages out to host memory (keyed by request id)
        and release them to its shard. Only the pages covering
        ``lens[slot]`` are copied: growth can run ahead of a chunk that
        was then preempted away, and those tail pages hold nothing worth
        saving. A page that the trie or another slot holds loses this
        slot's reference only. Over ranks only the shard's own ranks copy
        (the others hold none of its pages). Returns bytes copied."""
        shard = self.shard_of_slot(slot)
        pages = self._slot_pages[slot]
        need = self.pages_for(int(self.lens[slot]))
        assert pages and need >= 1, f"offload of empty slot {slot}"
        assert rid not in self._offloaded, f"rid {rid} already offloaded"
        assert need <= len(pages), \
            f"slot {slot} holds {len(pages)} pages < lens needs {need}"
        for page in reversed(pages[need:]):     # trim unwritten growth
            self._release_page(page)
        pages = self._slot_pages[slot] = pages[:need]
        local = self._local(pages)
        host = (None if local is None
                else kv_cache.extract_pages(self.pools, local))
        nbytes = len(pages) * self.page_bytes
        self._offloaded[rid] = (host, len(pages), shard)
        self.swap_out_bytes += nbytes
        self.free_slot(slot)
        return nbytes

    def offloaded_pages(self, rid: int) -> int:
        return self._offloaded[rid][1]

    def offloaded_shard(self, rid: int) -> int:
        """The shard an offloaded request restores onto (sticky)."""
        return self._offloaded[rid][2]

    def can_restore(self, rid: int) -> bool:
        _, need, shard = self._offloaded[rid]
        return need <= self.free_pages_of(shard)

    def drop_offload(self, rid: int) -> None:
        """Discard a parked request's host pages; its device pages were
        released at offload time, so no page table changes."""
        del self._offloaded[rid]

    def restore_slot(self, rid: int, slot: int, tokens: int) -> int:
        """Swap a preempted request's pages back in: take fresh pages of
        its shard (the table re-maps; no prefix hit is looked for), copy
        the host contents into the pools in place on the shard's ranks,
        and rebind the slot at length ``tokens``. Returns bytes copied."""
        host, need, shard = self._offloaded[rid]
        # validate before popping: a refused restore keeps the pages
        assert not self._slot_pages[slot], f"slot {slot} already allocated"
        assert self.shard_of_slot(slot) == shard, \
            f"restore of rid {rid} onto slot {slot} (shard " \
            f"{self.shard_of_slot(slot)}) but its pages live on shard " \
            f"{shard}: placement is sticky"
        assert need <= self.free_pages_of(shard), \
            "restore_slot without can_restore"
        assert self.pages_for(tokens) == need, \
            f"restore of {tokens} tokens into {need} pages"
        del self._offloaded[rid]
        pages = [self._take_page(shard) for _ in range(need)]
        assert None not in pages, f"shard {shard} ran dry mid-restore"
        local = self._local(pages)
        if local is not None:
            kv_cache.insert_pages(self.pools, local, host)
        self._bind(slot, pages, tokens)
        nbytes = need * self.page_bytes
        self.swap_in_bytes += nbytes
        return nbytes

    @property
    def offloaded_count(self) -> int:
        return len(self._offloaded)

    @property
    def host_bytes(self) -> int:
        """Bytes currently parked in host memory (on the owning shard's
        ranks; the same count on every rank)."""
        return sum(n for _, n, _ in self._offloaded.values()) \
            * self.page_bytes

    # -- cross-request prefix cache --------------------------------------
    def _page_keys(self, token_ids) -> List[bytes]:
        """Full-page content keys: the exact ``page_size`` token ids of
        each fully covered page, as int32 bytes."""
        ids = np.ascontiguousarray(np.asarray(token_ids, np.int32))
        ps = self.page_size
        return [ids[i * ps:(i + 1) * ps].tobytes()
                for i in range(len(ids) // ps)]

    def _walk(self, shard: int, keys: Sequence[bytes]) -> List[_TrieNode]:
        """Longest-prefix match: the published trie nodes for the
        leading full pages of ``keys`` on ``shard``."""
        node, path = self._trie_roots[shard], []
        for key in keys:
            child = node.children.get(key)
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def _reclaimable_of(self, shard: int) -> int:
        """Trie-held pages of ``shard`` that no slot references:
        evictable on demand, hence allocatable."""
        if not self._node_of_page:
            return 0
        return sum(1 for p in self._node_of_page
                   if self._refs[p] == 1 and self.shard_of_page(p) == shard)

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

    def _evict_one(self, shard: int) -> bool:
        """Evict ``shard``'s least-recently-matched trie entry that no
        slot references (refcount 1: the trie only); frees >= 1 page.
        False when nothing on the shard is evictable."""
        victim = None
        stack = list(self._trie_roots[shard].children.values())
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

    def match_prefix(self, token_ids, total_tokens: int,
                     candidates: Optional[Sequence[int]] = None
                     ) -> Tuple[Optional[int], int]:
        """Cache-aware placement probe: among ``candidates`` (default:
        every shard), the shard holding the longest published prefix of
        ``token_ids`` where the rest of the ``total_tokens`` reservation
        still fits; ties go to the lowest id. ``(shard, cached_tokens)``,
        or ``(None, 0)`` on a miss (the caller then places by
        :meth:`best_shard`). Read-only: :meth:`alloc_slot_prefix`
        binds."""
        if not self.prefix_enabled or len(token_ids) < 2:
            return None, 0
        need = self.pages_for(total_tokens)
        if need > self.max_pages_per_seq or \
                total_tokens > self.max_pages_per_seq * self.page_size:
            return None, 0
        keys = self._page_keys(token_ids)
        best, best_cached = None, 0
        cands = range(self.n_shards) if candidates is None else candidates
        for s in cands:
            path = self._walk(s, keys)
            cached = min(len(path) * self.page_size, len(token_ids) - 1)
            if cached <= best_cached:
                continue
            bound = self.pages_for(cached)
            # fresh pages still needed (+1 when the hit ends mid-page:
            # that shared page is copied on write before the tail writes
            # into it)
            fresh = need - bound + (1 if cached % self.page_size else 0)
            avail = (len(self._free_by_shard[s]) + self._reclaimable_of(s)
                     - sum(1 for n in path[:bound]
                           if self._refs[n.page] == 1))
            if fresh > avail:
                continue
            best, best_cached = s, cached
        return best, best_cached

    def alloc_slot_prefix(self, slot: int, tokens: int, token_ids,
                          *, page_aligned: bool = False) -> int:
        """Admission with prefix reuse: bind the longest published
        prefix of ``token_ids`` on the slot's shard (refcount +1 a hit
        page: their K/V is not recomputed), then take fresh pages for
        the rest of the ``tokens`` reservation. Returns the cached token
        count; the caller starts prefill there. The hit is capped at
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
        shard = self.shard_of_slot(slot)
        path = self._walk(shard, self._page_keys(token_ids))
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
            page = self._take_page(shard)
            assert page is not None, \
                f"alloc_slot_prefix without match_prefix feasibility " \
                f"(shard {shard})"
            pages.append(page)
        self._bind(slot, pages, cached)
        self.prefix_hits += 1
        self.prefix_hit_tokens += cached
        return cached

    def cache_slot_prefix(self, slot: int, token_ids) -> None:
        """Publish the slot's written full pages into its shard's trie
        (one trie reference each). Idempotent: pages already published
        under the same token path are only tick-refreshed. Only pages
        fully covered by both ``lens[slot]`` and ``token_ids`` qualify: a
        partial page is still being written."""
        if not self.prefix_enabled or not self._slot_pages[slot]:
            return
        n_tok = min(len(token_ids), int(self.lens[slot]))
        keys = self._page_keys(np.asarray(token_ids, np.int32)[:n_tok])
        self._tick += 1
        node = self._trie_roots[self.shard_of_slot(slot)]
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
        shared page is copied on the device into a fresh page of the
        shard (the trie and other slots keep the original); when no copy
        target can be had and the trie is the only other referent, the
        entry is *stolen* (detached) instead: no copy, and the reason a
        sole request always makes progress. False only when another slot
        shares the page and no page can be freed: the engine then
        preempts a victim on this shard and retries. The copy goes on the
        current stream of the shard's ranks, before the step that writes,
        and the page table changes on the host only: the next step's
        inputs carry it."""
        if not self.prefix_enabled:
            return True
        pages = self._slot_pages[slot]
        lo = int(self.lens[slot]) // self.page_size
        hi = min(self.pages_for(tokens), len(pages))
        idx = [i for i in range(lo, hi) if self._refs[pages[i]] > 1]
        if not idx:
            return True
        shard = self.shard_of_slot(slot)
        copies: List[Tuple[int, int, int]] = []    # (pos, shared, fresh)
        for i in idx:
            page = pages[i]
            node = self._node_of_page.get(page)
            fresh = self._take_page(shard)
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
            src = self._local([c[1] for c in copies])
            if src is not None:
                kv_cache.copy_pages(self.pools, src,
                                    self._local([c[2] for c in copies]))
            for i, shared, fresh in copies:
                pages[i] = fresh
                self.page_table[slot, i] = fresh
                self._release_page(shared)
            self.prefix_cow_copies += len(copies)
            self.prefix_cow_bytes += len(copies) * self.page_bytes
            self._note_peak(shard)
        return True

    def prefix_cached_pages_of(self, shard: int) -> int:
        """Pages currently published in ``shard``'s trie."""
        return sum(1 for p in self._node_of_page
                   if self.shard_of_page(p) == shard)

    def prefix_shared_pages_of(self, shard: int) -> int:
        """Pages of ``shard`` with more than one referent."""
        lo = shard * self.pages_per_shard
        return int(np.count_nonzero(
            self._refs[lo:lo + self.pages_per_shard] >= 2))

    @property
    def prefix_cached_pages(self) -> int:
        """Pages currently published in the tries."""
        return len(self._node_of_page)

    @property
    def prefix_shared_pages(self) -> int:
        """Pages with more than one referent."""
        return int(np.count_nonzero(self._refs >= 2))

    def record_metrics(self, registry) -> None:
        super().record_metrics(registry)
        self.record_shard_metrics(registry)

    def record_shard_metrics(self, registry) -> None:
        """The paged gauges, one ``shard`` label each, and, with the
        prefix cache on, the prefix cache's, as the JAX package's
        ``PagedKVCache.record_shard_metrics``. Host-side counts only."""
        free = registry.gauge("repro_kv_free_pages",
                              "free KV pages per shard", ["shard"])
        held = registry.gauge("repro_kv_held_bytes",
                              "resident KV bytes per shard", ["shard"])
        for s in range(self.n_shards):
            free.labels(shard=s).set(self.free_pages_of(s))
            held.labels(shard=s).set(self.used_pages_of(s) * self.page_bytes)
        if not self.prefix_enabled:
            return
        g = registry.gauge
        cached = g("repro_prefix_cached_pages",
                   "pages published in the prefix trie", ["shard"])
        shared = g("repro_prefix_shared_pages",
                   "pages with more than one referent", ["shard"])
        for s in range(self.n_shards):
            cached.labels(shard=s).set(self.prefix_cached_pages_of(s))
            shared.labels(shard=s).set(self.prefix_shared_pages_of(s))
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
        on its shard's free list exactly once), a reserved sink, or
        referenced with a refcount equal to its referents (binding slots
        + trie); slots and trie entries stay on their shard and the tries
        agree with ``_node_of_page``. Raises AssertionError on any leak,
        double free or double booking."""
        refs = np.zeros(self.num_pages, np.int64)
        seen_free: set = set()
        for s, fl in enumerate(self._free_by_shard):
            assert len(set(fl)) == len(fl), f"shard {s} free-list dupes"
            for p in fl:
                assert self.shard_of_page(p) == s, \
                    f"page {p} on shard {s}'s free list"
                assert p != self.sink_page(s), "sink page freed"
            seen_free.update(fl)
        for slot, pages in enumerate(self._slot_pages):
            for p in pages:
                assert self.shard_of_page(p) == self.shard_of_slot(slot), \
                    f"slot {slot} bound page {p} across shards"
                refs[p] += 1
        n_nodes = 0
        for s, root in enumerate(self._trie_roots):
            stack = list(root.children.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                n_nodes += 1
                assert self.shard_of_page(node.page) == s, \
                    "trie entry crossed a shard boundary"
                assert self._node_of_page.get(node.page) is node, \
                    f"trie index out of sync for page {node.page}"
                refs[node.page] += 1
        assert n_nodes == len(self._node_of_page), \
            "orphaned trie index entries"
        sinks = {self.sink_page(s) for s in range(self.n_shards)}
        for p in range(self.num_pages):
            assert int(self._refs[p]) == int(refs[p]), \
                f"page {p}: refcount {int(self._refs[p])} != " \
                f"{int(refs[p])} referents"
            if p in sinks:
                assert refs[p] == 0 and p not in seen_free, \
                    f"sink page {p} misused"
            elif refs[p] == 0:
                assert p in seen_free, f"page {p} leaked"
            else:
                assert p not in seen_free, f"page {p} double-booked"

    # -- step inputs -----------------------------------------------------
    def device_page_table(self, slot: int) -> torch.Tensor:
        """One slot's row in this rank's page ids: on a rank of another
        shard every position maps to this rank's sink, so only the
        owning shard's ranks write the slot's KV."""
        row = self.page_table[slot:slot + 1]
        if self.local_shard is not None:
            if self.shard_of_slot(slot) == self.local_shard:
                row = self._local_rows(row)
            else:
                row = np.full_like(row, SINK_PAGE)
        return self._upload(row)

    def decode_inputs(self, sink_only: bool = False):
        rows = self.decode_rows
        table = self._local_rows(self.page_table[rows.start:rows.stop])
        lens = self.lens[rows.start:rows.stop]
        if sink_only:
            table = np.asarray([[self._local_sink(self.shard_of_slot(s))]
                                * self.max_pages_per_seq for s in rows],
                               np.int32)
            lens = np.zeros_like(lens)
        return (self._decode_table.refresh(table),
                self._decode_lens.refresh(lens), self._sinks)

    def sink_row(self, slot: int) -> torch.Tensor:
        return self._upload(np.asarray(
            [self._local_sink(self.shard_of_slot(slot))], np.int32))

    def sink_page_table(self) -> torch.Tensor:
        """A ``[1, max_pages_per_seq]`` row that maps every position to
        shard 0's sink (this rank's own under "dp" over ranks): a
        probe's KV writes all land there."""
        return self._upload(np.full((1, self.max_pages_per_seq), SINK_PAGE,
                                    np.int32))

    # -- accounting ------------------------------------------------------
    @property
    def page_bytes(self) -> int:
        """Bytes of one page across all layers."""
        return self._page_bytes

    @property
    def cache_bytes(self) -> int:
        """Logical bytes of the pools: every shard's pages."""
        return self.num_pages * self.page_bytes

    @property
    def per_device_cache_bytes(self) -> int:
        """Pool bytes one device holds: its shard's pages under "dp",
        the whole pool otherwise."""
        return self.cache_bytes // self.n_shards

    @property
    def used_bytes(self) -> int:
        return self.used_pages * self.page_bytes

    @property
    def peak_used_bytes(self) -> int:
        return self.peak_used_pages * self.page_bytes

    @property
    def per_device_peak_used_bytes(self) -> int:
        """Peak KV bytes one device holds: the busiest shard's peak under
        "dp"; the global peak when every device holds the whole pool."""
        if self.n_shards == 1:
            return self.peak_used_bytes
        return max(self._peak_used_by_shard) * self.page_bytes
