"""The prefix cache's allocator: the port's ``PagedKVCache`` (refcounted
pages, the trie, copy-on-write) against the JAX package's
``PagedKVCache(shards=1)``, on reduced moe-gpt3-s pools filled with the
same random data.

* **Lockstep:** seeded op schedules (the op mix of ``_interleave`` in
  ``tests/test_prefix_cache.py``: admit with prefix reuse, chunked
  prefill with ``ensure_private``, decode growth, publish, retire,
  preempt by recompute and by offload, restore) drive both caches with
  the same calls. After every op the two must agree on the page table,
  ``lens``, the refcounts, the free list (its order too), the trie as a
  map from token path to page, every ``prefix_*`` counter and the swap
  bytes; after a copy-on-write, an offload or a restore, on every pool
  byte; and ``check_integrity()`` holds on both.
* **Unit scenarios** of ``tests/test_prefix_cache.py`` (hits and the
  ``len - 1`` cap, page-aligned hits, bit-exact copy-on-write, the steal
  path, LRU eviction of trie-only pages, preemption never dropping a
  shared page, the hit probe, the refcount-free "off" path, shared pages
  counted once), each run on both caches with its checks, then the two
  states compared.
* ``copy_pages`` writes in place and equals the JAX function.
"""
import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import kv_cache as jkv
from repro.serve import PagedKVCache as JaxCache
from repro_torch.configs import get_config
from repro_torch.models import kv_cache
from repro_torch.serve.paged_kv import PagedKVCache

from test_prefix_cache import _admit_publish, _prompt, _schedule

PS = 2
# the op weights of the lockstep schedules (admit, prefill chunk, decode,
# retire, preempt by recompute, by offload, restore), and the share of
# admissions that repeat an earlier prompt verbatim: a full-prompt hit
# caps at len - 1, mid-page when the length is even, so the tail's first
# write copies on write (random tails alone almost never repeat)
WEIGHTS = (3, 5, 2, 3, 1, 1, 1)
REPEAT = 0.35
COUNTERS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
            "prefix_evicted_pages", "prefix_cow_copies", "prefix_cow_bytes",
            "swap_out_bytes", "swap_in_bytes", "peak_used_pages",
            "used_pages", "free_pages")


def _cfg(get):
    return dataclasses.replace(get("moe-gpt3-s").reduced(),
                               compute_dtype="float32")


def _pair(seed=0, **over):
    """A port cache and a JAX cache of the same shape, their pools
    filled with the same random data."""
    kw = dict(num_pages=20, page_size=PS, max_slots=4, max_pages_per_seq=8,
              prefix_cache=True)
    kw.update(over)
    tkv = PagedKVCache(_cfg(get_config), dtype=torch.float32, device="cpu",
                       **kw)
    jc = JaxCache(_cfg(jax_config), dtype=np.float32, shards=1, **kw)
    gen = torch.Generator().manual_seed(seed)
    for period in tkv.pools:
        for layer in period.values():
            for t in layer.values():
                t.copy_(torch.randn(t.shape, generator=gen))
    jc.pools = {lk: {name: jnp.asarray(np.stack(
        [period[lk][name].numpy() for period in tkv.pools]))
        for name in tkv.pools[0][lk]} for lk in tkv.pools[0]}
    return tkv, jc


def _trie(root):
    out, stack = {}, [(root, ())]
    while stack:
        node, path = stack.pop()
        for key, child in node.children.items():
            out[path + (key,)] = (child.page, child.tick)
            stack.append((child, path + (key,)))
    return out


def _state(kv):
    return dict(
        table=kv.page_table.tolist(), lens=kv.lens.tolist(),
        refs=kv._refs.tolist(), free=list(kv._free_by_shard[0]),
        slots=[list(p) for p in kv._slot_pages],
        trie=_trie(kv._trie_roots[0]),
        offloaded=sorted(kv._offloaded),
        **{k: int(getattr(kv, k)) for k in COUNTERS})


def _pools_equal(tkv, jc):
    for lk, layer in jc.pools.items():
        for name, leaf in layer.items():
            want = np.asarray(leaf)
            got = np.stack([period[lk][name].numpy() for period in tkv.pools])
            np.testing.assert_array_equal(got, want, err_msg=f"{lk}.{name}")


def _agree(tkv, jc, pools=False):
    tkv.check_integrity()
    jc.check_integrity()
    assert _state(tkv) == _state(jc)
    if pools:
        _pools_equal(tkv, jc)


def _weighted_schedule(example: int):
    rnd = random.Random(example)
    n = rnd.randrange(30, 80)
    return [(rnd.choices(range(7), WEIGHTS)[0], rnd.randrange(8))
            for _ in range(n)], rnd.randrange(2 ** 31)


def _lockstep(tkv, jc, ops, seed):
    """``_interleave`` of ``tests/test_prefix_cache.py`` over both caches:
    each op's decisions are taken on the port, every call made on both,
    every result compared. Admissions also repeat earlier prompts
    (``REPEAT``)."""
    rnd = random.Random(seed)
    bases = [tuple(rnd.randrange(1, 50) for _ in range(n))
             for n in (6, 10, 14)]
    live, pending, parked, rid_of = {}, {}, {}, {}
    history = []         # prompts admitted before, for verbatim repeats
    next_rid = [0]

    def both(name, *args, **kw):
        got = getattr(tkv, name)(*args, **kw)
        want = getattr(jc, name)(*args, **kw)
        assert got == want, (name, args, got, want)
        return got

    def free_victim(slot):
        victims = [s for s in sorted(live) if s != slot]
        if not victims:
            return None
        v = victims[0]
        both("free_slot", v)
        del live[v]
        return v

    def ensure(slot, tokens):
        while tkv.slot_capacity(slot) < tokens:
            if len(tkv._slot_pages[slot]) >= tkv.max_pages_per_seq:
                return False
            if both("grow_slot", slot):
                continue
            if free_victim(slot) is None:
                return False
        while not both("ensure_private", slot, tokens):
            if free_victim(slot) is None:
                return False
        return True

    for op, pick in ops:
        cows = tkv.prefix_cow_copies
        if op == 0:                                   # admit
            free = [s for s in range(tkv.max_slots) if s not in live]
            if not free:
                continue
            slot = free[pick % len(free)]
            if history and rnd.random() < REPEAT:
                prompt = list(rnd.choice(history))
            else:
                prompt = _prompt(rnd, bases)
                history.append(prompt)
            assert tkv.max_slot_tokens == jc.max_slot_tokens
            if len(prompt) > tkv.max_slot_tokens or \
                    not both("can_admit", len(prompt)):
                continue
            assert tkv.match_prefix(prompt, len(prompt)) == \
                jc.match_prefix(prompt, len(prompt))
            cached = both("alloc_slot_prefix", slot, len(prompt), prompt)
            assert 0 <= cached < len(prompt)
            live[slot] = list(prompt[:cached])
            pending[slot] = prompt
            rid_of[slot] = next_rid[0]
            next_rid[0] += 1
        elif op == 1:                                 # prefill chunk
            slots = [s for s in sorted(pending) if s in live]
            if not slots:
                continue
            slot = slots[pick % len(slots)]
            prompt, done = pending[slot], len(live[slot])
            c = min(3, len(prompt) - done)
            if c <= 0 or not ensure(slot, done + c):
                pending.pop(slot, None)
                continue
            if slot not in live:
                continue
            live[slot].extend(prompt[done:done + c])
            tkv.lens[slot] += c
            jc.lens[slot] += c
            if len(live[slot]) == len(prompt):
                del pending[slot]
                both("cache_slot_prefix", slot, live[slot])
        elif op == 2:                                 # decode one token
            slots = [s for s in sorted(live) if s not in pending]
            if not slots:
                continue
            slot = slots[pick % len(slots)]
            if not ensure(slot, int(tkv.lens[slot]) + 1) or slot not in live:
                continue
            live[slot].append(rnd.randrange(200, 300))
            tkv.lens[slot] += 1
            jc.lens[slot] += 1
        elif op == 3:                                 # retire (publish)
            slots = [s for s in sorted(live) if s not in pending]
            if not slots:
                continue
            slot = slots[pick % len(slots)]
            both("cache_slot_prefix", slot, live[slot])
            assert tkv.held_bytes(slot) == jc.held_bytes(slot)
            both("free_slot", slot)
            del live[slot]
        elif op == 4:                                 # preempt recompute
            if not live:
                continue
            slot = sorted(live)[pick % len(live)]
            assert tkv.held_bytes(slot) == jc.held_bytes(slot)
            both("free_slot", slot)
            del live[slot]
            pending.pop(slot, None)
        elif op == 5:                                 # preempt offload
            slots = [s for s in sorted(live) if int(tkv.lens[s]) > 0]
            if not slots:
                continue
            slot = slots[pick % len(slots)]
            both("offload_slot", slot, rid_of[slot])
            parked[rid_of[slot]] = live[slot]
            del live[slot]
            pending.pop(slot, None)
        else:                                         # restore
            if not parked:
                continue
            rid = sorted(parked)[pick % len(parked)]
            if not both("can_restore", rid):
                continue
            free = [s for s in range(tkv.max_slots) if s not in live]
            if not free:
                continue
            slot = free[pick % len(free)]
            tokens = parked.pop(rid)
            both("restore_slot", rid, slot, len(tokens))
            live[slot] = list(tokens)
            rid_of[slot] = rid
        _agree(tkv, jc, pools=op >= 5 or tkv.prefix_cow_copies != cows)
    _agree(tkv, jc, pools=True)


@pytest.mark.parametrize("pool", ["roomy", "tight"])
def test_lockstep_with_jax(pool):
    """The JAX tier's own schedules and weighted ones, 40 of each, on a
    20-page pool of 4 slots and on a tight 8-page pool of 3 slots where
    eviction and the steal path run all the time (the JAX tier's deep
    variant)."""
    over = {} if pool == "roomy" else dict(num_pages=8, max_slots=3)
    base = 0 if pool == "roomy" else 10_000
    seen = {"hits": 0, "cow": 0, "evicted": 0, "restored": 0}
    for example in range(40):
        for ops, seed in (_schedule(base + example),
                          _weighted_schedule(base + example)):
            tkv, jc = _pair(example, **over)
            _lockstep(tkv, jc, ops, seed)
            seen["hits"] += tkv.prefix_hits
            seen["cow"] += tkv.prefix_cow_copies
            seen["evicted"] += tkv.prefix_evicted_pages
            seen["restored"] += tkv.swap_in_bytes
    assert all(seen.values()), seen


def test_prefix_off_matches_jax_allocator():
    """With the prefix cache off the same schedules give JAX's page
    tables and free-list order; no refcount exceeds 1, nothing is
    published and every counter stays 0."""
    for example in range(6):
        ops, seed = _schedule(example)
        tkv, jc = _pair(example, prefix_cache=False)
        _lockstep(tkv, jc, ops, seed)
        assert int(tkv._refs.max()) <= 1 and not tkv._node_of_page
        assert tkv.prefix_hits == tkv.prefix_misses == 0
        assert tkv.free_pages == len(tkv._free)


def test_copy_pages_in_place_matches_jax():
    tkv, jc = _pair(3)
    ptrs = [t.data_ptr() for t in kv_cache._in_order(tkv.pools)]
    assert kv_cache.copy_pages(tkv.pools, [3, 5, 9], [7, 1, 2]) is tkv.pools
    jc.pools = jkv.copy_pages(jc.pools, [3, 5, 9], [7, 1, 2])
    _pools_equal(tkv, jc)
    assert ptrs == [t.data_ptr() for t in kv_cache._in_order(tkv.pools)]
    with pytest.raises(ValueError):
        kv_cache.copy_pages(tkv.pools, [1, 2], [2, 3])


# ---------------------------------------------------------------------------
# the unit scenarios of tests/test_prefix_cache.py, on both caches
# ---------------------------------------------------------------------------

def _free_list(kv):
    return kv._free_by_shard[0]


def _page(kv, page):
    """One physical page of every pool leaf, as numpy."""
    if isinstance(kv, JaxCache):
        return [np.asarray(leaf[:, page]) for layer in kv.pools.values()
                for leaf in layer.values()]
    return [np.stack([period[lk][name][page].numpy()
                      for period in kv.pools])
            for lk in kv.pools[0] for name in kv.pools[0][lk]]


def _hit_caps(kv):
    base = list(range(1, 9))                    # 8 tokens = 4 pages
    _admit_publish(kv, 0, base)
    first = list(kv._slot_pages[0])
    cached = kv.alloc_slot_prefix(1, len(base), base)
    assert cached == len(base) - 1              # 7: a mid-page boundary
    assert kv._slot_pages[1] == first           # pages 0..3 shared
    assert kv.prefix_hits == 1 and kv.prefix_hit_tokens == 7
    cached = kv.alloc_slot_prefix(2, 10, base + [91, 92])
    assert cached == 8 and kv._slot_pages[2][:4] == first


def _page_aligned(kv):
    base = list(range(1, 9))
    _admit_publish(kv, 0, base)
    assert kv.alloc_slot_prefix(1, len(base), base, page_aligned=True) == 6
    assert int(kv.lens[1]) == 6


def _cow_bit_exact(kv):
    base = list(range(1, 9))
    _admit_publish(kv, 0, base)
    cached = kv.alloc_slot_prefix(1, len(base), base)
    shared = kv._slot_pages[1][3]
    before = _page(kv, shared)
    assert kv._refs[shared] >= 2
    assert kv.ensure_private(1, cached + 1)
    fresh = kv._slot_pages[1][3]
    assert fresh != shared and kv.prefix_cow_copies == 1
    assert kv.page_table[1, 3] == fresh
    for got, src, want in zip(_page(kv, fresh), _page(kv, shared), before):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(src, want)
    assert kv._slot_pages[0][3] == shared       # slot 0 and the trie keep it


def _cow_steal(kv):
    base = [1, 2, 3, 4]
    _admit_publish(kv, 0, base)
    kv.free_slot(0)                             # the trie keeps the pages
    assert kv.alloc_slot_prefix(0, len(base), base) == 3
    free = _free_list(kv)
    drained = list(free)
    del free[:]                                 # the copy target must fail
    assert kv.ensure_private(0, 4)              # steals, does not copy
    assert kv.prefix_cow_copies == 0 and kv.prefix_evicted_pages == 1
    assert int(kv._refs[kv._slot_pages[0][1]]) == 1
    free[:0] = drained                          # hand the pages back


def _lru_eviction(kv):
    a, b = list(range(1, 9)), list(range(11, 19))   # 4 pages each
    _admit_publish(kv, 0, a)
    kv.free_slot(0)
    _admit_publish(kv, 0, b)
    kv.free_slot(0)                             # trie: a (older), b
    kv.alloc_slot_prefix(0, len(b), b)          # rebind b: the pool is full
    b_pages = list(kv._slot_pages[0])
    assert len(_free_list(kv)) == 1             # 9 usable - 4 - 4
    kv.alloc_slot(1, 4)                         # the second take evicts a
    assert kv.prefix_evicted_pages >= 1
    assert kv._slot_pages[0] == b_pages
    assert all(int(kv._refs[p]) == 2 for p in b_pages)


def _preempt_keeps_shared(kv):
    base = list(range(1, 9))
    _admit_publish(kv, 0, base)
    kv.alloc_slot_prefix(1, len(base), base)
    shared = [p for p in kv._slot_pages[1] if int(kv._refs[p]) >= 2]
    assert shared
    kv.free_slot(1)
    assert all(int(kv._refs[p]) >= 1 and p not in _free_list(kv)
               for p in shared)
    kv.offload_slot(0, rid=7)
    assert all(int(kv._refs[p]) == 1 and p not in _free_list(kv)
               for p in shared)
    kv.check_integrity()
    kv.restore_slot(7, 0, len(base))


def _hit_probe(kv):
    base = list(range(1, 9))
    _admit_publish(kv, 0, base)
    assert kv.match_prefix(base + [50], 9) == (0, 8)
    assert kv.match_prefix([60, 61, 62], 3) == (None, 0)
    # a reservation past the per-sequence budget is no hit
    assert kv.match_prefix(base + [50], 16 * PS) == (None, 0)


def _off_is_refcount_free(kv):
    base = list(range(1, 9))
    assert kv.alloc_slot_prefix(0, len(base), base) == 0
    kv.lens[0] = len(base)
    kv.cache_slot_prefix(0, base)               # a no-op
    assert kv.match_prefix(base, 8) == (None, 0)
    assert kv.ensure_private(0, 9)
    assert not kv._node_of_page and kv.prefix_hits == 0
    assert all(int(r) <= 1 for r in kv._refs)
    kv.free_slot(0)


def _shared_counted_once(kv):
    base = list(range(1, 9))                    # 4 pages
    _admit_publish(kv, 0, base)
    kv.free_slot(0)
    one = kv.used_pages
    kv.alloc_slot_prefix(0, len(base), base)
    kv.alloc_slot_prefix(1, len(base), base)
    assert kv.used_pages == one                 # shared pages count once
    assert kv.held_bytes(0) == 0 and kv.held_bytes(1) == 0
    assert kv.peak_used_pages == one


SCENARIOS = {
    "hit_caps_at_len_minus_1": (_hit_caps, {}),
    "page_aligned_floors_the_hit": (_page_aligned, {}),
    "cow_copies_bit_exactly": (_cow_bit_exact, {}),
    "cow_steals_when_dry": (_cow_steal, dict(num_pages=6, max_slots=2,
                                             max_pages_per_seq=5)),
    "eviction_is_lru_and_trie_only": (_lru_eviction, dict(
        num_pages=10, max_pages_per_seq=4)),
    "preemption_never_drops_shared_pages": (_preempt_keeps_shared, {}),
    "match_prefix_is_a_hit_probe": (_hit_probe, {}),
    "prefix_off_is_refcount_free": (_off_is_refcount_free,
                                    dict(prefix_cache=False)),
    "shared_pages_count_once": (_shared_counted_once, {}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_unit_scenario_on_both(name):
    fn, over = SCENARIOS[name]
    tkv, jc = _pair(1, **over)
    fn(tkv)
    fn(jc)
    _agree(tkv, jc, pools=True)
