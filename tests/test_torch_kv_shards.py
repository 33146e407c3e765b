"""The multi-shard allocator and scheduler: the port's ``PagedKVCache``
and ``Scheduler`` against the JAX package's ``PagedKVCache(...,
shards=N)`` and ``Scheduler`` at 1, 2 and 3 shards, with no ranks (the
``shards=`` override keeps every page in one pool, as in
``tests/test_kv_sharding.py``).

* **Allocator lockstep:** seeded op schedules (admit through the
  cache-aware, then least-loaded placement of ``match_prefix(...,
  candidates)`` / ``best_shard``; chunked prefill with
  ``ensure_private``; decode growth; publish; retire; preempt by
  recompute and by offload; sticky restore), victims taken on the dry
  shard, drive both caches with the same calls; every result is
  compared, and after every op the page table, ``lens``, each shard's
  free list (its order too), the refcounts, each shard's trie, the
  per-shard peaks and byte counts agree; after a copy-on-write, an
  offload or a restore every pool byte does too. At the end both
  registries hold the same per-shard gauges.
* **Scheduler lockstep:** the same requests through both schedulers
  under a loop that advances prefill chunks, grows decode slots
  (preempting on the dry shard), retires and preempts at random: after
  every op each request's state, slot, shard and prefill position, the
  queues and the page tables agree, and each fresh admission chose the
  same (shard, slot).
"""
import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.obs import Registry as JaxRegistry
from repro.serve import PagedKVCache as JaxCache
from repro.serve.request import Request as JaxRequest
from repro.serve.scheduler import Scheduler as JaxScheduler
from repro_torch.configs import get_config
from repro_torch.obs import Recorder
from repro_torch.serve.paged_kv import PagedKVCache
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import Scheduler

from test_prefix_cache import _prompt
from test_torch_prefix_cache import _pools_equal, _trie

SHARDS = (1, 2, 3)
PS = 2
COUNTERS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
            "prefix_evicted_pages", "prefix_cow_copies", "prefix_cow_bytes",
            "swap_out_bytes", "swap_in_bytes", "peak_used_pages",
            "used_pages", "free_pages", "num_pages", "pages_per_shard",
            "max_slots", "max_slot_tokens", "cache_bytes",
            "per_device_cache_bytes", "per_device_peak_used_bytes",
            "host_bytes")


def _cfg(get):
    return dataclasses.replace(get("moe-gpt3-s").reduced(),
                               compute_dtype="float32")


def _pair(shards, seed=0, **over):
    """A port cache and a JAX cache of ``shards`` shards, their pools
    filled with the same random data."""
    kw = dict(num_pages=9 * shards, page_size=PS, max_slots=2 * shards,
              max_pages_per_seq=6, prefix_cache=True, shards=shards)
    kw.update(over)
    tkv = PagedKVCache(_cfg(get_config), dtype=torch.float32, device="cpu",
                       **kw)
    jc = JaxCache(_cfg(jax_config), dtype=np.float32, **kw)
    gen = torch.Generator().manual_seed(seed)
    for period in tkv.pools:
        for layer in period.values():
            for t in layer.values():
                t.copy_(torch.randn(t.shape, generator=gen))
    jc.pools = {lk: {name: jnp.asarray(np.stack(
        [period[lk][name].numpy() for period in tkv.pools]))
        for name in tkv.pools[0][lk]} for lk in tkv.pools[0]}
    return tkv, jc


def _state(kv):
    n = kv.n_shards
    return dict(
        table=kv.page_table.tolist(), lens=kv.lens.tolist(),
        refs=kv._refs.tolist(), free=[list(f) for f in kv._free_by_shard],
        slots=[list(p) for p in kv._slot_pages],
        tries=[_trie(root) for root in kv._trie_roots],
        offloaded={rid: kv.offloaded_shard(rid) for rid in kv._offloaded},
        peaks=list(kv._peak_used_by_shard),
        free_of=[kv.free_pages_of(s) for s in range(n)],
        used_of=[kv.used_pages_of(s) for s in range(n)],
        cached_of=[kv.prefix_cached_pages_of(s) for s in range(n)],
        shared_of=[kv.prefix_shared_pages_of(s) for s in range(n)],
        **{k: int(getattr(kv, k)) for k in COUNTERS})


def _agree(tkv, jc, pools=False):
    tkv.check_integrity()
    jc.check_integrity()
    assert _state(tkv) == _state(jc)
    if pools:
        _pools_equal(tkv, jc)


def _lockstep(tkv, jc, seed):
    """One seeded schedule over both caches: each decision is taken on
    the port, every call made on both, every result compared."""
    rnd = random.Random(seed)
    bases = [tuple(rnd.randrange(1, 50) for _ in range(n))
             for n in (6, 10, 14)]
    live, pending, parked, rid_of = {}, {}, {}, {}
    history, next_rid = [], [0]

    def both(name, *args, **kw):
        got = getattr(tkv, name)(*args, **kw)
        want = getattr(jc, name)(*args, **kw)
        assert got == want, (name, args, kw, got, want)
        return got

    def free_victim(slot):
        """Preempt (recompute) the lowest other live slot of ``slot``'s
        shard: a dry shard gains from its own victims only."""
        shard = tkv.shard_of_slot(slot)
        victims = [s for s in sorted(live)
                   if s != slot and tkv.shard_of_slot(s) == shard]
        if not victims:
            return None
        both("free_slot", victims[0])
        del live[victims[0]]
        pending.pop(victims[0], None)
        return victims[0]

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

    def free_slots(shard):
        return [s for s in tkv.slots_of(shard) if s not in live]

    for _ in range(rnd.randrange(40, 90)):
        op = rnd.choices(range(7), (4, 5, 3, 2, 1, 1, 1))[0]
        pick = rnd.randrange(8)
        cows = tkv.prefix_cow_copies
        if op == 0:                                   # admit, placed
            if history and rnd.random() < 0.35:
                prompt = list(rnd.choice(history))
            else:
                prompt = _prompt(rnd, bases)
                history.append(prompt)
            if len(prompt) > tkv.max_slot_tokens:
                continue
            cands = [s for s in range(tkv.n_shards) if free_slots(s)]
            shard, _ = both("match_prefix", prompt, len(prompt),
                            candidates=cands)
            if shard is None:
                shard = both("best_shard", len(prompt), candidates=cands)
            if shard is None:
                continue
            slot = free_slots(shard)[0]
            cached = both("alloc_slot_prefix", slot, len(prompt), prompt)
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
            both("held_bytes", slot)
            both("free_slot", slot)
            del live[slot]
        elif op == 4:                                 # preempt recompute
            if not live:
                continue
            slot = sorted(live)[pick % len(live)]
            both("held_bytes", slot)
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
        else:                                         # sticky restore
            if not parked:
                continue
            rid = sorted(parked)[pick % len(parked)]
            slots = free_slots(both("offloaded_shard", rid))
            if not both("can_restore", rid) or not slots:
                continue
            tokens = parked.pop(rid)
            both("restore_slot", rid, slots[0], len(tokens))
            live[slots[0]] = list(tokens)
            rid_of[slots[0]] = rid
        _agree(tkv, jc, pools=op >= 5 or tkv.prefix_cow_copies != cows)
    _agree(tkv, jc, pools=True)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "plain"])
def test_allocator_lockstep_with_jax(shards, prefix):
    """25 seeded schedules a case; each path (placement on every shard,
    hits, copies on write, pool-dry growth, offload and restore) must
    have run, and the per-shard gauges of both registries agree."""
    seen = {"shards": set(), "offload": 0, "restore": 0, "dry": 0}
    if prefix:
        seen.update(hits=0, cow=0)
    for example in range(25):
        tkv, jc = _pair(shards, example, prefix_cache=prefix)
        _lockstep(tkv, jc, 1000 * shards + example)
        seen["shards"] |= {s for s in range(shards)
                           if tkv._peak_used_by_shard[s]}
        seen["offload"] += tkv.swap_out_bytes
        seen["restore"] += tkv.swap_in_bytes
        seen["dry"] += any(p == tkv.shard_capacity_pages
                           for p in tkv._peak_used_by_shard)
        if prefix:
            seen["hits"] += tkv.prefix_hits
            seen["cow"] += tkv.prefix_cow_copies
        treg, jreg = Recorder().registry, JaxRegistry()
        tkv.record_metrics(treg)
        jc.record_metrics(jreg)
        assert treg.snapshot() == jreg.snapshot()
    assert seen.pop("shards") == set(range(shards))
    assert all(seen.values()), seen


def test_shard_topology_matches_jax():
    """Slot rounding, shard ranges, sinks, sizing and the per-device
    bytes at 1-3 shards, auto-sized and not."""
    for shards in SHARDS:
        for pages in (0, 7, 20):
            tkv, jc = _pair(shards, num_pages=pages, max_slots=5)
            assert (tkv.max_slots, tkv.slots_per_shard, tkv.num_pages,
                    tkv.pages_per_shard) == (jc.max_slots, jc.slots_per_shard,
                                             jc.num_pages, jc.pages_per_shard)
            for s in range(shards):
                assert list(tkv.slots_of(s)) == list(jc.slots_of(s))
                assert tkv.sink_page(s) == jc.sink_page(s)
            assert [tkv.shard_of_slot(i) for i in range(tkv.max_slots)] == \
                [jc.shard_of_slot(i) for i in range(jc.max_slots)]
            assert tkv.page_table.tolist() == jc.page_table.tolist()
            assert tkv.per_device_cache_bytes == jc.per_device_cache_bytes
            # no ranks: the pools hold every page, every slot decodes
            assert tkv.local_shard is None
            assert list(tkv.decode_rows) == list(range(tkv.max_slots))


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

def _requests(seed, n):
    rnd = random.Random(seed)
    bases = [tuple(rnd.randrange(1, 50) for _ in range(k)) for k in (6, 10)]
    return [(_prompt(rnd, bases), rnd.randrange(1, 6)) for _ in range(n)]


def _sched_state(sch):
    reqs = (list(sch.waiting) + list(sch.resuming)
            + list(sch.running.values()))
    return dict(
        reqs=sorted((r.rid, r.state.value, r.slot, r.kv_shard,
                     r.prefill_pos, r.preempt_mode, r.cached_tokens,
                     len(r.output)) for r in reqs),
        waiting=[r.rid for r in sch.waiting],
        resuming=sorted(r.rid for r in sch.resuming),
        running=sorted((s, r.rid) for s, r in sch.running.items()),
        prefilling=list(sch._prefilling),
        table=sch.kv.page_table.tolist(), lens=sch.kv.lens.tolist(),
        free=[list(f) for f in sch.kv._free_by_shard])


def _sched_lockstep(shards, seed, full_reserve):
    tkv, jc = _pair(shards, seed, num_pages=7 * shards)
    ts = Scheduler(tkv, chunk=3, full_reserve=full_reserve)
    js = JaxScheduler(jc, chunk=3, full_reserve=full_reserve)
    reqs = [(p, g) for p, g in _requests(seed, 6 * shards + 4)
            if len(p) + g <= tkv.max_slot_tokens]     # the engine's submit
    for i, (prompt, gen) in enumerate(reqs):
        ts.submit(Request(rid=i, prompt=prompt, max_new_tokens=gen))
        js.submit(JaxRequest(rid=i, prompt=prompt, max_new_tokens=gen))
    rnd = random.Random(seed)
    admits = []

    def jreq(req):
        return next(r for r in list(js.running.values()) + js.resuming
                    if r.rid == req.rid)

    def preempt(req, mode):
        assert ts.preempt(req, mode) == js.preempt(jreq(req), mode)

    def ensure(req, tokens):
        """Grow ``req``'s slot, preempting on its shard while dry (the
        engine's ``_ensure``); False if ``req`` itself was the victim."""
        shard = tkv.shard_of_slot(req.slot)
        while tkv.slot_capacity(req.slot) < tokens:
            if tkv.grow_slot(req.slot):
                assert jc.grow_slot(req.slot)
                continue
            assert not jc.grow_slot(req.slot)
            on = [r for r in ts.running.values()
                  if tkv.shard_of_slot(r.slot) == shard]
            victim = max(on, key=lambda r: r.rid)
            preempt(victim, "offload" if victim.rid % 2 else "recompute")
            if victim is req:
                return False
        return True

    steps = 0
    while ts.has_work:
        steps += 1
        assert steps < 2000, "the schedule did not drain"
        got = [(r.rid, r.kv_shard, r.slot) for r in ts.admit()]
        want = [(r.rid, r.kv_shard, r.slot) for r in js.admit()]
        assert got == want
        admits += got
        op = rnd.choices(range(3), (1, 4, 4))[0]
        if op == 0 and ts.running:                    # preempt one
            req = ts.running[sorted(ts.running)[rnd.randrange(
                len(ts.running))]]
            preempt(req, rnd.choice(("recompute", "offload")))
        elif op == 1 and ts._prefilling:              # a prefill chunk
            req = ts.running[ts._prefilling[0]]
            c = min(ts.chunk, req.remaining_prefill)
            if ensure(req, int(tkv.lens[req.slot]) + c):
                for sch, r in ((ts, req), (js, jreq(req))):
                    r.prefill_pos += c
                    sch.kv.lens[r.slot] += c
                    sch.prefill_advanced(r)
                    if r.remaining_prefill == 0:
                        r.state = type(r.state).DECODE
                        if not r.output:
                            r.output.append(7)
        else:                                         # a decode step
            for slot in list(ts.decode_slots()):
                req = ts.running.get(slot)
                if req is None or not ensure(req, int(tkv.lens[slot]) + 1):
                    continue
                done = len(req.output) + 1 >= req.max_new_tokens
                for sch, r in ((ts, req), (js, jreq(req))):
                    sch.kv.lens[r.slot] += 1
                    r.output.append(8)
                    if done:
                        r.state = type(r.state).DONE
                        sch.finish(r)
        assert _sched_state(ts) == _sched_state(js)
    return admits, tkv, ts.resume_count


@pytest.mark.parametrize("shards", SHARDS)
def test_scheduler_lockstep_with_jax(shards):
    """Placement (cache-aware, then least-loaded), sticky resumes and
    victims on the dry shard, in both reservation modes; every request
    finishes and every shard drains."""
    placed, resumes = set(), 0
    for seed in range(6):
        for full in (False, True):
            admits, tkv, n = _sched_lockstep(shards, 100 * shards + seed,
                                             full)
            resumes += n
            placed |= {shard for _, shard, _ in admits}
            assert all(tkv.free_pages_of(s) == tkv.shard_capacity_pages
                       for s in range(shards))
            tkv.check_integrity()
    assert placed == set(range(shards)) and resumes > 0
