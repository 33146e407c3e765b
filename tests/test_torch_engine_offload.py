"""Preemption by offload and ``preempt="auto"``: the port's ``Engine``,
``PagedKVCache``, ``Scheduler`` and ``models.kv_cache`` page copies
against the JAX package's, on reduced moe-gpt3-s with the same converted
weights (the scenarios of ``tests/test_preemption.py``).

Five prompts over three slots and a 10-page pool make decode growth
preempt several times. Under ``"auto"`` on ``GPU_A100`` with an assumed
re-prefill MFU of 0.03 the cost model sits near its crossover for these
victims, so both modes occur: each engine must choose the same mode for
each victim, or the counts, the swap bytes or the schedule would part.
Greedy tokens are the same under every policy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.types import GPU_A100 as JAX_A100
from repro.models import kv_cache as jkv
from repro.serve import Engine as JaxEngine
from repro.serve import EngineOptions as JaxOptions
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.types import GPU_A100
from repro_torch.models import kv_cache
from repro_torch.serve import Engine, EngineOptions, RequestState
from repro_torch.serve.paged_kv import PagedKVCache
from repro_torch.serve.scheduler import Scheduler

from test_torch_engine_preempt import _cfg, _np_params

PROMPT_LENS = (13, 7, 10, 5, 11)
MAX_NEW = 12
OPTS = dict(page_size=4, max_slots=3, max_seq_len=32, chunk=16,
            min_bucket=8)
SMALL_POOL = 10
AUTO_MFU = 0.03
COUNTS = ("preempt_recompute", "preempt_offload", "resumes",
          "swap_out_bytes", "swap_in_bytes")


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=n, dtype=np.int32)
            for n in PROMPT_LENS]


def _run(engine, prompts):
    reqs = [engine.submit(p, max_new_tokens=MAX_NEW, arrival_s=0.0)
            for p in prompts]
    engine.run_until_idle()
    return [list(r.output) for r in reqs]


@pytest.fixture(scope="module")
def reference():
    """JAX engine tokens and preemption counts under "offload" and
    "auto" (offload allowed), built once. The second engine differs from
    the first in its preemption policy only, so it takes the first's
    compiled steps."""
    cfg = _cfg(jax_config)
    params_np = _np_params(cfg, 0)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    prompts = _prompts(cfg.vocab_size)
    out = {"params": params_np, "prompts": prompts}
    compiled = None
    for mode in ("offload", "auto"):
        eng = JaxEngine(cfg, params, options=JaxOptions(
            attn_kernel="gather", adaptive=False, preempt=mode,
            num_pages=SMALL_POOL, hw=JAX_A100, preempt_mfu=AUTO_MFU,
            allow_offload=True, **OPTS))
        if compiled is not None:
            eng._decode_fn, eng._prefill_fns = compiled
        out[mode] = {"tokens": _run(eng, prompts), "stats": eng.stats()}
        compiled = eng._decode_fn, eng._prefill_fns
    return out


def _port_engine(reference, preempt, **opts):
    params = convert.from_jax(reference["params"], device="cpu")
    return Engine(_cfg(get_config), params, options=EngineOptions(
        preempt=preempt, num_pages=SMALL_POOL, device="cpu",
        adaptive=False, hw=GPU_A100, preempt_mfu=AUTO_MFU, **opts,
        **OPTS))


def test_offload_is_token_exact_against_jax(reference):
    eng = _port_engine(reference, "offload")
    assert _run(eng, reference["prompts"]) == reference["offload"]["tokens"]
    got, want = eng.stats(), reference["offload"]["stats"]
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert got["preempt_offload"] >= 2
    assert eng.kv.offloaded_count == 0 and eng.kv.host_bytes == 0


def test_auto_makes_the_jax_engines_choices(reference):
    eng = _port_engine(reference, "auto", allow_offload=True)
    assert _run(eng, reference["prompts"]) == reference["auto"]["tokens"]
    got, want = eng.stats(), reference["auto"]["stats"]
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert got["preempt_recompute"] >= 1 and got["preempt_offload"] >= 1
    log = eng.preempt_log
    assert [e["mode"] for e in log if "choice" in e] == \
        [e["choice"] for e in log if "choice" in e]
    assert reference["auto"]["tokens"] == reference["offload"]["tokens"]


def test_auto_respects_the_host_gate(reference):
    """Without ``allow_offload`` the gate is the hardware spec's host
    offload and a CUDA device's pinned memory: on the CPU every victim
    is recomputed; ``allow_offload=False`` does the same anywhere."""
    for extra in ({}, {"allow_offload": False}):
        eng = _port_engine(reference, "auto", **extra)
        assert not eng.offload_allowed
        assert _run(eng, reference["prompts"]) == \
            reference["auto"]["tokens"]
        stats = eng.stats()
        assert stats["preempt_offload"] == 0
        assert stats["preempt_recompute"] >= 1
        assert all("choice" not in e for e in eng.preempt_log)


def test_victim_is_lowest_priority_then_youngest(reference):
    params = convert.from_jax(reference["params"], device="cpu")
    eng = Engine(_cfg(get_config), params, options=EngineOptions(
        device="cpu", adaptive=False, **OPTS))
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW, priority=pr)
            for p, pr in zip(reference["prompts"][:3], (0, 1, 0))]
    while any(r.state != RequestState.DECODE for r in reqs):
        eng.step()
    assert eng._pick_victim() is reqs[2]       # priority 0, youngest
    reqs[2].priority = 2
    assert eng._pick_victim() is reqs[0]       # the only priority 0 left
    reqs[0].priority = 3
    assert eng._pick_victim() is reqs[1]


def _cache(device="cpu", num_pages=12):
    cfg = _cfg(get_config)
    return PagedKVCache(cfg, num_pages=num_pages, page_size=4, max_slots=2,
                        max_pages_per_seq=8, dtype=torch.float32,
                        device=device)


def _fill(kv, seed):
    gen = torch.Generator().manual_seed(seed)
    for t in (t for period in kv.pools for layer in period.values()
              for t in layer.values()):
        t.copy_(torch.randn(t.shape, generator=gen))


def _logical(kv, slot):
    """The slot's pages in logical order, every pool."""
    pages = kv.page_table[slot, :kv.pages_for(int(kv.lens[slot]))]
    return [t[torch.as_tensor(pages, dtype=torch.long)].clone()
            for period in kv.pools for layer in period.values()
            for t in layer.values()]


def test_offload_trims_pages_grown_ahead_of_lens():
    kv = _cache()
    kv.alloc_slot(0, 5)                        # 2 pages
    assert kv.grow_slot(0) and kv.grow_slot(0)
    kv.lens[0] = 5
    free = kv.free_pages
    nbytes = kv.offload_slot(0, rid=7)
    assert kv.offloaded_pages(7) == 2
    assert kv.free_pages == free + 4
    assert nbytes == 2 * kv.page_bytes == kv.swap_out_bytes == kv.host_bytes
    assert kv.slot_page_count(0) == 0 and kv.lens[0] == 0
    assert (kv.page_table[0] == 0).all()


def test_offload_then_restore_is_bit_equal_in_place():
    kv = _cache()
    _fill(kv, 0)
    ptrs = [t.data_ptr() for period in kv.pools
            for layer in period.values() for t in layer.values()]
    kv.alloc_slot(0, 11)
    kv.lens[0] = 11
    before = _logical(kv, 0)
    old_pages = list(kv.page_table[0, :3])
    kv.offload_slot(0, rid=3)
    kv.alloc_slot(1, 8)                        # takes the freed pages
    _fill(kv, 1)                               # and scribbles everywhere
    assert kv.can_restore(3)
    assert kv.restore_slot(3, 0, 11) == kv.swap_in_bytes
    assert list(kv.page_table[0, :3]) != old_pages
    assert kv.lens[0] == 11 and kv.offloaded_count == 0
    after = _logical(kv, 0)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert ptrs == [t.data_ptr() for period in kv.pools
                    for layer in period.values() for t in layer.values()]


def test_restore_waits_for_room_and_keeps_the_pages():
    kv = _cache(num_pages=6)                   # sink + 5 pages
    kv.alloc_slot(0, 12)
    kv.lens[0] = 12
    kv.offload_slot(0, rid=1)
    kv.alloc_slot(1, 12)                       # 3 of the 5 pages
    assert not kv.can_restore(1)
    with pytest.raises(AssertionError):
        kv.restore_slot(1, 0, 12)
    assert kv.offloaded_count == 1             # not lost
    kv.free_slot(1)
    kv.restore_slot(1, 0, 12)
    kv.offload_slot(0, rid=2)
    kv.drop_offload(2)
    assert kv.offloaded_count == 0 and kv.free_pages == 5


def test_scheduler_preempt_and_resume_modes():
    """An offload of a request with no cached tokens is a recompute; an
    offloaded request resumes where it stopped (PREFILL or DECODE) once
    its pages fit."""
    from repro_torch.serve.request import Request
    kv = _cache()
    sched = Scheduler(kv, chunk=4)
    a = Request(rid=0, prompt=np.arange(6), max_new_tokens=4)
    b = Request(rid=1, prompt=np.arange(9), max_new_tokens=4)
    for r in (a, b):
        sched.submit(r)
    sched.admit()
    assert sched.preempt(a, "offload") == "recompute"
    assert a.preempt_mode == "recompute" and a.resume_to == "prefill"
    kv.lens[b.slot] = 4                        # one chunk prefilled
    b.prefill_pos = 4
    assert sched.preempt(b, "offload") == "offload"
    assert b.cached_tokens == 4 and b.resume_to == "prefill"
    sched.admit()
    assert a.state == b.state == RequestState.PREFILL
    assert b.prefill_pos == 4 and kv.lens[b.slot] == 4
    assert sched.resume_count == 2 and b.preempt_mode == ""
    b.state = RequestState.DECODE
    assert sched.preempt(b, "offload") == "offload"
    assert b.resume_to == "decode"
    sched.admit()
    assert b.state == RequestState.DECODE and b.slot >= 0
    with pytest.raises(ValueError):
        sched.preempt(a, "never")


def test_extract_and_insert_pages_match_jax():
    """The port's page copies against ``repro.models.kv_cache``'s on the
    same pools (the JAX pools stack the periods on a leading axis)."""
    kv = _cache()
    _fill(kv, 4)
    stacked = [np.stack([period[lk][name].numpy() for period in kv.pools])
               for lk in sorted(kv.pools[0])
               for name in sorted(kv.pools[0][lk])]
    jpools = [jnp.asarray(x) for x in stacked]
    pages = [5, 2, 9]
    jhost = jkv.extract_pages(jpools, pages)
    host = kv_cache.extract_pages(kv.pools, pages)
    assert kv_cache.tree_bytes(host) == jkv.tree_bytes(jhost)
    flat = [np.stack([period[lk][name].numpy() for period in host])
            for lk in sorted(host[0]) for name in sorted(host[0][lk])]
    assert all(np.array_equal(a, b) for a, b in zip(flat, jhost))
    dst = [1, 7, 3]
    jnew = jkv.insert_pages(jpools, dst, jhost)
    assert kv_cache.insert_pages(kv.pools, dst, host) is kv.pools
    got = [np.stack([period[lk][name].numpy() for period in kv.pools])
           for lk in sorted(kv.pools[0]) for name in sorted(kv.pools[0][lk])]
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(got, jnew))
