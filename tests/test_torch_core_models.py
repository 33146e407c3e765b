"""The analytic core of the port against the JAX package's, on the CPU.

``repro_torch.core``'s ``types``, ``memory_model``, ``perf_model``,
``pipeline_sim``, ``granularity`` and ``selector`` are pure Python
arithmetic, copied from ``repro.core``: their outputs must be *equal*
(``==``) to the reference's, not close. A difference would be a change
in the order of operations. The grid: the five strategies; b in
{64, 2048, 8192, 65536}; (m, h) of the paper's three models; k in
{1, 6}; ep in {1, 8, 16}; dp in {1, 16}; gated and not; and four
hardware specs — the reference's ``TPU_V5E``, ``GPU_A100`` and
``CPU_HOST`` and the port's ``GPU_H100``, each handed to the other side
field by field.
"""
import dataclasses
import itertools
import random

import pytest

from repro.configs import get_config as jax_config
from repro.core import granularity as jgran
from repro.core import memory_model as jmem
from repro.core import perf_model as jperf
from repro.core import pipeline_sim as jsim
from repro.core import selector as jsel
from repro.core import types as jtypes
from repro_torch.configs import get_config
from repro_torch.core import granularity as tgran
from repro_torch.core import memory_model as tmem
from repro_torch.core import perf_model as tperf
from repro_torch.core import pipeline_sim as tsim
from repro_torch.core import selector as tsel
from repro_torch.core import types as ttypes

B = (64, 2048, 8192, 65536)
MH = ((768, 3072), (1024, 4096), (2048, 8192))     # the paper's models
K = (1, 6)
EP = (1, 8, 16)
DP = (1, 16)
GATED = (False, True)
WORKLOADS = [dict(b=b, m=m, h=h, k=k, ep=ep, dp=dp, gated=g)
             for b, (m, h), k, ep, dp, g
             in itertools.product(B, MH, K, EP, DP, GATED)]


def _spec(spec, mod):
    """``spec`` rebuilt as ``mod``'s HardwareSpec, field by field."""
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(spec)}
    fields["interference"] = mod.Interference(
        **dataclasses.asdict(spec.interference))
    return mod.HardwareSpec(**fields)


HW = {"tpu-v5e": (jtypes.TPU_V5E, _spec(jtypes.TPU_V5E, ttypes)),
      "gpu-a100": (jtypes.GPU_A100, _spec(jtypes.GPU_A100, ttypes)),
      "cpu-host": (jtypes.CPU_HOST, _spec(jtypes.CPU_HOST, ttypes)),
      "gpu-h100": (_spec(ttypes.GPU_H100, jtypes), ttypes.GPU_H100)}
PAIRS = [(s, ttypes.Strategy(s.value)) for s in jtypes.Strategy]


def _workloads():
    return [(jperf.MoEWorkload(**kw), tperf.MoEWorkload(**kw))
            for kw in WORKLOADS]


def test_types_equal_jax():
    assert {s.value: q for s, q in jtypes.Q_TABLE.items()} == \
        {s.value: q for s, q in ttypes.Q_TABLE.items()}
    for js, ts in PAIRS:
        assert (js.offloads, js.saves, js.needs_host) == \
            (ts.offloads, ts.saves, ts.needs_host)
    assert dataclasses.asdict(jtypes.Interference()) == \
        dataclasses.asdict(ttypes.Interference())
    for name in ("gpu-a100", "cpu-host"):
        assert dataclasses.asdict(jtypes.HW_SPECS[name]) == \
            dataclasses.asdict(ttypes.HW_SPECS[name])
    assert ttypes.HardwareSpec() == ttypes.GPU_H100
    assert ttypes.GPU_H100.name == "gpu-h100"


@pytest.mark.parametrize("hw", sorted(HW))
def test_stream_times_cost_and_q_scaled_equal_jax(hw):
    jhw, thw = HW[hw]
    for (jw, tw), (js, ts) in itertools.product(_workloads(), PAIRS):
        assert jperf._q_scaled(js, jw) == tperf._q_scaled(ts, tw)
        assert (jw.v_comp, jw.v_comm, jw.v_mem, jw.weight_psum_bytes) == \
            (tw.v_comp, tw.v_comm, tw.v_mem, tw.weight_psum_bytes)
        assert (jhw.mu(js), jhw.eta(js)) == (thw.mu(ts), thw.eta(ts))
        for n in (1, 4, 32):
            assert jperf.stream_times(js, jw, jhw, n) == \
                tperf.stream_times(ts, tw, thw, n)
            assert jperf.cost(js, jw, jhw, n) == tperf.cost(ts, tw, thw, n)


@pytest.mark.parametrize("hw", sorted(HW))
def test_all_costs_and_select_strategy_equal_jax(hw):
    jhw, thw = HW[hw]
    jno = dataclasses.replace(jhw, has_host_offload=False)
    tno = dataclasses.replace(thw, has_host_offload=False)
    allows = (None, ["s3", "s4"], ["none", "s1"], ["s2"])
    for jw, tw in _workloads():
        for n in (1, 4, 32):
            assert jperf.all_costs(jw, jhw, n) == tperf.all_costs(tw, thw, n)
            for allow in allows:
                ja = allow and [jtypes.Strategy(a) for a in allow]
                ta = allow and [ttypes.Strategy(a) for a in allow]
                for jh, th in ((jhw, thw), (jno, tno)):
                    assert jperf.select_strategy(jw, jh, n, ja).value == \
                        tperf.select_strategy(tw, th, n, ta).value


@pytest.mark.parametrize("hw", sorted(HW))
def test_simulate_and_sweep_partitions_equal_jax(hw):
    jhw, thw = HW[hw]
    for i, (jw, tw) in enumerate(_workloads()):
        for (js, ts), n, bwd in itertools.product(PAIRS, (1, 4), (True,
                                                                   False)):
            assert jsim.simulate(jw, jhw, n, js, bwd) == \
                tsim.simulate(tw, thw, n, ts, bwd)
        js, ts = PAIRS[i % len(PAIRS)]
        assert jsim.sweep_partitions(jw, jhw, strategy=js) == \
            tsim.sweep_partitions(tw, thw, strategy=ts)
    with pytest.raises(ValueError):
        tsim.simulate(tw, thw, 0)


def test_memory_model_equal_jax():
    for b, (m, h), e, n, bp in itertools.product(
            B, MH, (8, 64), (1, 2, 4, 8, 32), (2, 4.0)):
        ja = jmem.MoEMemory(b=b, m=m, h=h, e=e, n=n, bytes_per=bp)
        ta = tmem.MoEMemory(b=b, m=m, h=h, e=e, n=n, bytes_per=bp)
        assert ja.totals() == ta.totals()
        assert (ja.phi, ja.m_ms, ja.m_act, ja.m_buf, ja.delta_act) == \
            (ta.phi, ta.m_ms, ta.m_act, ta.m_buf, ta.delta_act)
    assert tmem.MoEMemory(b=8192, m=768, h=3072, e=64, n=1).phi < 0
    for tokens, held, fpt, shards, mfu, eta in itertools.product(
            (0, 17, 4096), (0, 2 ** 20, 3 * 10 ** 9), (1e6, 2.4e9),
            (1, 4), (0.5, 1.0), (0.6, 0.95)):
        for jhw, thw in HW.values():
            kw = dict(tokens_cached=tokens, bytes_held=held,
                      flops_per_token=fpt, flops=thw.flops,
                      host_bw=thw.host_bw, mfu=mfu, eta=eta,
                      link_shards=shards)
            ja, ta = jmem.PreemptionCost(**kw), tmem.PreemptionCost(**kw)
            assert (ja.recompute_s, ja.offload_s, ja.choice) == \
                (ta.recompute_s, ta.offload_s, ta.choice)
            ck = dict(mfu=mfu, eta=eta, link_shards=shards)
            assert jmem.crossover_tokens(held, fpt, thw.flops, thw.host_bw,
                                         **ck) == \
                tmem.crossover_tokens(held, fpt, thw.flops, thw.host_bw,
                                      **ck)


def _step_measure(b, n):
    """``tests/test_granularity.py``'s synthetic measure."""
    ideal = max(1, b // 1024)
    return abs(n - ideal) + 0.01 * n


def _sim_measure(sim, perf, types, hw):
    """``tests/test_granularity.py``'s simulator measure (S4, ep 16)."""
    def measure(b, n):
        w = perf.MoEWorkload(b=b, m=768, h=3072, k=1, ep=16)
        return sim.simulate(w, hw, n, types.Strategy.S4)
    return measure


_rng = random.Random(17)
TRACES = {
    "cache": ((1, 2, 4, 8, 16), [4096, 4096]),
    "range_reuse": ((1, 2, 4, 8, 16), [4200, 4800, 4500, 4200]),
    "disjoint": ((1, 2, 4, 8, 16), [512, 2048, 9000, 1024, 17000, 3000,
                                    700]),
    "simulator": ((1, 2, 4, 8, 16, 32), [256, 65536, 4096, 256]),
    "seeded": ((1, 2, 4, 8, 16, 32),
               [_rng.randrange(1, 70000) for _ in range(120)]),
}


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_granularity_searcher_equal_jax(trace):
    cands, bs = TRACES[trace]
    if trace == "simulator":
        jm = _sim_measure(jsim, jperf, jtypes, jtypes.TPU_V5E)
        tm = _sim_measure(tsim, tperf, ttypes, HW["tpu-v5e"][1])
    else:
        jm = tm = _step_measure
    js = jgran.GranularitySearcher(jm, candidates=cands)
    ts = tgran.GranularitySearcher(tm, candidates=cands)
    for i, b in enumerate(bs):
        assert js.best_n(b) == ts.best_n(b)
        assert js.ranges == ts.ranges
        assert js.search_calls == ts.search_calls
        if i == len(bs) // 2:                     # a retune mid-trace
            js.reset()
            ts.reset()
            assert ts.ranges == ()
    assert js.search_calls == ts.search_calls


def _fake_clock(b, n, strategy):
    """``tests/test_adaptive_controller.py``'s fake clock."""
    ideal = max(1, b // 256)
    return abs(n - ideal) + 0.01 * n


def _cfgs(arch, reduced):
    def adaptive(cfg):
        cfg = cfg.reduced() if reduced else cfg
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_partitions=0, memory_reuse_strategy="adaptive"))
    return adaptive(jax_config(arch)), adaptive(get_config(arch))


RESOLVER_CASES = [(arch, measure, offload)
                  for arch in ("moe-gpt3-s", "moe-bert-l", "moe-gpt3-xl")
                  for measure in ("fake_clock", "simulate")
                  for offload in (None, False)]


@pytest.mark.parametrize("arch,measure,offload", RESOLVER_CASES)
def test_resolver_equal_jax(arch, measure, offload):
    jcfg, tcfg = _cfgs(arch, reduced=False)
    fn = _fake_clock if measure == "fake_clock" else None
    jhw, thw = HW["tpu-v5e"]
    jr = jsel.Resolver(jcfg, ep_size=8, hw=jhw, measure_fn=fn,
                       allow_offload=offload)
    tr = tsel.Resolver(tcfg, ep_size=8, hw=thw, measure_fn=fn,
                       allow_offload=offload)
    tokens = [512, 4096, 512, 65536, 2048, 4096, 300, 65536, 8192]
    for i, t in enumerate(tokens):
        refresh = i == 6
        a, b = jr.resolve(t, refresh=refresh), tr.resolve(t, refresh=refresh)
        assert (a.moe.num_partitions, a.moe.memory_reuse_strategy) == \
            (b.moe.num_partitions, b.moe.memory_reuse_strategy)
        assert jr.search_calls == tr.search_calls
    assert tr.retunes == len(tokens)
    if fn is not None:
        assert tr.candidates_measured > 0
    if offload is False:
        assert b.moe.memory_reuse_strategy == "s4"


@pytest.mark.parametrize("hw", sorted(HW))
def test_one_shot_resolve_equal_jax(hw):
    jhw, thw = HW[hw]
    for arch in ("moe-gpt3-s", "moe-bert-l", "moe-gpt3-xl"):
        jcfg, tcfg = _cfgs(arch, reduced=False)
        for tokens, ep, dp in itertools.product((64, 2048, 8192), (1, 8),
                                                (1, 16)):
            a = jsel.resolve(jcfg, local_tokens=tokens, ep_size=ep, hw=jhw,
                             dp=dp)
            b = tsel.resolve(tcfg, local_tokens=tokens, ep_size=ep, hw=thw,
                             dp=dp)
            assert dataclasses.asdict(a.moe) == dataclasses.asdict(b.moe)
            jw = jsel.moe_workload(jcfg, tokens, ep, dp=dp)
            tw = tsel.moe_workload(tcfg, tokens, ep, dp=dp)
            assert dataclasses.asdict(jw) == dataclasses.asdict(tw)
            for offload in (None, True, False):
                assert jsel.resolve_strategy(jcfg, jw, jhw, offload) == \
                    tsel.resolve_strategy(tcfg, tw, thw, offload)


def test_resolve_hw(monkeypatch):
    import torch
    from repro.core.strategies import host_offload_supported as jax_offload
    from repro_torch.core.strategies import host_offload_supported
    for name, spec in ttypes.HW_SPECS.items():
        assert ttypes.resolve_hw(name) is spec
    assert sorted(ttypes.HW_SPECS) == ["cpu-host", "gpu-a100", "gpu-h100"]
    with pytest.raises(KeyError, match=r"unknown hw 'tpu-v5e'; one of "
                       r"\['cpu-host', 'gpu-a100', 'gpu-h100'\] or 'auto'"):
        ttypes.resolve_hw("tpu-v5e")
    # on this CPU: no CUDA, as the JAX package sees no pinned host memory
    assert ttypes.resolve_hw("auto") is ttypes.CPU_HOST
    assert host_offload_supported() is False
    assert host_offload_supported() == jax_offload()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ttypes.resolve_hw("auto") is ttypes.GPU_H100
    assert host_offload_supported() is True
