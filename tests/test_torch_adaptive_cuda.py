"""The adaptive (n, strategy) paths on the card, at moe-gpt3-s's reduced
size: the online controller's wall-clock measure, the launches each
train step makes at its resolved n, and the engine's wall-clock probe.

* The controller measures candidates with CUDA events (``measure`` auto
  on the card) and leaves the parameters and AdamW moments bit-equal.
* Each step of ``train`` launches flash attention once per attention
  layer, and the router and the expert FFN once per chunk of each MoE
  layer at that step's own resolved n (twice under S1-S4), the
  candidate measurements counted apart.
* ``Engine._wallclock_measure`` on a live engine writes only the sink
  page: every other page, the lengths and the page table stay
  bit-equal.

This file imports neither ``jax`` nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_adaptive_cuda.py

Elsewhere it skips: a CUDA kernel has no CPU mode.
"""
import collections
import dataclasses

import pytest
import torch

from repro_torch.kernels import build


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _adaptive_cfg():
    from repro_torch.configs import get_config
    base = get_config("moe-gpt3-s").reduced()
    return dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, num_partitions=0, memory_reuse_strategy="adaptive"))


def _bits(t):
    t = t.detach()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.cuda
def test_wallclock_measure_on_the_card_leaves_the_state_bit_equal():
    _cuda()
    from repro_torch.data import VaryingSyntheticTokens
    from repro_torch.models.module import leaves
    from repro_torch.runtime import (AdaptiveController, AdaptiveOptions,
                                     TrainOptions, train)
    from repro_torch.runtime.train_loop import _to_device
    cfg = _adaptive_cfg()
    opts = TrainOptions(lr=1e-3, warmup=0, total_steps=4)
    ds = VaryingSyntheticTokens(cfg, (4,), seq=64, seed=1)
    state, _ = train(cfg, steps=1, batch_source=ds, opts=opts,
                     adaptive=False)                 # moments non-zero
    ctl = AdaptiveController(cfg, opts, AdaptiveOptions(candidates=(1, 2,
                                                                    4)))
    assert ctl.resolver.measure_fn == ctl._wallclock_measure
    tensors = leaves(state["params"]) + leaves(state["opt"]["m"]) \
        + leaves(state["opt"]["v"])
    before = [_bits(t).clone() for t in tensors]
    _, info = ctl.step_fn(state, _to_device(ds.batch_at(1), "cuda"), 1)
    assert ctl.resolver.candidates_measured == 3
    assert info["n"] in (1, 2, 4)
    for t, b in zip(tensors, before):
        assert torch.equal(_bits(t), b)


@pytest.mark.cuda
def test_adaptive_train_launches_per_step_at_the_resolved_n():
    _cuda()
    from repro_torch.core.pipeline_moe import _resolve_partitions
    from repro_torch.data import VaryingSyntheticTokens
    from repro_torch.runtime import (AdaptiveController, AdaptiveOptions,
                                     TrainOptions, train)
    cfg = _adaptive_cfg()
    trace, seq = (4, 2, 4), 64
    opts = TrainOptions(lr=1e-3, warmup=0, total_steps=3)
    measured = collections.Counter()
    ctl = AdaptiveController(cfg, opts, AdaptiveOptions(candidates=(1, 2,
                                                                    4)))
    inner = ctl.resolver.measure_fn

    def measure(b, n, strategy):
        launched = collections.Counter(build.LAUNCHES)
        seconds = inner(b, n, strategy)
        measured.update(collections.Counter(build.LAUNCHES) - launched)
        return seconds

    ctl.resolver.measure_fn = measure
    snaps = []
    build.reset_launches()
    _, hist = train(cfg, steps=len(trace), opts=opts, adaptive=ctl,
                    batch_source=VaryingSyntheticTokens(cfg, trace, seq),
                    heartbeat=lambda s, m: snaps.append(
                        (collections.Counter(build.LAUNCHES),
                         collections.Counter(measured))))
    assert sum(measured.values()) > 0
    n_moe = cfg.num_periods * sum(r["moe"] for r in cfg.layer_roles())
    prev = (collections.Counter(), collections.Counter())
    for h, snap in zip(hist, snaps):
        rcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_partitions=h["n"],
            memory_reuse_strategy=h["strategy"]))
        chunks = _resolve_partitions(rcfg, trace[h["step"]] * seq, "train")
        per = n_moe * chunks * (1 if h["strategy"] == "none" else 2)
        want = {"flash_attention": cfg.num_layers, "topk_router": per,
                "grouped_ffn": per}
        got = {k: (snap[0][k] - prev[0][k]) - (snap[1][k] - prev[1][k])
               for k in want}
        assert got == want, (h["step"], h["n"], h["strategy"])
        prev = snap


@pytest.mark.cuda
def test_engine_probe_on_the_card_writes_only_the_sink():
    _cuda()
    from repro_torch.core import Strategy
    from repro_torch.models.module import leaves
    from repro_torch.serve import Engine, EngineOptions
    from repro_torch.serve.paged_kv import SINK_PAGE
    cfg = _adaptive_cfg()
    eng = Engine(cfg, options=EngineOptions(
        page_size=4, max_slots=2, max_seq_len=64, chunk=16), seed=0)
    assert eng.measure == "wallclock"
    reqs = [eng.submit(list(range(1, n)), max_new_tokens=6)
            for n in (30, 11)]
    for _ in range(6):
        eng.step()
    pools = leaves(eng.kv.pools)
    before = [_bits(t).clone() for t in pools]
    lens, table = eng.kv.lens.copy(), eng.kv.page_table.copy()
    assert eng._wallclock_measure(16, 2, Strategy.S4) > 0
    torch.cuda.synchronize()
    for t, b in zip(pools, before):
        assert torch.equal(_bits(t)[SINK_PAGE + 1:], b[SINK_PAGE + 1:])
    assert (eng.kv.lens == lens).all() and (eng.kv.page_table == table).all()
    eng.run_until_idle()
    assert all(len(r.output) == 6 for r in reqs)
    assert eng.stats()["resolutions"]
