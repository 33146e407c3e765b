"""The engine's per-bucket adaptive (n, strategy) prefill and the serve
launcher, on the CPU at moe-gpt3-s's reduced size (fp32).

* ``Engine`` with ``adaptive=True`` against the JAX ``Engine``, both on
  the same converted weights and the same hardware spec (handed over
  field by field), gather decode, greedy: equal tokens and equal
  per-bucket ``resolutions``, once with ``measure="simulate"`` and once
  with a fake clock under which the buckets resolve to different n.
* ``_wallclock_measure`` on a live engine leaves every non-sink page,
  the lengths and the page table bit-equal.
* The serve launcher resolves per bucket by default and prints the
  resolutions; ``--num-partitions N`` fixes n.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import types as jtypes
from repro.serve import Engine as JaxEngine
from repro.serve import EngineOptions as JaxOptions
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import Strategy
from repro_torch.core.types import GPU_H100
from repro_torch.launch import serve as launcher
from repro_torch.models.module import leaves
from repro_torch.serve import Engine, EngineOptions
from repro_torch.serve.paged_kv import SINK_PAGE
from test_torch_engine import MAX_NEW, OPTS, _cfg, _np_params, _prompts, _run

JAX_H100 = jtypes.HardwareSpec(**dict(
    {f.name: getattr(GPU_H100, f.name)
     for f in dataclasses.fields(GPU_H100)},
    interference=jtypes.Interference(**dataclasses.asdict(
        GPU_H100.interference))))


def _fake_clock(b, n, strategy):
    """Optimum n = bucket / 8: bucket 8 -> n 1, bucket 16 -> n 2."""
    return abs(n - max(1, b // 8)) + 0.01 * n


MEASURES = {"simulate": dict(measure="simulate"),
            "fake_clock": dict(measure_fn=_fake_clock)}


@pytest.fixture(scope="module")
def reference():
    """JAX engine tokens and resolutions for each measure, built once."""
    cfg = _cfg(jax_config)
    params_np = _np_params(cfg, 0)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    prompts = _prompts(cfg.vocab_size)
    out = {"params": params_np, "prompts": prompts}
    for name, kw in MEASURES.items():
        eng = JaxEngine(cfg, params, options=JaxOptions(
            attn_kernel="gather", adaptive=True, hw=JAX_H100,
            preempt="never", num_pages=0, **kw, **OPTS))
        out[name] = (_run(eng, prompts), eng.stats()["resolutions"])
    return out


@pytest.mark.parametrize("measure", sorted(MEASURES))
def test_adaptive_engine_equals_jax(reference, measure):
    params = convert.from_jax(reference["params"], device="cpu")
    eng = Engine(_cfg(get_config), params, options=EngineOptions(
        device="cpu", adaptive=True, hw=GPU_H100, preempt="never",
        **MEASURES[measure], **OPTS))
    tokens, resolutions = reference[measure]
    assert _run(eng, reference["prompts"]) == tokens
    stats = eng.stats()
    assert stats["resolutions"] == resolutions
    assert stats["prefill_builds"] >= len(resolutions)
    if measure == "fake_clock":
        assert resolutions == {"16": [2, "s4"], "8": [1, "s4"]}
        assert eng.adaptive.resolver.candidates_measured > 0
    assert all(len(t) == MAX_NEW for t in tokens)


def test_wallclock_probe_writes_only_the_sink(reference):
    params = convert.from_jax(reference["params"], device="cpu")
    eng = Engine(_cfg(get_config), params, options=EngineOptions(
        device="cpu", measure="wallclock", preempt="never",
        measure_steps=1, **dict(OPTS, min_bucket=16)))
    assert eng.measure == "wallclock"
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW)
            for p in reference["prompts"]]
    for _ in range(5):
        eng.step()
    pools = leaves(eng.kv.pools)
    before = [t.clone() for t in pools]
    lens, table = eng.kv.lens.copy(), eng.kv.page_table.copy()
    assert lens.any() and (table != SINK_PAGE).any()
    seconds = eng._wallclock_measure(16, 2, Strategy.S4)
    assert seconds > 0
    for t, b in zip(pools, before):
        assert torch.equal(t[SINK_PAGE + 1:], b[SINK_PAGE + 1:])
    assert any(not torch.equal(t[SINK_PAGE], b[SINK_PAGE])
               for t, b in zip(pools, before))          # the probe ran
    assert (eng.kv.lens == lens).all() and (eng.kv.page_table == table).all()
    eng.run_until_idle()
    assert all(len(r.output) == MAX_NEW for r in reqs)
    assert eng.adaptive.resolver.candidates_measured > 0


def test_engine_is_freed_without_a_collection(reference):
    """The wall-clock measure holds the engine weakly: dropping the last
    reference frees it, its params and its pools at once."""
    import gc
    import weakref
    params = convert.from_jax(reference["params"], device="cpu")
    eng = Engine(_cfg(get_config), params, options=EngineOptions(
        device="cpu", measure="wallclock", measure_steps=1,
        **dict(OPTS, min_bucket=16)))
    _run(eng, reference["prompts"][:1])
    assert eng.stats()["measure"] == "wallclock"
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_engine_without_adaptive_keeps_the_configs_n(reference):
    params = convert.from_jax(reference["params"], device="cpu")
    eng = Engine(_cfg(get_config), params, options=EngineOptions(
        device="cpu", adaptive=False, measure="wallclock", **OPTS))
    _run(eng, reference["prompts"][:1])
    assert {r[0] for r in eng.stats()["resolutions"].values()} == {2}
    assert eng.adaptive.resolver.candidates_measured == 0
    with pytest.raises(ValueError, match="measure"):
        EngineOptions(measure="sometimes").check()


@pytest.mark.parametrize("num_partitions", [None, 2])
def test_serve_launcher_prints_the_resolutions(capsys, num_partitions):
    argv = ["--engine", "--arch", "moe-gpt3-s", "--reduced", "--device",
            "cpu", "--requests", "2", "--prompt-len", "5:20", "--gen", "3",
            "--seed", "1", "--hw", "gpu-h100", "--measure", "simulate"]
    if num_partitions:
        argv += ["--num-partitions", str(num_partitions)]
    stats = launcher.main(argv)
    out = capsys.readouterr().out
    assert "hw spec: gpu-h100" in out
    assert stats["requests_done"] == 2 and stats["resolutions"]
    for bucket, (n, strat) in stats["resolutions"].items():
        assert f"  bucket {int(bucket):4d} -> n={n} strategy={strat}" in out
        assert n == (num_partitions or 1) and strat == "s4"
