"""The port's online adaptive (n, strategy) controller and the train
launcher, on the CPU at moe-gpt3-s's reduced size (2 layers, fp32).

* Counterparts of ``tests/test_adaptive_controller.py``'s tests: step
  functions built once per (n, strategy, shape), the retune timer (also
  under shape churn), rejection of an unpipelined config, an incremental
  resolver, offload masking, and ``train`` end to end.
* The wall-clock measure leaves the parameters and AdamW moments
  bit-equal.
* The train launcher: its offline resolve prints the ``(n, strategy)``
  the JAX package's ``resolve`` gives for the same tokens and spec, and
  ``--adaptive`` trains through the controller.

``train(adaptive=...)`` against the JAX package's ``train`` is in
``test_torch_adaptive_train.py``, the engine's side in
``test_torch_adaptive_engine.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import selector as jsel
from repro.core import types as jtypes
from repro_torch.configs import get_config
from repro_torch.core import Resolver, Strategy
from repro_torch.core.types import GPU_H100, HardwareSpec, Interference
from repro_torch.data import VaryingSyntheticTokens
from repro_torch.models.module import leaves
from repro_torch.runtime import (AdaptiveController, AdaptiveOptions,
                                 TrainOptions, init_state, train)
from repro_torch.runtime.train_loop import _to_device

# the JAX package's TPU_V5E, field by field, for the tests ported from
# tests/test_adaptive_controller.py
V5E = HardwareSpec(**dict(
    {f.name: getattr(jtypes.TPU_V5E, f.name)
     for f in dataclasses.fields(jtypes.TPU_V5E)},
    interference=Interference(**dataclasses.asdict(
        jtypes.TPU_V5E.interference))))


def _adaptive(get):
    base = get("moe-gpt3-s").reduced()
    return dataclasses.replace(
        base, num_layers=2, compute_dtype="float32",
        moe=dataclasses.replace(base.moe, num_partitions=0,
                                memory_reuse_strategy="adaptive"))


@pytest.fixture(scope="module")
def adaptive_cfg():
    return _adaptive(get_config)


@pytest.fixture(scope="module")
def cpu_state(adaptive_cfg):
    return init_state(adaptive_cfg, TrainOptions(), device="cpu")


def _fake_clock(b, n, strategy):
    """``tests/test_adaptive_controller.py``'s fake clock."""
    ideal = max(1, b // 256)
    return abs(n - ideal) + 0.01 * n


def _batch(ds, step):
    return _to_device(ds.batch_at(step), "cpu")


def test_rejit_only_on_new_config(adaptive_cfg, cpu_state):
    aopts = AdaptiveOptions(measure_fn=_fake_clock, candidates=(1, 2, 4, 8))
    ctl = AdaptiveController(adaptive_cfg, TrainOptions(), aopts)
    trace = [4, 8, 4, 16, 8, 4, 16, 8, 4, 4, 8, 16]
    ds = VaryingSyntheticTokens(adaptive_cfg, trace, seq=32, seed=0)
    keys = set()
    for step in range(len(trace)):
        batch = _batch(ds, step)
        (grads_of, update), info = ctl.step_fn(cpu_state, batch, step)
        assert callable(grads_of) and callable(update)
        assert info["n"] >= 1 and info["strategy"] != "adaptive"
        keys.add((info["n"], info["strategy"], ctl._shape_key(batch)))
    assert ctl.rejit_count == len(keys)
    assert ctl.resolver.search_calls <= len(set(trace))
    assert ctl.retune_count > len(set(trace))


def test_retune_every_remeasures_without_rejit(adaptive_cfg, cpu_state):
    aopts = AdaptiveOptions(measure_fn=_fake_clock, candidates=(1, 2, 4),
                            retune_every=2)
    ctl = AdaptiveController(adaptive_cfg, TrainOptions(), aopts)
    batch = _batch(VaryingSyntheticTokens(adaptive_cfg, [8], seq=32), 0)
    for step in range(8):
        ctl.step_fn(cpu_state, batch, step)
    assert ctl.retune_count == 4                 # steps 0, 2, 4, 6
    assert ctl.resolver.search_calls == 4        # each one re-measured
    assert ctl.rejit_count == 1                  # same config -> cached


def test_retune_timer_fires_under_shape_churn(adaptive_cfg, cpu_state):
    aopts = AdaptiveOptions(measure_fn=_fake_clock, candidates=(1, 2, 4),
                            retune_every=2)
    ctl = AdaptiveController(adaptive_cfg, TrainOptions(), aopts)
    trace = [4, 8] * 4
    ds = VaryingSyntheticTokens(adaptive_cfg, trace, seq=32, seed=0)
    for step in range(len(trace)):
        ctl.step_fn(cpu_state, _batch(ds, step), step)
    # 2 initial searches + 3 timer resets x 2 sizes
    assert ctl.resolver.search_calls == 8
    assert ctl.rejit_count == 2


def test_step_cache_is_an_lru_bounded_by_cache_size(adaptive_cfg,
                                                    cpu_state):
    aopts = AdaptiveOptions(measure_fn=_fake_clock, candidates=(1, 2),
                            cache_size=2)
    ctl = AdaptiveController(adaptive_cfg, TrainOptions(), aopts)
    trace = [4, 8, 16, 4]
    ds = VaryingSyntheticTokens(adaptive_cfg, trace, seq=32, seed=0)
    for step in range(len(trace)):
        ctl.step_fn(cpu_state, _batch(ds, step), step)
    assert len(ctl._step_cache) == 2
    assert ctl.rejit_count == 4                  # batch 4 was evicted


def test_controller_rejects_unpipelined_config(adaptive_cfg):
    cfg = dataclasses.replace(adaptive_cfg, moe=dataclasses.replace(
        adaptive_cfg.moe, pipeline=False))
    with pytest.raises(ValueError):
        AdaptiveController(cfg, TrainOptions())
    with pytest.raises(ValueError, match="measure"):
        AdaptiveController(adaptive_cfg, TrainOptions(),
                           AdaptiveOptions(measure="sometimes"),
                           device="cpu")


def test_resolver_is_incremental(adaptive_cfg):
    r = Resolver(adaptive_cfg, ep_size=8, hw=V5E, measure_fn=_fake_clock)
    cfg1 = r.resolve(4096)
    calls = r.search_calls
    cfg2 = r.resolve(4096)                       # hash-table hit
    assert (cfg1.moe.num_partitions, cfg1.moe.memory_reuse_strategy) == \
        (cfg2.moe.num_partitions, cfg2.moe.memory_reuse_strategy)
    assert r.search_calls == calls
    assert r.retunes == 2 and r.candidates_measured == calls * 6


def test_resolve_masks_offload_strategies(adaptive_cfg):
    r = Resolver(adaptive_cfg, ep_size=8, hw=V5E, measure_fn=_fake_clock,
                 allow_offload=False)
    for tokens in (512, 4096, 65536):
        cfg = r.resolve(tokens)
        assert cfg.moe.memory_reuse_strategy == "s4"
        assert cfg.moe.num_partitions >= 1


def test_train_adaptive_end_to_end(adaptive_cfg):
    opts = TrainOptions(lr=1e-3, warmup=2, total_steps=6)
    aopts = AdaptiveOptions(measure_fn=_fake_clock, candidates=(1, 2, 4))
    ctl = AdaptiveController(adaptive_cfg, opts, aopts)
    ds = VaryingSyntheticTokens(adaptive_cfg, (4, 8, 4, 8, 4, 8), seq=16)
    state, hist = train(adaptive_cfg, steps=6, batch_source=ds, opts=opts,
                        adaptive=ctl, device="cpu")
    assert state["step"] == 6
    assert ctl.rejit_count == 2                  # two shapes, one (n, strat)
    assert ctl.resolver.search_calls == 2        # one per distinct size
    for h in hist:
        assert h["n"] >= 1 and h["strategy"] != "adaptive"
        assert np.isfinite(h["loss"])
    assert "retune_time_s" in hist[0]


def test_train_forms_of_adaptive(adaptive_cfg):
    """``None`` on a placeholder config, ``True`` and an
    ``AdaptiveOptions`` all train through the controller (simulator
    measure on the CPU); ``False`` runs the placeholders as n 4, none."""
    ds = VaryingSyntheticTokens(adaptive_cfg, (2,), seq=8)
    for form in (None, True, AdaptiveOptions(retune_every=1)):
        _, hist = train(adaptive_cfg, steps=2, batch_source=ds,
                        adaptive=form, device="cpu")
        assert all(h["strategy"] == "s4" and h["n"] >= 1 for h in hist)
    _, hist = train(adaptive_cfg, steps=1, batch_source=ds, adaptive=False,
                    device="cpu")
    assert "n" not in hist[0]


def test_wallclock_measure_leaves_the_state_bit_equal(adaptive_cfg):
    opts = TrainOptions(lr=1e-3, warmup=0, total_steps=4)
    ds = VaryingSyntheticTokens(adaptive_cfg, (2,), seq=16, seed=1)
    state, _ = train(adaptive_cfg, steps=1, batch_source=ds, opts=opts,
                     adaptive=False, device="cpu")     # moments non-zero
    ctl = AdaptiveController(adaptive_cfg, opts, AdaptiveOptions(
        measure="wallclock", candidates=(1, 2), measure_steps=1),
        device="cpu")
    assert ctl.resolver.measure_fn == ctl._wallclock_measure
    tensors = leaves(state["params"]) + leaves(state["opt"]["m"]) \
        + leaves(state["opt"]["v"])
    before = [t.detach().clone() for t in tensors]
    _, info = ctl.step_fn(state, _batch(ds, 1), 1)
    assert ctl.resolver.candidates_measured == 2
    assert info["n"] in (1, 2)
    for t, b in zip(tensors, before):
        assert torch.equal(t.detach().view(torch.int32), b.view(torch.int32))
    assert all(p.grad is None for p in leaves(state["params"]))
    assert ctl._probe is None


def test_measure_auto_needs_the_card_unless_the_cpu_is_asked(adaptive_cfg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: auto measures on the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdaptiveController(adaptive_cfg, TrainOptions())
    ctl = AdaptiveController(adaptive_cfg, TrainOptions(), device="cpu")
    assert ctl.resolver.measure_fn is None       # the simulator
    assert ctl.aopts.hw is GPU_H100


@pytest.mark.parametrize("hw", ["auto", "cpu-host", "gpu-h100"])
def test_train_launcher_resolves_offline_as_jax(capsys, hw):
    from repro_torch.core.types import resolve_hw
    from repro_torch.launch import train as launcher
    hist = launcher.main(["--reduced", "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seq", "16", "--hw", hw])
    out = capsys.readouterr().out
    spec = resolve_hw(hw)
    jspec = jtypes.HardwareSpec(**dict(
        {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)},
        interference=jtypes.Interference(**dataclasses.asdict(
            spec.interference))))
    want = jsel.resolve(jax_config("moe-gpt3-s").reduced(),
                        local_tokens=32, ep_size=1, hw=jspec)
    assert (f"MPipeMoE: n={want.moe.num_partitions} "
            f"strategy={want.moe.memory_reuse_strategy}") in out
    assert len(hist) == 2 and "n" not in hist[-1]


def test_train_launcher_adaptive_on_cpu(capsys):
    from repro_torch.launch import train as launcher
    hist = launcher.main(["--reduced", "--device", "cpu", "--steps", "3",
                          "--batch", "2", "--seq", "16", "--adaptive",
                          "--retune-every", "2"])
    out = capsys.readouterr().out
    assert "MPipeMoE: online adaptive (n, strategy) (retune_every=2)" in out
    assert f"adaptive: n={hist[-1]['n']} strategy=" \
           f"{hist[-1]['strategy']}" in out
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert "retune_time_s" in hist[2]            # the timer at step 2
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert isinstance(Strategy(hist[-1]["strategy"]), Strategy)
