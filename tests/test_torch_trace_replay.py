"""The Poisson trace and its replay against the JAX package's
``repro.serve.trace``:

* ``poisson_trace`` is bit-equal to the JAX one for the same arguments
  (arrival times, prompts, generation lengths);
* ``replay`` of one trace gives the JAX engine's greedy tokens on
  reduced moe-gpt3-s in fp32 (capacity factor 8.0) with the same
  converted weights, and so does ``run_poisson`` (built, warmed up,
  ``on_engine`` called after the warmup, then replayed);
* with ``time_scale > 0`` nothing is submitted before its scheduled
  arrival and each request's latency clock starts there;
* the serve launcher's ``--rate`` path prints the JAX launcher's replay
  lines.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.serve import Engine as JaxEngine
from repro.serve import EngineOptions as JaxOptions
from repro.serve import trace as jtrace
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.serve import Engine, EngineOptions
from repro_torch.serve import trace as ttrace

from test_torch_engine_preempt import _cfg, _np_params

OPTS = dict(page_size=4, max_slots=3, max_seq_len=64, chunk=16,
            min_bucket=8, adaptive=False, attn_kernel="gather")
TRACE = dict(rate=40.0, prompt_max=24, gen_max=8, seed=3)
N = 6


def _trace(mod, vocab, **kw):
    kw = dict(TRACE, **kw)
    return mod.poisson_trace(N, rate=kw["rate"], vocab_size=vocab,
                             prompt_len_range=(4, kw["prompt_max"]),
                             gen_len_range=(2, kw["gen_max"]),
                             seed=kw["seed"])


@pytest.mark.parametrize("kw", [dict(), dict(seed=0, rate=2.5),
                                dict(seed=11, prompt_max=96, gen_max=48)])
def test_poisson_trace_bit_equal_to_jax(kw):
    t, j = _trace(ttrace, 1000, **kw), _trace(jtrace, 1000, **kw)
    assert len(t) == len(j) == N
    for a, b in zip(t, j):
        assert a.arrival_s == b.arrival_s
        assert a.max_new_tokens == b.max_new_tokens
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        assert np.array_equal(a.prompt, b.prompt)
    assert t[0].arrival_s == 0.0
    assert all(x.arrival_s <= y.arrival_s for x, y in zip(t, t[1:]))


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg(jax_config)
    params_np = _np_params(cfg, 0)
    eng = JaxEngine(cfg, jax.tree_util.tree_map(jnp.asarray, params_np),
                    options=JaxOptions(**OPTS))
    reqs = jtrace.replay(eng, _trace(jtrace, cfg.vocab_size),
                         time_scale=0.0)
    return dict(params_np=params_np, golden=[list(r.output) for r in reqs],
                cfg=_cfg(get_config))


def _port(setup):
    return Engine(setup["cfg"], convert.from_jax(setup["params_np"],
                                                 device="cpu"),
                  options=EngineOptions(device="cpu", **OPTS))


def test_replay_gives_jax_tokens(setup):
    eng = _port(setup)
    reqs = ttrace.replay(eng, _trace(ttrace, setup["cfg"].vocab_size),
                         time_scale=0.0)
    assert [list(r.output) for r in reqs] == setup["golden"]
    assert [len(r.output) for r in reqs] == \
        [e.max_new_tokens for e in _trace(ttrace, 256)]
    assert eng.stats()["requests_done"] == N and not eng.has_work


def test_run_poisson_warms_up_then_replays(setup):
    seen = {}

    def on_engine(engine):
        seen["builds"] = engine.prefill_builds
        seen["steps"] = engine.step_count
    params = convert.from_jax(setup["params_np"], device="cpu")
    eng, wall = ttrace.run_poisson(
        setup["cfg"], EngineOptions(device="cpu", **OPTS), requests=N,
        rate=TRACE["rate"], prompt_max=TRACE["prompt_max"],
        gen_max=TRACE["gen_max"], seed=TRACE["seed"], time_scale=0.0,
        params=params, on_engine=on_engine)
    assert seen == {"builds": 2, "steps": 0}      # buckets 8 and 16
    assert eng.prefill_builds == 2 and wall > 0
    assert [list(r.output) for r in sorted(eng.done, key=lambda r: r.rid)] \
        == setup["golden"]


def test_replay_in_wall_clock_time(setup):
    eng = _port(setup)
    trace = _trace(ttrace, setup["cfg"].vocab_size, rate=200.0)
    scale = 2.0
    t0 = time.perf_counter()
    reqs = ttrace.replay(eng, trace, time_scale=scale)
    for r, e in zip(reqs, trace):
        # latency clocks start at the scheduled arrival ...
        assert abs(r.arrival_s - (t0 + e.arrival_s * scale)) < 5e-3
        # ... and no token comes before it
        assert r.first_token_s >= r.arrival_s
    assert time.perf_counter() - t0 >= trace[-1].arrival_s * scale
    assert [list(r.output) for r in reqs][:1] == setup["golden"][:1]


def test_launcher_rate_path(capsys):
    from repro_torch.launch import serve as launcher
    stats = launcher.main(["--engine", "--reduced", "--device", "cpu",
                           "--rate", "100",
                           "--time-scale", "0", "--requests", "4",
                           "--prompt-len", "4:24", "--gen", "2:8",
                           "--num-partitions", "2", "--seed", "3"])
    out = capsys.readouterr().out
    assert "engine: 4 requests" in out and "req/s" in out
    assert "latency p50=" in out and "ITL p50=" in out
    assert stats["requests_done"] == 4 and stats["wall_s"] > 0
    vocab = get_config("moe-gpt3-s").reduced().vocab_size
    want = sum(e.max_new_tokens for e in ttrace.poisson_trace(
        4, rate=100.0, vocab_size=vocab, prompt_len_range=(4, 24),
        gen_len_range=(2, 8), seed=3))
    assert stats["tokens_generated"] == want
