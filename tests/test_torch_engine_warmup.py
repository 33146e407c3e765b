"""``Engine.warmup`` and the decode step over static buffers, against the
JAX ``Engine`` on reduced moe-gpt3-s (the sizes of
``test_torch_engine_preempt.py``: a page pool small enough that decode
growth preempts), with the same converted weights.

- ``warmup()`` returns the JAX engine's count of programs built;
- it leaves every non-sink page, the lengths and the page table as they
  were, mid-run;
- after it, greedy tokens equal the JAX engine's under each preemption
  policy;
- the decode step over the cache's static buffers (``DecodeStep``) gives
  the logits and tokens of the step fed fresh tensors every step, as the
  engine fed it before the buffers; the buffers, like the pools, keep
  their addresses for the engine's life.

On the CPU nothing is captured (``decode_captures`` 0); the capture is
held on the card by ``test_torch_engine_capture_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.serve import Engine as JaxEngine
from repro.serve import EngineOptions as JaxOptions
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import lm
from repro_torch.models.module import leaves
from repro_torch.serve import Engine, EngineOptions, RequestState
from repro_torch.serve.paged_kv import SINK_PAGE

from test_torch_engine_preempt import (MAX_NEW, OPTS, SMALL_POOL, _cfg,
                                       _np_params, _prompts, _run)


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's warmup count and greedy tokens (recompute
    preemption), built once."""
    cfg = _cfg(jax_config)
    params_np = _np_params(cfg, 0)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    prompts = _prompts(cfg.vocab_size)
    eng = JaxEngine(cfg, params, options=JaxOptions(
        attn_kernel="gather", adaptive=False, preempt="recompute",
        num_pages=SMALL_POOL, **OPTS))
    programs = eng.warmup()
    return {"params": params_np, "prompts": prompts, "programs": programs,
            "tokens": _run(eng, prompts),
            "preempts": eng.stats()["preempt_recompute"]}


def _port_engine(reference, **opts):
    params = convert.from_jax(reference["params"], device="cpu")
    opts = dict(dict(preempt="recompute", num_pages=SMALL_POOL,
                     adaptive=False), **opts)
    return Engine(_cfg(get_config), params, options=EngineOptions(
        device="cpu", **opts, **OPTS))


def test_warmup_returns_the_jax_engines_program_count(reference):
    eng = _port_engine(reference)
    assert eng.warmup() == reference["programs"] == 3
    stats = eng.stats()
    assert stats["decode_captures"] == 0 and stats["prefill_builds"] == 2


def _state(eng):
    kv = eng.kv
    return ([t[SINK_PAGE + 1:].clone() for t in leaves(kv.pools)],
            kv.lens.copy(), kv.page_table.copy())


def test_warmup_mid_run_leaves_pages_lens_and_table_bit_equal(reference):
    eng = _port_engine(reference)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW, arrival_s=0.0)
            for p in reference["prompts"]]
    while eng.stats()["decode_steps"] < 3:
        eng.step()
    assert any(r.state == RequestState.DECODE for r in reqs)
    pages, lens, table = _state(eng)
    assert any(bool(p.any()) for p in pages) and lens.any()
    assert eng.warmup() == 1       # the prefill steps are built already
    after = _state(eng)
    assert all(torch.equal(a, b) for a, b in zip(pages, after[0]))
    assert np.array_equal(lens, after[1])
    assert np.array_equal(table, after[2])
    eng.run_until_idle()
    assert [list(r.output) for r in reqs] == reference["tokens"]


@pytest.mark.parametrize("preempt,extra", [
    ("recompute", {}), ("offload", {}),
    ("auto", {"allow_offload": True})])
def test_greedy_tokens_after_warmup_equal_jax(reference, preempt, extra):
    eng = _port_engine(reference, preempt=preempt, **extra)
    eng.warmup()
    assert _run(eng, reference["prompts"]) == reference["tokens"]
    stats = eng.stats()
    assert reference["preempts"] >= 1
    assert stats["preempt_recompute"] + stats["preempt_offload"] >= 1
    if preempt == "offload":
        assert stats["preempt_offload"] >= 1


def test_static_decode_buffers_match_fresh_tensors(reference):
    """The decode step over the cache's persistent buffers against the
    step fed fresh uploads (the engine's decode before the buffers), on
    the same engine state each step: logits bit-equal, tokens equal; the
    buffers and the pools keep their addresses throughout."""
    eng = _port_engine(reference)
    kv, step = eng.kv, eng._decode
    ptrs = [t.data_ptr() for t in leaves(kv.pools)] + [
        t.data_ptr() for t in kv.decode_inputs()] + [
        step.tokens.tensor.data_ptr(), step.active.tensor.data_ptr()]
    diffs = []

    def checked(tokens, active, sink_only=False):
        fresh, _ = lm.decode_step_paged(
            eng.params, [{k: {n: t.clone() for n, t in layer.items()}
                          for k, layer in period.items()}
                         for period in kv.pools],
            torch.from_numpy(kv.page_table.copy()),
            torch.from_numpy(kv.lens.copy()),
            torch.from_numpy(tokens.copy()), eng.cfg,
            active=torch.from_numpy(active.copy()),
            write_sink=torch.full((kv.max_slots,), SINK_PAGE,
                                  dtype=torch.int32),
            attn_kernel=eng.attn_kernel)
        logits = type(step).__call__(step, tokens, active,
                                     sink_only=sink_only)
        diffs.append(float((logits - fresh).abs().max()))
        return logits

    eng._decode = checked
    got = _run(eng, reference["prompts"])
    eng._decode = step
    assert got == reference["tokens"]
    assert len(diffs) == eng.stats()["decode_steps"] > 0
    assert max(diffs) == 0.0
    assert ptrs == [t.data_ptr() for t in leaves(kv.pools)] + [
        t.data_ptr() for t in kv.decode_inputs()] + [
        step.tokens.tensor.data_ptr(), step.active.tensor.data_ptr()]
    assert eng.stats()["decode_replays"] == 0


def test_launcher_warms_up_and_preempts_on_the_cpu(capsys):
    """``--preempt`` and ``--num-pages`` as the JAX launcher takes them:
    a pool of 12 pages makes 6 requests preempt by offload, and the
    launcher prints its warmup and its preemptions."""
    stats = launcher.main(["--engine", "--arch", "moe-gpt3-s", "--reduced",
                           "--device", "cpu", "--requests", "6",
                           "--prompt-len", "16:40", "--gen", "16",
                           "--preempt", "offload", "--num-pages", "12",
                           "--num-partitions", "1", "--seed", "0"])
    out = capsys.readouterr().out
    assert "warmup: 5 programs built" in out   # buckets 8-64
    assert stats["requests_done"] == 6 and stats["tokens_generated"] == 96
    assert stats["preempt_offload"] >= 1 and "preemptions:" in out
    assert stats["swap_out_bytes"] == stats["swap_in_bytes"] > 0
