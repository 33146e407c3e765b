"""The serving engine's captured decode step and its offload path on the
card, at the reduced sizes of ``test_torch_engine_offload.py`` (reduced
moe-gpt3-s and DeepSeek-V2-Lite, fp32, five prompts over three slots
and a 10-page pool, so decode growth preempts):

* greedy tokens of the captured step equal the eager step's, under
  recompute and offload preemption, with one capture per engine however
  often it preempts, offloads and restores, and one replay per decode
  step after the first;
* the pools, and the decode step's input buffers, keep their addresses
  through replays, preemption and restores;
* each replay adds the launches of one eager step to ``LAUNCHES``: the
  decode kernel once per attention layer, router and expert FFN once
  per MoE layer;
* a capture that fails raises, with no fallback to the eager step;
* an offload copies into pinned host memory, and a restore writes the
  pages back bit for bit, in place.

This file imports neither ``jax`` nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_engine_capture_cuda.py

Elsewhere it skips: a CUDA kernel has no CPU mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import build

ARCHES = ("moe-gpt3-s", "deepseek-v2-lite-16b")
PROMPT_LENS = (13, 7, 10, 5, 11)
MAX_NEW = 12
OPTS = dict(page_size=4, max_slots=3, max_seq_len=32, chunk=16,
            min_bucket=8, num_pages=10, adaptive=False)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfg(arch):
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, compute_dtype="float32")


def _engine(arch, params=None, **opts):
    from repro_torch.serve import Engine, EngineOptions
    return Engine(_cfg(arch), params, options=EngineOptions(
        device="cuda", **dict(OPTS, **opts)), seed=0)


def _run(engine):
    rng = np.random.default_rng(7)
    reqs = [engine.submit(rng.integers(0, engine.cfg.vocab_size, size=n),
                          max_new_tokens=MAX_NEW, arrival_s=0.0)
            for n in PROMPT_LENS]
    engine.run_until_idle()
    return [list(r.output) for r in reqs]


def _addresses(engine):
    from repro_torch.models.module import leaves
    step = engine._decode
    return ([t.data_ptr() for t in leaves(engine.kv.pools)]
            + [t.data_ptr() for t in engine.kv.decode_inputs()]
            + [step.tokens.tensor.data_ptr(),
               step.active.tensor.data_ptr()])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHES)
@pytest.mark.parametrize("preempt", ["recompute", "offload"])
def test_captured_tokens_equal_eager_with_one_capture(arch, preempt):
    _cuda()
    captured = _engine(arch, preempt=preempt)
    eager = _engine(arch, captured.params, preempt=preempt,
                    decode_graph=False)
    assert captured.warmup() == eager.warmup() == 3
    addresses = _addresses(captured)
    assert _run(captured) == _run(eager)
    got, want = captured.stats(), eager.stats()
    assert got["decode_captures"] == 1 and want["decode_captures"] == 0
    assert got["decode_replays"] == got["decode_steps"] > 0
    assert got[f"preempt_{preempt}"] >= 1
    assert {k: got[k] for k in ("preempt_recompute", "preempt_offload",
                                "swap_out_bytes")} == \
        {k: want[k] for k in ("preempt_recompute", "preempt_offload",
                              "swap_out_bytes")}
    assert _addresses(captured) == addresses


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHES)
def test_each_replay_adds_one_steps_launches(arch):
    _cuda()
    engine = _engine(arch, preempt="offload")
    engine.warmup()
    cfg = engine.cfg
    attn = ("paged_mla_decode" if cfg.attn.mla is not None
            else "paged_decode_attention")
    n_moe = cfg.num_periods * sum(r["moe"] for r in cfg.layer_roles())
    assert dict(engine._decode.launches) == {
        attn: cfg.num_layers, "grouped_ffn": n_moe, "topk_router": n_moe}
    build.reset_launches()
    _run(engine)
    s = engine.stats()
    assert s["decode_replays"] == s["decode_steps"]
    assert build.LAUNCHES[attn] == s["decode_steps"] * cfg.num_layers
    prefill_chunks = s["prefill_steps"] * cfg.moe.num_partitions  # n = 2
    for name in ("grouped_ffn", "topk_router"):
        assert build.LAUNCHES[name] == n_moe * (s["decode_steps"]
                                                + prefill_chunks)


@pytest.mark.cuda
def test_offload_goes_through_pinned_memory_and_restores_in_place():
    _cuda()
    from repro_torch.models import kv_cache
    from repro_torch.models.module import leaves
    from repro_torch.serve.paged_kv import PagedKVCache
    kv = PagedKVCache(_cfg("moe-gpt3-s"), num_pages=12, page_size=4,
                      max_slots=2, max_pages_per_seq=8,
                      dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for t in leaves(kv.pools):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    ptrs = [t.data_ptr() for t in leaves(kv.pools)]
    kv.alloc_slot(0, 11)
    kv.lens[0] = 11
    pages = torch.as_tensor(kv.page_table[0, :3], dtype=torch.long,
                            device="cuda")
    before = [t[pages].clone() for t in leaves(kv.pools)]
    kv.offload_slot(0, rid=5)
    host = kv._offloaded[5][0]
    assert all(t.is_pinned() for t in leaves(host))
    assert kv_cache.tree_bytes(host) == kv.swap_out_bytes == 3 * kv.page_bytes
    kv.alloc_slot(1, 12)                     # reuses the freed pages
    for t in leaves(kv.pools):
        t[1:].fill_(7.0)
    kv.restore_slot(5, 0, 11)
    pages = torch.as_tensor(kv.page_table[0, :3], dtype=torch.long,
                            device="cuda")
    after = [t[pages] for t in leaves(kv.pools)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert [t.data_ptr() for t in leaves(kv.pools)] == ptrs


@pytest.mark.cuda
def test_a_failed_capture_raises(monkeypatch):
    """A host sync inside the captured region makes the capture fail: the
    engine raises and never serves the step eagerly instead."""
    _cuda()
    from repro_torch.models import lm
    engine = _engine("moe-gpt3-s")
    real = lm.decode_step_paged

    def syncs(*args, **kwargs):
        logits, pools = real(*args, **kwargs)
        float(logits.sum())                   # a host sync
        return logits, pools

    monkeypatch.setattr(lm, "decode_step_paged", syncs)
    with pytest.raises(RuntimeError):
        engine.warmup()
    assert engine.stats()["decode_captures"] == 0
    torch.cuda.synchronize()
