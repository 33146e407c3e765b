"""The dense-cache path on the card:

* the flash-attention kernel at head dims 144 to 192 (MLA's expanded
  prefill runs 192: nope 128 + rope 64, v padded to match), bf16 and
  fp32, against its plain version within ``ref.tolerance``: one query,
  ragged tiles, GQA, a window, Sq != Sk, DeepSeek-V2-Lite's 16 heads at
  1024 tokens;
* ``lm.prefill`` and 4 ``lm.decode_step`` on the card (the flash,
  route-and-plan and expert-FFN kernels, each launched) against the
  same steps through the three kernels' plain versions on the card, at
  reduced moe-gpt3-s and a reduced MLA config whose q/k width (48) the
  kernel takes, fp32: logits within 1e-4;
* the captured engine's greedy tokens equal to ``dense_greedy_reference``
  at capacity factor 8.0, and the fixed-batch loop serving on the card.

This file imports neither ``jax`` nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_dense_cuda.py

Elsewhere it skips: a CUDA kernel has no CPU mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import build

FLASH_CASES = [  # b, sq, sk, hq, kv, d, causal, window
    (2, 1, 1, 4, 4, 192, True, 0),          # one query
    (2, 17, 17, 4, 2, 192, True, 0),        # ragged tile, GQA
    (1, 200, 256, 4, 1, 192, False, 48),    # Sq < Sk, window, MQA
    (1, 200, 120, 4, 4, 192, True, 0),      # causal, Sq > Sk
    (1, 1024, 1024, 16, 16, 192, True, 0),  # DeepSeek-V2-Lite's prefill
    (1, 130, 130, 2, 2, 144, True, 32),     # the other wide head dims
    (1, 70, 70, 2, 1, 160, False, 0),
    (1, 100, 100, 2, 2, 176, True, 0),
]
STEPS = 4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _randn(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(x.astype(np.float32)).cuda().to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,hq,kv,d,causal,window", FLASH_CASES)
def test_flash_kernel_wide_heads_match_plain(dtype, b, sq, sk, hq, kv, d,
                                             causal, window):
    _cuda()
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ref import tolerance
    q = _randn((b, sq, hq, d), sq + d, dtype)
    k = _randn((b, sk, kv, d), sk + d + 1, dtype)
    v = _randn((b, sk, kv, d), sk + d + 2, dtype)
    build.reset_launches()
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == 1
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs()
    tol = tolerance(q, k, v, ref, causal=causal, window=window)
    assert (err <= tol).all(), (err / tol).max().item()


def _config(arch):
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              moe=dataclasses.replace(
                                  cfg.moe, capacity_factor=8.0))
    if cfg.attn.mla is not None:   # a q/k width of 48, a multiple of 16
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, mla=dataclasses.replace(
                cfg.attn.mla, nope_head_dim=32, rope_head_dim=16,
                v_head_dim=32)))
    return cfg


def _plain(monkeypatch):
    """Route the dense path's three kernels to their plain versions, on
    the card."""
    import repro_torch.kernels.flash_attention as fa_pkg
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.grouped_ffn.ref import grouped_ffn_ref
    from repro_torch.kernels.topk_router.ref import route_plan_ref
    from repro_torch.moe import experts, router
    monkeypatch.setattr(fa_pkg, "flash_attention",
                        lambda q, k, v, *, causal=True, window=0:
                        flash_attention_ref(q, k, v, causal=causal,
                                            window=window))
    monkeypatch.setattr(router, "route_plan", route_plan_ref)
    monkeypatch.setattr(experts, "grouped_ffn", grouped_ffn_ref)


def _run(cfg, params, toks):
    from repro_torch.models import lm
    with torch.no_grad():
        logits, cache = lm.prefill(params, toks, cfg, max_len=32,
                                   dtype=torch.float32)
        outs = [logits]
        tok = logits[:, -1:].argmax(-1)
        for _ in range(STEPS):
            lg, cache = lm.decode_step(params, cache, tok, cfg)
            outs.append(lg)
            tok = lg.argmax(-1)[:, None]
    torch.cuda.synchronize()
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["moe-gpt3-s", "deepseek-v2-lite-16b"])
def test_dense_path_launches_kernels_and_matches_plain(arch, monkeypatch):
    _cuda()
    from repro_torch.models import lm
    cfg = _config(arch)
    params = lm.init(cfg, 0, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 19))).cuda()
    build.reset_launches()
    got = _run(cfg, params, toks)
    n_moe = cfg.num_periods * sum(r["moe"] for r in cfg.layer_roles())
    assert build.LAUNCHES["flash_attention"] == cfg.num_layers
    # prefill at the config's n (2) and a decode step at n = 1
    assert build.LAUNCHES["topk_router"] == n_moe * (2 + STEPS)
    assert build.LAUNCHES["grouped_ffn"] == n_moe * (2 + STEPS)
    _plain(monkeypatch)
    build.reset_launches()
    want = _run(cfg, params, toks)
    assert sum(build.LAUNCHES.values()) == 0
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["moe-gpt3-s", "deepseek-v2-lite-16b"])
def test_captured_engine_equals_dense_oracle(arch):
    _cuda()
    from repro_torch.serve import Engine, EngineOptions, \
        dense_greedy_reference
    cfg = _config(arch)
    eng = Engine(cfg, options=EngineOptions(
        device="cuda", page_size=4, max_slots=3, max_seq_len=40, chunk=16,
        min_bucket=8, adaptive=False), seed=0)
    eng.warmup()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in (13, 7, 21, 5)]
    reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
    eng.run_until_idle()
    assert eng.stats()["decode_captures"] == 1
    want = [dense_greedy_reference(eng.params, cfg, p, 12) for p in prompts]
    assert [list(r.output) for r in reqs] == want


@pytest.mark.cuda
def test_fixed_batch_loop_on_the_card(capsys):
    _cuda()
    from repro_torch.launch import serve as launcher
    build.reset_launches()
    stats = launcher.main(["--reduced", "--batch", "3", "--prompt-len",
                           "12", "--gen", "6", "--requests", "2"])
    out = capsys.readouterr().out
    assert "request-batch 1: 3 seqs x (12 prompt + <= 6 gen)" in out
    assert stats["tokens_generated"] >= 2 * 3 * 3
    for name in ("flash_attention", "topk_router", "grouped_ffn"):
        assert build.LAUNCHES[name] > 0, name
