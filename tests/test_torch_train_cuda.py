"""The training slice's CUDA kernels against their plain versions, and
two train steps of reduced moe-gpt3-s, on the card.

Each kernel (``topk_router``, ``grouped_ffn``, ``flash_attention``) is
held against its plain PyTorch version on the same CUDA inputs: indices
equal and probabilities within atol 1e-6 for the router; the other two
within their ``ref.tolerance`` (1e-5 in fp32; in bf16 a rounding of the
largest output for the FFN, and for attention a limit per element: one
output rounding plus the bf16 rounding of the probabilities, weighted
by |v|). The gradient through each wrapper is held against
autograd through the plain version within rtol 1e-4, atol 1e-5 (fp32;
the backward is that plain version, but the forward it saves for is
the kernel's). Every case counts its launch. The 8-bit AdamW and
Adafactor each take a step on the card against the same step on the CPU.
This file imports neither
``jax`` nor the JAX package, so on a machine with the card and ``nvcc``
it runs without them:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_train_cuda.py

Elsewhere it skips: a CUDA kernel has no CPU mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import build


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, scale=1.0, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32)).cuda().to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,k", [(2048, 64, 1), (100, 64, 2), (37, 8, 3)])
def test_topk_router_kernel_matches_plain(t, e, k):
    _cuda()
    from repro_torch.kernels.topk_router import topk_router, topk_router_ref
    x = _randn((t, e), seed=t + k)
    x[: t // 4, 5] = x[: t // 4].max(dim=1).values + 1.0   # ties at 5, 6
    x[: t // 4, 6] = x[: t // 4, 5]
    build.reset_launches()
    xg = x.clone().requires_grad_(True)
    p, i = topk_router(xg, k)
    pr, ir = topk_router_ref(x, k)
    torch.cuda.synchronize()
    assert build.LAUNCHES["topk_router"] == 1
    assert torch.equal(i, ir)
    assert (i[: t // 4, 0] == 5).all()
    assert (p - pr).abs().max().item() <= 1e-6
    w = _randn(p.shape, seed=1)
    (gk,) = torch.autograd.grad((p * w).sum(), xg)
    xr = x.clone().requires_grad_(True)
    top = torch.softmax(xr, -1).gather(-1, ir.long())
    if k > 1:
        top = top / top.sum(-1, keepdim=True)
    (gr,) = torch.autograd.grad((top * w).sum(), xr)
    torch.testing.assert_close(gk, gr, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,m,h,gated,act", [
    (8, 40, 768, 3072, False, "gelu"),     # moe-gpt3-s, one training chunk
    (2, 100, 128, 256, True, "silu"),      # ragged C
    (4, 8, 64, 32, False, "relu"),         # reduced: H below one tile
])
def test_grouped_ffn_kernel_matches_plain(dtype, e, c, m, h, gated, act):
    _cuda()
    from repro_torch.kernels.grouped_ffn import grouped_ffn, grouped_ffn_ref
    from repro_torch.kernels.grouped_ffn.ref import tolerance
    x = _randn((e, c, m), 1, dtype=dtype)
    wu = _randn((e, m, h), 2, m ** -0.5, dtype)
    wg = _randn((e, m, h), 3, m ** -0.5, dtype) if gated else None
    wd = _randn((e, h, m), 4, h ** -0.5, dtype)
    build.reset_launches()
    out = grouped_ffn(x, wu, wg, wd, act)
    ref = grouped_ffn_ref(x, wu, wg, wd, act)
    torch.cuda.synchronize()
    assert build.LAUNCHES["grouped_ffn"] == 1
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tolerance(ref)
    if dtype == torch.float32 and c <= 100:
        ins = [t.clone().requires_grad_(True)
               for t in (x, wu, wg, wd) if t is not None]
        full = ins if gated else [ins[0], ins[1], None, ins[2]]
        g = _randn(out.shape, 5)
        gk = torch.autograd.grad((grouped_ffn(*full, act) * g).sum(), ins)
        rin = [t.clone().requires_grad_(True) for t in ins]
        rfull = rin if gated else [rin[0], rin[1], None, rin[2]]
        gr = torch.autograd.grad(
            (grouped_ffn_ref(*rfull, act, round_hidden=False) * g).sum(),
            rin)
        for a, b in zip(gk, gr):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,hq,kv,d,causal,window", [
    (2, 1024, 1024, 8, 8, 96, True, 0),    # moe-gpt3-s training shape
    (1, 200, 200, 8, 2, 64, True, 64),     # GQA + window, ragged tiles
    (2, 48, 96, 4, 1, 16, False, 0),       # Sq != Sk, non-causal
])
def test_flash_attention_kernel_matches_plain(dtype, b, sq, sk, hq, kv, d,
                                              causal, window):
    _cuda()
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ref import tolerance
    q = _randn((b, sq, hq, d), 1, dtype=dtype)
    k = _randn((b, sk, kv, d), 2, dtype=dtype)
    v = _randn((b, sk, kv, d), 3, dtype=dtype)
    build.reset_launches()
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == 1
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs()
    tol = tolerance(q, k, v, ref, causal=causal, window=window)
    assert (err <= tol).all(), (err / tol).max().item()
    if dtype == torch.float32 and sq <= 200:
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        g = _randn(out.shape, 4)
        gk = torch.autograd.grad(
            (flash_attention(*ins, causal=causal, window=window) * g).sum(),
            ins)
        rin = [t.clone().requires_grad_(True) for t in (q, k, v)]
        gr = torch.autograd.grad(
            (flash_attention_ref(*rin, causal=causal, window=window)
             * g).sum(), rin)
        for a, bb in zip(gk, gr):
            torch.testing.assert_close(a, bb, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["none", "s3"])
def test_two_reduced_train_steps_on_the_card(strategy):
    dev = _cuda()
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.runtime import TrainOptions, train
    cfg = get_config("moe-gpt3-s").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_partitions=2, memory_reuse_strategy=strategy))
    build.reset_launches()
    state, hist = train(cfg, steps=2, adaptive=False, device=dev,
                        opts=TrainOptions(lr=1e-3, warmup=0, total_steps=2),
                        batch_source=SyntheticTokens(cfg, 4, 32, seed=0))
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    n_moe = cfg.num_periods * sum(r["moe"] for r in cfg.layer_roles())
    # a launch per chunk, and one more per chunk where S3 recomputes it
    per_step = n_moe * 2 * (1 if strategy == "none" else 2)
    assert build.LAUNCHES["flash_attention"] == 2 * cfg.num_layers
    assert build.LAUNCHES["grouped_ffn"] == 2 * per_step
    assert build.LAUNCHES["topk_router"] == 2 * per_step


def _q8_or_tensors(tree):
    from repro_torch.optim.groups import paths
    return [x for _, x in paths(tree)]


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adamw8bit", "adafactor"])
def test_memory_lean_optimizer_step_on_the_card_matches_the_cpu(optimizer):
    """One train step of reduced moe-gpt3-s (4 layers, 2 periods, fp32)
    under ``optimizer``, on the card and on the CPU from the same weights:
    the losses within rtol 1e-5 (kernels against plain versions), and the
    optimizer update of the CPU step's gradients, run on both devices,
    within the CPU tests' tolerances against the JAX package: parameters
    rtol 1e-6 / atol 1e-7; 8-bit scales rtol 1e-6 and payloads at most 1
    apart; Adafactor's ``vr`` / ``vc`` rtol 1e-6."""
    dev = _cuda()
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import lm
    from repro_torch.models.module import leaves, unflatten
    from repro_torch.optim import get_optimizer
    from repro_torch.optim.adamw import Q8
    from repro_torch.runtime import TrainOptions, init_state, train
    from repro_torch.runtime.train_loop import _step_parts, _to_device
    cfg = get_config("moe-gpt3-s").reduced()
    cfg = dataclasses.replace(cfg, optimizer=optimizer,
                              moe=dataclasses.replace(
                                  cfg.moe, num_partitions=2,
                                  memory_reuse_strategy="s4"))
    opts = TrainOptions(lr=1e-3, warmup=0, total_steps=2)
    params = lm.init(cfg, 3, device="cpu")
    src = SyntheticTokens(cfg, 4, 32, seed=0)
    losses = []
    for d in (dev, "cpu"):
        state = init_state(cfg, opts, device=d, params=params)
        _, hist = train(cfg, steps=1, batch_source=src, opts=opts,
                        state=state, adaptive=False)
        losses.append(hist[0]["loss"])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    # the update alone, on the same gradients
    grads_of, _ = _step_parts(cfg, opts)
    cpu = init_state(cfg, opts, device="cpu", params=params)
    grads, _ = grads_of(cpu["params"], _to_device(src.batch_at(0), "cpu"))
    card = init_state(cfg, opts, device=dev, params=params)
    mod, ocfg = get_optimizer(optimizer, lr=1e-3)
    for st, d in ((cpu, "cpu"), (card, dev)):
        g = unflatten(st["params"], [x.to(d) for x in grads])
        st["opt"] = mod.update(g, st["opt"], st["params"], ocfg,
                               lr_scale=0.5)
    for a, b in zip(leaves(card["params"]), leaves(cpu["params"])):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().numpy(), rtol=1e-6, atol=1e-7)
    for a, b in zip(_q8_or_tensors(card["opt"]), _q8_or_tensors(cpu["opt"])):
        if isinstance(a, Q8):
            np.testing.assert_allclose(a.scale.cpu().numpy(),
                                       b.scale.numpy(), rtol=1e-6)
            diff = a.q.cpu().int() - b.q.int()
            assert diff.abs().max().item() <= 1
        elif isinstance(a, torch.Tensor):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-6, atol=0 if optimizer ==
                                       "adafactor" else 1e-7)
