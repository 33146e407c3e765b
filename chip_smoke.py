#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Runs on one NVIDIA card, from the root of a checkout, and imports the
port only (never ``jax``, never the JAX package ``repro``). Phases, in
order; any failure ends the run with a non-zero exit and no result line:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off;
2. build: compiles every CUDA kernel from the checkout's sources, one
   ``nvcc`` per source, all at once;
3. kernel vs plain: each kernel against its plain PyTorch version, fp32
   and bf16, each case timed (device time from ``torch.profiler``) beside
   its plain version, its bound and, where one PyTorch call computes the
   same function, that call: paged decode at the serving engine's shapes
   and one memory-bound GQA shape, with and without a window, and a
   capacity case (G 8, D 128, 16,384 tokens a slot); the MLA
   latent decode at DeepSeek-V2-Lite's engine shape (8 slots, 32 pages of
   16) and at 32 slots x 4096 tokens; the top-k router at its training
   and serving shapes and at DeepSeek-V2-Lite's k 6 (indices equal,
   probabilities within 1e-6); the expert FFN at the training chunk and
   the serving capacity, gated silu, a ragged C and DeepSeek-V2-Lite's
   M 2048, and on two dispatch buffers that the port's own route ->
   dispatch_plan -> dispatch builds from 8 seeded decode tokens
   (moe-gpt3-s top-1, DeepSeek-V2-Lite top-6: the experts no token
   reached must come out exactly 0, and the bound counts only the
   weights of the experts that were reached); flash attention at the
   training shape, with a window, with GQA and at head dim 128. Limits: 1e-5 in fp32 (the MLA kernel: ``ref.tolerance_mla``, the
   same in both dtypes); in bf16 each kernel's ``ref.tolerance``: one
   rounding of the largest output for paged decode and the expert FFN,
   and for flash attention a limit per element (one output rounding plus
   the bf16 rounding of its probabilities, weighted by |v|);
4. serve: full-width moe-gpt3-s in bf16 through the launcher's ``main``
   and then through ``Engine`` with 16 seeded requests and a page pool
   small enough to force recompute preemption; the decode kernel must
   have launched once per attention layer of every decode step, and the
   router and expert-FFN kernels once per MoE layer of every chunk (one
   a decode step, ``n`` a prefill step); then a
   ``torch.profiler`` trace of 10 full-batch decode steps;
5. kernel vs gather: equal greedy decode tokens at full width, 2
   layers, fp32;
6. serve DeepSeek-V2-Lite: full width and depth (27 layers, 16.2 B
   parameters) in bf16 through the launcher's ``main``, then through
   ``Engine`` with 8 seeded requests: memory right after the engine's
   init under 40 GB, the MLA kernel launched once per layer of every
   decode step, router and expert FFN once per layer of every MoE chunk,
   every request complete; a 10-step decode profile;
7. kernel vs gather, DeepSeek-V2-Lite: equal greedy tokens at full width,
   2 layers, fp32;
8. train: full-width moe-gpt3-s (bf16 compute, fp32 params, AdamW),
   batch 8 x 1024, n = 4, through ``runtime.train``: 6 steps under NONE,
   2 under each of S1-S4; every loss finite and each kernel launched
   exactly ``LAUNCHES_PER_STEP`` times a step; step ms, tokens/s, peak
   memory and a profiled step's device-busy share per strategy;
9. card vs CPU: 3 fp32 steps of 2-layer full-width moe-gpt3-s on the
   card (kernels) and on the CPU (plain versions), losses within
   ``CARD_VS_CPU_RTOL``;
10. the ``kernels`` JSON line; 11. the ``ok`` JSON line, last.

Exits non-zero without CUDA, and in a directory holding this file alone.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_S = 3.35e12                  # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12,         # H100 SXM, no tensor cores
              "bfloat16": 989e12}       # H100 SXM tensor cores, dense
GARBAGE = 3.0e4                         # sink / stale page fill

# the serving engine's decode shapes for moe-gpt3-s
ENGINE = dict(page_size=16, max_slots=8, max_seq_len=512, chunk=64)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_case(torch, name, *, dtype, b, kv, g, d, ps, np_, lens, extra,
               window, seed):
    """Pools, page table and q laid out as the serving allocator does:
    page 0 is a garbage-filled sink, each slot owns ``pages_for(len) +
    extra`` distinct pages (the extra ones hold stale garbage), and
    unallocated page-table entries point at the sink."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    owned = [-(-n // ps) + e for n, e in zip(lens, extra)]
    assert all(o <= np_ for o in owned)
    pages = 1 + sum(owned)
    k_pool = torch.randn((pages, ps, kv, d), generator=gen, device="cuda")
    v_pool = torch.randn((pages, ps, kv, d), generator=gen, device="cuda")
    for pool in (k_pool, v_pool):
        pool[0] = GARBAGE
        nxt = 1
        for n, o in zip(lens, owned):        # stale tail of each slot
            used = -(-n // ps)
            pool[nxt + used:nxt + o] = GARBAGE
            nxt += o
    pt = torch.zeros((b, np_), dtype=torch.int32)
    nxt = 1
    for i, o in enumerate(owned):
        pt[i, :o] = torch.arange(nxt, nxt + o)
        nxt += o
    q = torch.randn((b, 1, kv * g, d), generator=gen, device="cuda")
    return dict(name=name, dtype=dtype, window=window,
                q=q.to(dt), k_pool=k_pool.to(dt), v_pool=v_pool.to(dt),
                page_table=pt.cuda(),
                lens=torch.tensor(lens, dtype=torch.int32, device="cuda"))


def kernel_cases(torch):
    eng = dict(b=8, kv=8, g=1, d=96, ps=16, np_=32,
               lens=[1, 512, 37, 200, 16, 17, 300, 455],
               extra=[2, 0, 1, 0, 1, 3, 0, 1])
    gqa = dict(b=32, kv=8, g=4, d=128, ps=16, np_=256, lens=[4096] * 32,
               extra=[0] * 32)
    # capacity: G 8, D 128 at 16,384 tokens a slot; the kernel's shared
    # memory does not grow with the context
    cap = dict(b=4, kv=2, g=8, d=128, ps=16, np_=1024, lens=[16384] * 4,
               extra=[0] * 4)
    cases = []
    for dtype in ("bfloat16", "float32"):
        for window in (0, 100):
            cases.append(paged_case(torch, "engine", dtype=dtype,
                                    window=window, seed=len(cases), **eng))
        cases.append(paged_case(torch, "gqa_4k", dtype=dtype, window=0,
                                seed=len(cases), **gqa))
    for dtype in ("bfloat16", "float32"):   # after, so the others keep seeds
        cases.append(paged_case(torch, "capacity_16k", dtype=dtype,
                                window=0, seed=len(cases), **cap))
    return cases


def bound_ms(case) -> tuple:
    """Least time the card could take: bytes each input read once and
    the output written once over HBM rate, vs operations over the peak
    rate of the dtype; the larger, and which one it is."""
    q, kp = case["q"], case["k_pool"]
    b, _, hq, d = q.shape
    kv = kp.shape[2]
    item = q.element_size()
    lens = case["lens"].tolist()
    w = case["window"]
    toks = sum(min(n, w) if w > 0 else n for n in lens)
    nbytes = (toks * kv * d * 2 * item          # K and V of live tokens
              + 2 * b * hq * d * item           # q in, out
              + case["page_table"].numel() * 4 + b * 4)
    flops = 4 * toks * hq * d                   # q.k and p.v, mul + add
    return roof(nbytes, flops, case["dtype"])


def cuda_ms(torch, fn, iters: int) -> tuple:
    """(device ms, wall ms) per call of ``fn``: the summed time of the
    CUDA kernels it launches, from ``torch.profiler``, and CUDA-event time
    over back-to-back calls, which includes any host time the device
    waits out (Python wrapper, launch)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    for _ in range(3):         # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
        if dev > 0:
            return dev / 1e3 / iters, wall
        log("cuda_ms: the profiler saw no device time; tracing again")
    raise AssertionError("the profiler saw no device time in 3 traces")


def check_paged_decode(torch, case):
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_decode_attention_ref)
    from repro_torch.kernels.paged_attention.ops import paged_decode_splits
    from repro_torch.kernels.paged_attention.ref import tolerance
    q, kp, vp = case["q"], case["k_pool"], case["v_pool"]
    pt, lens, w = case["page_table"], case["lens"], case["window"]
    b, _, hq, d = q.shape
    kv = kp.shape[2]

    def kernel():
        return paged_decode_attention(q, kp, vp, pt, lens, window=w)

    def plain():
        return paged_decode_attention_ref(q.reshape(b, kv, hq // kv, d),
                                          kp, vp, pt, lens, window=w)

    out = kernel()
    torch.cuda.synchronize()
    ref = plain().reshape(out.shape)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = tolerance(ref)
    if not torch.isfinite(out.float()).all() or err > tol:
        raise AssertionError(
            f"paged_decode_attention {case['name']} {case['dtype']} "
            f"window={w}: max abs err {err} > {tol}")
    ms, wall_ms = cuda_ms(torch, kernel, 50)
    plain_ms, plain_wall_ms = cuda_ms(torch, plain, 10)
    bms, by = bound_ms(case)
    row = dict(case=case["name"], dtype=case["dtype"], window=w,
               shape=dict(B=b, Kv=kv, G=hq // kv, D=d,
                          ps=kp.shape[1], NP=pt.shape[1]),
               splits=paged_decode_splits(q, kp, pt, window=w),
               max_abs_err=err, tol=tol,
               max_abs_ref=ref.float().abs().max().item(),
               ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, wall_ms=wall_ms, plain_wall_ms=plain_wall_ms)
    log("kernel-case " + json.dumps(row))
    return row


def mla_case(torch, name, *, dtype, b, np_, lens, extra, seed, h=16,
             r=512, e=64, ps=16):
    """Latent pools, page table and queries as the serving allocator lays
    them out: a garbage sink at page 0, ``pages_for(lens + 1) + extra``
    distinct pages a slot (the extra ones and the positions past ``lens``
    hold stale garbage), unallocated entries at the sink. ``lens`` is the
    slot's decode position: keys ``t <= lens`` are visible."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    owned = [-(-(n + 1) // ps) + x for n, x in zip(lens, extra)]
    assert all(o <= np_ for o in owned)
    pages = 1 + sum(owned)
    ckv = torch.randn((pages, ps, r), generator=gen, device="cuda")
    kr = torch.randn((pages, ps, e), generator=gen, device="cuda")
    pt = torch.zeros((b, np_), dtype=torch.int32)
    nxt = 1
    for i, (n, o) in enumerate(zip(lens, owned)):
        pt[i, :o] = torch.arange(nxt, nxt + o)
        used = -(-(n + 1) // ps)
        for pool in (ckv, kr):
            pool[nxt + used:nxt + o] = GARBAGE
            pool[nxt + used - 1, n + 1 - (used - 1) * ps:] = GARBAGE
        nxt += o
    ckv[0] = GARBAGE
    kr[0] = GARBAGE
    q_abs = torch.randn((b, 1, h, r), generator=gen, device="cuda")
    q_rope = torch.randn((b, 1, h, e), generator=gen, device="cuda")
    return dict(name=name, dtype=dtype, q_abs=q_abs.to(dt),
                q_rope=q_rope.to(dt), ckv=ckv.to(dt), kr=kr.to(dt),
                page_table=pt.cuda(), scale=(128 + e) ** -0.5,
                lens=torch.tensor(lens, dtype=torch.int32, device="cuda"))


def mla_cases(torch) -> list:
    """DeepSeek-V2-Lite's decode shape in the engine (8 slots, 32 pages of
    16, positions spread over 0-511, grown-ahead pages) and a long context
    (32 slots x 4096 positions), each in bf16 and fp32."""
    eng = dict(b=8, np_=32, lens=[0, 511, 37, 200, 15, 16, 300, 454],
               extra=[2, 0, 1, 0, 1, 3, 0, 1])
    long = dict(b=32, np_=256, lens=[4095] * 32, extra=[0] * 32)
    cases = []
    for dtype in ("bfloat16", "float32"):
        cases.append(mla_case(torch, "engine", dtype=dtype,
                              seed=40 + len(cases), **eng))
        cases.append(mla_case(torch, "long_4k", dtype=dtype,
                              seed=40 + len(cases), **long))
    return cases


def check_mla(torch, case) -> dict:
    """The MLA kernel against its plain version within
    ``ref.tolerance_mla``, timed. Bound: the visible latent and rotary
    rows, q and the fp32 output over HBM rate, against the score products
    at the dtype's peak plus the fp32 PV sum at the fp32 peak."""
    from repro_torch.kernels.paged_attention import (paged_mla_decode,
                                                     paged_mla_decode_ref)
    from repro_torch.kernels.paged_attention.ops import \
        paged_mla_decode_splits
    from repro_torch.kernels.paged_attention.ref import tolerance_mla
    qa, qr, cp, kp = case["q_abs"], case["q_rope"], case["ckv"], case["kr"]
    pt, lens, scale = case["page_table"], case["lens"], case["scale"]
    b, _, h, r = qa.shape
    e = qr.shape[-1]

    def kernel():
        return paged_mla_decode(qa, qr, cp, kp, pt, lens, scale=scale)

    def plain():
        return paged_mla_decode_ref(qa[:, 0], qr[:, 0], cp, kp, pt, lens,
                                    scale=scale)

    out = kernel()
    ref = plain()[:, None]
    torch.cuda.synchronize()
    tol = tolerance_mla(qa[:, 0], qr[:, 0], cp, kp, pt, lens, scale=scale)
    t_cap = pt.shape[1] * cp.shape[1]
    toks = sum(min(n, t_cap - 1) + 1 for n in lens.tolist())
    item = qa.element_size()
    nbytes = (toks * (r + e) * item + b * h * (r + e) * item + b * h * r * 4
              + pt.numel() * 4 + b * 4)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (2 * toks * h * (r + e) / PEAK_FLOPS[case["dtype"]]
             + 2 * toks * h * r / PEAK_FLOPS["float32"]) * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return kernel_row(
        "paged_mla_decode", case["name"], case["dtype"], (out - ref).abs(),
        tol, out, kernel, plain, bound, iters=50,
        shape=dict(B=b, H=h, R=r, E=e, ps=cp.shape[1], NP=pt.shape[1],
                   visible_tokens=toks),
        splits=paged_mla_decode_splits(qa, qr, cp, pt),
        max_abs_ref=ref.abs().max().item())


def roof(nbytes: float, flops: float, dtype: str) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the dtype's peak rate."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def randn(torch, shape, seed, scale=1.0, dtype="float32"):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda") * scale
    return x.to(getattr(torch, dtype))


def kernel_row(kernel, case, dtype, diff, tol, out, kernel_fn, plain_fn,
               bound, library_fn=None, iters=20, **extra):
    """Check a case and time it, and log it: ``diff`` is the kernel's
    elementwise |difference| from its plain version, ``tol`` the limit,
    one number or one per element. The row gives the largest difference,
    the limit where the difference comes closest to it and that ratio;
    device ms of the kernel, of its plain version and, where one PyTorch
    call computes the same function, of that call; the bound from
    ``roof``."""
    import torch
    tol = torch.as_tensor(tol, dtype=torch.float32,
                          device=diff.device).expand(diff.shape)
    ratio = (diff.float() / tol).flatten()
    worst = int(ratio.argmax())
    err, over = diff.max().item(), ratio[worst].item()
    tol = tol.flatten()[worst].item()
    if not torch.isfinite(out.float()).all() or not over <= 1.0:
        raise AssertionError(f"{kernel} {case} {dtype}: max abs err {err}; "
                             f"{over:.3g} of the limit {tol} at its worst "
                             f"element")
    ms, wall_ms = cuda_ms(torch, kernel_fn, iters)
    plain_ms, _ = cuda_ms(torch, plain_fn, max(3, iters // 4))
    library_ms = (cuda_ms(torch, library_fn, iters)[0]
                  if library_fn is not None else None)
    row = dict(kernel=kernel, case=case, dtype=dtype, max_abs_err=err,
               tol=tol, err_over_tol=over, ms=ms, wall_ms=wall_ms, plain_ms=plain_ms,
               bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms,
               **extra)
    log("kernel-case " + json.dumps(row))
    return row


def check_topk(torch, case, t, e, k, dtype, seed):
    """The router kernel against its plain version: indices must be
    equal; a row that differs is printed with the plain version's margin
    between its k-th and (k+1)-th probability before the run fails."""
    from repro_torch.kernels.topk_router import topk_router, topk_router_ref
    logits = randn(torch, (t, e), seed, dtype=dtype)
    p, i = topk_router(logits, k)
    pr, ir = topk_router_ref(logits, k)
    torch.cuda.synchronize()
    bad = (i != ir).any(dim=-1).nonzero().flatten().tolist()
    if bad:
        probs = torch.softmax(logits.float(), -1).sort(-1, True).values
        for row in bad[:20]:
            log(f"topk_router {case} {dtype} row {row}: kernel "
                f"{i[row].tolist()} plain {ir[row].tolist()} margin "
                f"{(probs[row, k - 1] - probs[row, k]).item():.3e}")
        raise AssertionError(f"topk_router {case} {dtype}: {len(bad)} rows "
                             f"route differently")
    item = logits.element_size()
    return kernel_row(
        "topk_router", case, dtype, (p - pr).abs(), 1e-6, p,
        lambda: topk_router(logits, k), lambda: topk_router_ref(logits, k),
        roof(t * e * item + t * k * 8, 5 * t * e, "float32"),
        shape=dict(T=t, E=e, k=k))


def check_grouped(torch, case, e, c, m, h, gated, act, dtype, seed):
    from repro_torch.kernels.grouped_ffn import grouped_ffn, grouped_ffn_ref
    from repro_torch.kernels.grouped_ffn.ref import tolerance
    x = randn(torch, (e, c, m), seed, dtype=dtype)
    wu = randn(torch, (e, m, h), seed + 1, m ** -0.5, dtype)
    wg = randn(torch, (e, m, h), seed + 2, m ** -0.5, dtype) if gated \
        else None
    wd = randn(torch, (e, h, m), seed + 3, h ** -0.5, dtype)
    out = grouped_ffn(x, wu, wg, wd, act)
    ref = grouped_ffn_ref(x, wu, wg, wd, act)
    torch.cuda.synchronize()
    n_w = 3 if gated else 2
    item = x.element_size()
    return kernel_row(
        "grouped_ffn", case, dtype,
        (out.float() - ref.float()).abs(), tolerance(ref), out,
        lambda: grouped_ffn(x, wu, wg, wd, act),
        lambda: grouped_ffn_ref(x, wu, wg, wd, act),
        roof((2 * e * c * m + n_w * e * m * h) * item,
             2 * e * c * m * h * n_w, dtype),
        iters=10, shape=dict(E=e, C=c, M=m, H=h, gated=gated, act=act),
        max_abs_ref=ref.float().abs().max().item())


def check_routed(torch, case, arch, seed):
    """The expert FFN on the dispatch buffer of one decode step: 8 seeded
    tokens through the port's ``route`` (random gate weights),
    ``dispatch_plan`` and ``dispatch`` at the decode capacity, full-width
    random bf16 experts. The rows of every expert no token reached are
    zero, so the kernel must read none of its weights and write its
    output as exactly 0. The bound counts the weights of the experts
    reached, all of x and the output."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline_moe import capacity_for
    from repro_torch.kernels.grouped_ffn import grouped_ffn, grouped_ffn_ref
    from repro_torch.kernels.grouped_ffn.ref import tolerance
    from repro_torch.moe import dispatch as D
    from repro_torch.moe.router import route
    cfg = get_config(arch)
    mo = cfg.moe
    e, m, h, t = mo.num_experts, cfg.d_model, mo.d_expert, 8
    tokens = randn(torch, (t, m), seed, dtype="bfloat16")
    params = {"w_gate": randn(torch, (m, e), seed + 1, 0.02)}
    if mo.gate_bias:
        params["b_gate"] = torch.zeros(e, device="cuda")
    _, eidx, _ = route(params, tokens, cfg)
    cap = capacity_for(t, mo.top_k, mo.capacity_factor, e)
    dest, valid = D.dispatch_plan(eidx, e, cap)
    x = D.dispatch(tokens, dest, e, cap)
    fed = (x.reshape(e, -1) != 0).any(dim=1)
    n_fed = int(fed.sum())
    wu = randn(torch, (e, m, h), seed + 2, m ** -0.5, "bfloat16")
    wg = randn(torch, (e, m, h), seed + 3, m ** -0.5, "bfloat16") \
        if cfg.gated_ffn else None
    wd = randn(torch, (e, h, m), seed + 4, h ** -0.5, "bfloat16")
    act = cfg.ffn_act
    out = grouped_ffn(x, wu, wg, wd, act)
    ref = grouped_ffn_ref(x, wu, wg, wd, act)
    torch.cuda.synchronize()
    if not bool((out[~fed] == 0).all()):
        raise AssertionError(f"grouped_ffn {case}: an expert no token "
                             f"reached has a non-zero output row")
    n_w = 3 if cfg.gated_ffn else 2
    rows = int(valid.sum())
    return kernel_row(
        "grouped_ffn", case, "bfloat16",
        (out.float() - ref.float()).abs(), tolerance(ref), out,
        lambda: grouped_ffn(x, wu, wg, wd, act),
        lambda: grouped_ffn_ref(x, wu, wg, wd, act),
        roof((2 * e * cap * m + n_w * n_fed * m * h) * 2,
             2 * rows * m * h * n_w, "bfloat16"),
        iters=20, shape=dict(E=e, C=cap, M=m, H=h, gated=cfg.gated_ffn,
                             act=act, tokens=t, top_k=mo.top_k),
        active_experts=n_fed, idle_rows_exactly_zero=True,
        max_abs_ref=ref.float().abs().max().item())


def attended_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    total = 0
    for i in range(sq):
        hi = min(i + 1, sk) if causal else sk
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def check_flash(torch, case, b, s, hq, kv, d, window, dtype, seed,
                library=False):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ref import tolerance
    q = randn(torch, (b, s, hq, d), seed, dtype=dtype)
    k = randn(torch, (b, s, kv, d), seed + 1, dtype=dtype)
    v = randn(torch, (b, s, kv, d), seed + 2, dtype=dtype)
    out = flash_attention(q, k, v, causal=True, window=window)
    ref = flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    item = q.element_size()
    lib = None
    if library:        # a yardstick only: the port never calls it
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True)
    return kernel_row(
        "flash_attention", case, dtype,
        (out.float() - ref.float()).abs(),
        tolerance(q, k, v, ref, causal=True, window=window), out,
        lambda: flash_attention(q, k, v, causal=True, window=window),
        lambda: flash_attention_ref(q, k, v, causal=True, window=window),
        roof((2 * b * s * hq * d + 2 * b * s * kv * d) * item,
             4 * b * hq * d * attended_pairs(s, s, True, window), dtype),
        library_fn=lib, iters=10,
        shape=dict(B=b, S=s, Hq=hq, Kv=kv, D=d, window=window),
        max_abs_ref=ref.float().abs().max().item())


def train_kernel_cases(torch) -> list:
    """Each training-slice kernel against its plain version, fp32 and
    bf16: the router at its training chunk (2048 tokens, 64 experts) and
    its serving shapes (8 decode slots; a 64-token prefill chunk in 4
    pieces), and at DeepSeek-V2-Lite's top-6; the expert FFN at
    moe-gpt3-s's training chunk (C 40) and decode/prefill capacity (C 8),
    gated silu, a ragged C and DeepSeek-V2-Lite's gated silu experts (E
    64, C 8, M 2048, H 1408), and (bf16) on the routed decode buffers of
    both models; attention at the training shape, with a window, with GQA
    and at head dim 128 (the serving path does not run it: prefill keeps
    the blockwise attention)."""
    rows = []
    for dtype in ("bfloat16", "float32"):
        for case, t in (("train", 2048), ("serve_decode", 8),
                        ("serve_prefill", 16)):
            rows.append(check_topk(torch, case, t, 64, 1, dtype,
                                   seed=len(rows)))
        rows.append(check_topk(torch, "k2", 1000, 64, 2, dtype,
                               seed=len(rows)))
        for case, t in (("deepseek_decode", 8), ("deepseek_prefill", 16),
                        ("deepseek_t64", 64)):
            rows.append(check_topk(torch, case, t, 64, 6, dtype,
                                   seed=len(rows)))
        for case, e, c, gated, act in (("train", 64, 40, False, "gelu"),
                                       ("serve", 64, 8, False, "gelu"),
                                       ("gated_silu", 8, 40, True, "silu"),
                                       ("ragged_c100", 8, 100, False,
                                        "gelu")):
            rows.append(check_grouped(torch, case, e, c, 768, 3072, gated,
                                      act, dtype, seed=10 * len(rows)))
        # DeepSeek-V2-Lite's experts at the decode/prefill capacity
        rows.append(check_grouped(torch, "deepseek", 64, 8, 2048, 1408, True,
                                  "silu", dtype, seed=10 * len(rows)))
        if dtype == "bfloat16":   # one decode step's dispatch buffer
            for case, arch in (("routed_decode_moe", "moe-gpt3-s"),
                               ("routed_decode_deepseek", DEEPSEEK)):
                rows.append(check_routed(torch, case, arch,
                                         seed=10 * len(rows)))
        for case, b, hq, kv, d, window, lib in (
                ("train", 8, 8, 8, 96, 0, True),
                ("window256", 8, 8, 8, 96, 256, False),
                ("gqa4", 8, 8, 2, 96, 0, False),
                ("d128", 4, 16, 16, 128, 0, True)):
            rows.append(check_flash(torch, case, b, 1024, hq, kv, d, window,
                                    dtype, seed=10 * len(rows),
                                    library=lib))
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------

def serve_config(num_layers=None, dtype="bfloat16", arch="moe-gpt3-s"):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cfg = dataclasses.replace(
        cfg, compute_dtype=dtype,
        num_layers=num_layers or cfg.num_layers,
        moe=dataclasses.replace(cfg.moe, num_partitions=4))
    return cfg


def requests(vocab: int, n: int, seed: int, prompt=(16, 384), gen=(32, 64)):
    from repro_torch.launch.serve import synthetic_requests
    return synthetic_requests(n, vocab, prompt, gen, seed)


def serve(cfg, reqs, *, seed=0, device="cuda", reset=None, engine=None,
          **opts):
    """Run ``reqs`` through ``engine`` (default: a fresh ``Engine``), one
    ``step`` at a time; returns it, the requests, the run's host clocks
    and its MoE chunks.
    The clocks: wall seconds and the CPU seconds of the thread that
    drives the engine (a CUDA sync spins, so CPU well below wall means
    the thread waited off-core: for a core, or asleep). The chunks: how
    many times each MoE layer ran a chunk, summed over the steps that
    ran the model (a decode runs one; a prefill of ``bucket`` tokens
    runs ``pipeline_moe._resolve_partitions`` of them). ``reset`` is
    called right before the engine runs."""
    from repro_torch.core.pipeline_moe import _resolve_partitions
    from repro_torch.serve import Engine, EngineOptions
    if engine is None:
        engine = Engine(cfg, options=EngineOptions(device=device, **ENGINE,
                                                   **opts), seed=seed)
    handles = [engine.submit(p, max_new_tokens=m) for p, m in reqs]
    if reset is not None:
        reset()
    wall, cpu = time.perf_counter(), time.thread_time()
    infos = []
    while engine.has_work:
        infos.append(engine.step())
    host = dict(wall_s=time.perf_counter() - wall,
                thread_cpu_s=time.thread_time() - cpu)
    chunks = sum(1 if i["kind"] == "decode" else
                 _resolve_partitions(cfg, i["bucket"], "prefill")
                 for i in infos if i.get("tokens"))
    for r, (_, m) in zip(handles, reqs):
        if len(r.output) != m:
            raise AssertionError(f"request {r.rid}: {len(r.output)} of "
                                 f"{m} tokens ({r.finish_reason})")
    return engine, handles, host, chunks


def serve_sample(run: int, engine, host: dict) -> dict:
    """The end-to-end numbers of one serve run, its host clocks and the
    host's 1-minute load average."""
    s = engine.stats()
    return dict(run=run, attn_kernel=s["attn_kernel"], **host,
                loadavg_1m=os.getloadavg()[0],
                prefill_tok_per_s=s["prefill_tok_per_s"],
                decode_tok_per_s=s["decode_tok_per_s"],
                p50_ttft_s=s["p50_ttft_s"], p50_itl_s=s["p50_itl_s"],
                p50_decode_step_ms=s["p50_decode_step_s"] * 1e3,
                decode_steps=s["decode_steps"],
                preempt_recompute=s["preempt_recompute"])


def profile_decode(torch, engine, steps: int = 10) -> dict:
    """Trace ``steps`` decode steps of a full batch (8 fresh requests,
    prefilled first) with ``torch.profiler``: wall time per step, device
    kernel time per step, the expert FFN's and the paged decode
    attention's device time per step and share (their kernels' names
    carry ``grouped_ffn`` and ``paged_``), and the kernels that take the
    most of it."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import RequestState
    batch = [engine.submit(p, max_new_tokens=m)
             for p, m in requests(engine.cfg.vocab_size,
                                  engine.kv.max_slots, seed=3,
                                  prompt=(64, 64), gen=(64, 64))]
    while any(r.state != RequestState.DECODE for r in batch):
        engine.step()
    torch.cuda.synchronize()
    for _ in range(3):         # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                if engine.step()["kind"] != "decode":
                    raise AssertionError("profiled step was not a decode")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        device_s = sum(e.self_device_time_total for e in kernels) / 1e6
        if device_s > 0:
            break
        log("profile_decode: the profiler saw no device time; again")
    else:
        raise AssertionError("the profiler saw no device time in 3 traces")
    engine.run_until_idle()
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    ffn_s = sum(e.self_device_time_total for e in kernels
                if "grouped_ffn" in e.key) / 1e6
    attn_s = sum(e.self_device_time_total for e in kernels
                 if "paged_" in e.key) / 1e6
    return dict(
        steps=steps, wall_ms_per_step=wall / steps * 1e3,
        device_ms_per_step=device_s / steps * 1e3,
        device_busy_share=device_s / wall,
        grouped_ffn_ms_per_step=ffn_s / steps * 1e3,
        grouped_ffn_share_of_device=ffn_s / device_s,
        paged_attention_ms_per_step=attn_s / steps * 1e3,
        paged_attention_share_of_device=attn_s / device_s,
        kernels_per_step=sum(e.count for e in kernels) / steps,
        top=[dict(name=e.key[:60],
                  ms_per_step=e.self_device_time_total / 1e3 / steps,
                  calls_per_step=e.count / steps) for e in top])


# ---------------------------------------------------------------------------
# phases 6-7: serving DeepSeek-V2-Lite
# ---------------------------------------------------------------------------

DEEPSEEK = "deepseek-v2-lite-16b"
INIT_MEMORY_LIMIT = 40e9   # bytes: the bf16 weights (32.4 GB) and one leaf


def check_serve_launches(cfg, engine, launches, chunks, attn_kernel):
    """The decode kernel once per attention layer of every decode step;
    router and expert FFN once per MoE layer of every chunk."""
    s = engine.stats()
    n_attn = cfg.num_layers
    if s["attn_kernel"] != "kernel":
        raise AssertionError(f"auto resolved to {s['attn_kernel']}")
    if launches[attn_kernel] != s["decode_steps"] * n_attn \
            or not launches[attn_kernel]:
        raise AssertionError(f"{launches[attn_kernel]} {attn_kernel} "
                             f"launches for {s['decode_steps']} decode "
                             f"steps x {n_attn}")
    n_moe = cfg.num_periods * sum(r["moe"] for r in cfg.layer_roles())
    for name in ("grouped_ffn", "topk_router"):
        if launches[name] != n_moe * chunks or not chunks:
            raise AssertionError(
                f"serving launched {name} {launches[name]} times, "
                f"expected {n_moe} MoE layers x {chunks} chunks")


def deepseek_phase(torch, build, launcher) -> collections.Counter:
    """Full-width, full-depth DeepSeek-V2-Lite in bf16: the launcher, then
    an ``Engine`` (8 slots, 16-token pages, 64-token chunks) serving 8
    seeded requests (prompts 16-256, 16-32 new tokens). Returns the
    run's kernel launches."""
    import gc
    from repro_torch.models.module import leaves
    from repro_torch.serve import Engine, EngineOptions
    stats = launcher.main(["--engine", "--arch", DEEPSEEK, "--requests", "2",
                           "--prompt-len", "16:64", "--gen", "8:16",
                           "--num-partitions", "4", "--seed", "1"])
    if stats["requests_done"] != 2 or stats["arch"] != DEEPSEEK:
        raise AssertionError(f"launcher: {stats}")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = serve_config(arch=DEEPSEEK)
    reqs = requests(cfg.vocab_size, 8, seed=5, prompt=(16, 256),
                    gen=(16, 32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, options=EngineOptions(device="cuda",
                                               attn_kernel="auto", **ENGINE),
                    seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    after_init = torch.cuda.memory_allocated()
    if init_peak >= INIT_MEMORY_LIMIT:
        raise AssertionError(f"Engine init peaked at {init_peak} bytes")
    engine, handles, host, chunks = serve(cfg, reqs, engine=engine,
                                          reset=build.reset_launches)
    launches = collections.Counter(build.LAUNCHES)
    check_serve_launches(cfg, engine, launches, chunks, "paged_mla_decode")
    s = engine.stats()
    row = dict(
        arch=cfg.name, params=sum(t.numel() for t in leaves(engine.params)),
        dtype=cfg.compute_dtype, init_s=init_s,
        memory_after_init=after_init, init_max_memory_allocated=init_peak,
        kv_cache_bytes=s["cache_bytes"], requests=s["requests_done"],
        tokens_generated=s["tokens_generated"],
        prefill_tok_per_s=s["prefill_tok_per_s"],
        decode_tok_per_s=s["decode_tok_per_s"], p50_ttft_s=s["p50_ttft_s"],
        p50_itl_s=s["p50_itl_s"],
        p50_decode_step_ms=s["p50_decode_step_s"] * 1e3,
        decode_steps=s["decode_steps"], prefill_steps=s["prefill_steps"],
        chunks=chunks, launches=dict(launches),
        max_memory_allocated=torch.cuda.max_memory_allocated(), **host)
    log("serve-deepseek " + json.dumps(row))
    log("decode-profile-deepseek " + json.dumps(profile_decode(torch,
                                                               engine)))
    del engine, handles
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def gather_vs_kernel(torch, arch: str) -> None:
    """Equal greedy tokens through the decode kernel and the gather path:
    full width, 2 layers, fp32, 8 requests."""
    cfg = serve_config(num_layers=2, dtype="float32", arch=arch)
    small = requests(cfg.vocab_size, 8, seed=2, prompt=(16, 200),
                     gen=(16, 32))
    outs = {}
    for kern in ("kernel", "gather"):
        eng, hs, _, _ = serve(cfg, small, attn_kernel=kern,
                              preempt="recompute")
        outs[kern] = [list(r.output) for r in hs]
        del eng, hs
    if outs["kernel"] != outs["gather"]:
        first = next((i, j) for i, (a, b) in enumerate(
            zip(outs["kernel"], outs["gather"]))
            for j in range(max(len(a), len(b))) if a[j:j + 1] != b[j:j + 1])
        raise AssertionError(f"{arch}: fp32 2-layer greedy tokens differ "
                             f"between the kernel and gather decode paths "
                             f"(request, token) {first}")
    log(f"kernel-vs-gather {arch} fp32 2 layers: "
        f"{sum(map(len, outs['kernel']))} greedy tokens equal")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 8-9: training
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 8, 1024
# per step of full-depth moe-gpt3-s (12 attention layers, 6 MoE layers,
# n = 4 chunks): one flash launch per attention layer; one router and one
# expert-FFN launch per chunk, and one more of each under S1-S4, whose
# checkpoint recomputes the chunk in the backward pass
LAUNCHES_PER_STEP = {
    "none": {"flash_attention": 12, "topk_router": 24, "grouped_ffn": 24},
    **{s: {"flash_attention": 12, "topk_router": 48, "grouped_ffn": 48}
       for s in ("s1", "s2", "s3", "s4")}}
CARD_VS_CPU_RTOL = 1e-4


def train_config(strategy="none", num_layers=None, dtype="bfloat16"):
    from repro_torch.configs import get_config
    cfg = get_config("moe-gpt3-s")
    return dataclasses.replace(
        cfg, compute_dtype=dtype, num_layers=num_layers or cfg.num_layers,
        moe=dataclasses.replace(cfg.moe, num_partitions=4,
                                memory_reuse_strategy=strategy))


def profile_step(torch, step_fn, state, batch) -> tuple:
    """One train step under ``torch.profiler`` (another if the trace
    comes back empty): (state, wall ms, device
    kernel ms, device busy share, the 8 kernels that take the most
    device time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    for _ in range(3):         # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        dev = sum(e.self_device_time_total for e in kernels) / 1e6
        if dev > 0:
            break
        log("profile_step: the profiler saw no device time; again")
    else:
        raise AssertionError("the profiler saw no device time in 3 traces")
    top = [dict(name=e.key[:60], ms=e.self_device_time_total / 1e3,
                calls=e.count)
           for e in sorted(kernels, key=lambda e: -e.self_device_time_total)
           [:8]]
    return state, wall * 1e3, dev * 1e3, dev / wall, top


def train_phase(torch, build) -> tuple:
    """Full-width moe-gpt3-s (bf16 compute, fp32 params, AdamW), batch
    8 x 1024 from ``SyntheticTokens``, n = 4: 6 steps under NONE, then 2
    under each of S1-S4, each run through ``runtime.train``. Returns the
    per-strategy rows and the launches of the counted runs."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.runtime import (TrainOptions, init_state,
                                     make_train_step, train)
    from repro_torch.runtime.train_loop import _to_device
    opts = TrainOptions(lr=1e-4, warmup=2, total_steps=20)
    state = init_state(train_config(), opts, seed=0)
    src = SyntheticTokens(train_config(), batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                          seed=0)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rows, launches = [], collections.Counter()
    for strategy, steps in (("none", 6), ("s1", 2), ("s2", 2), ("s3", 2),
                            ("s4", 2)):
        cfg = train_config(strategy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        state, hist = train(cfg, steps=steps, batch_source=src, opts=opts,
                            state=state, adaptive=False)
        torch.cuda.synchronize()
        got = {k: build.LAUNCHES[k] for k in LAUNCHES_PER_STEP[strategy]}
        want = {k: v * steps for k, v in LAUNCHES_PER_STEP[strategy].items()}
        if got != want:
            raise AssertionError(f"train {strategy}: launches {got}, "
                                 f"expected {want}")
        launches.update(got)
        losses = [h["loss"] for h in hist]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train {strategy}: losses {losses}")
        peak = torch.cuda.max_memory_allocated()
        step_s = sorted(h["step_time_s"] for h in hist[1:])
        step_ms = step_s[len(step_s) // 2] * 1e3
        state, wall_ms, dev_ms, busy, top = profile_step(
            torch, make_train_step(cfg, opts), state,
            _to_device(src.batch_at(steps), "cuda"))
        row = dict(strategy=strategy, steps=steps, losses=losses,
                   step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3,
                   step_ms_all=[h["step_time_s"] * 1e3 for h in hist],
                   max_memory_allocated=peak, profiled_wall_ms=wall_ms,
                   profiled_device_ms=dev_ms, device_busy_share=busy,
                   launches=got, top_kernels=top)
        log("train " + json.dumps(row))
        rows.append(row)
    del state
    torch.cuda.empty_cache()
    return rows, launches


def card_vs_cpu(torch) -> dict:
    """Three fp32 steps of 2-layer full-width moe-gpt3-s (batch 2 x 128,
    S3) from the same weights, on the card (kernels) and on the CPU
    (plain versions): the losses must agree within CARD_VS_CPU_RTOL. The
    kernels and the plain versions differ by ~1e-6 in fp32; AdamW then
    moves each parameter by up to lr whatever its gradient's size, so a
    gradient element that is rounding noise can move either way on the
    two devices, a second-order change of the loss."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import lm
    from repro_torch.runtime import TrainOptions, init_state, train
    cfg = train_config("s3", num_layers=2, dtype="float32")
    opts = TrainOptions(lr=1e-3, warmup=0, total_steps=3)
    src = SyntheticTokens(cfg, batch=2, seq=128, seed=1)
    params = lm.init(cfg, 1, device="cpu")
    on_card = init_state(cfg, opts, device="cuda", params=params)
    on_cpu = init_state(cfg, opts, device="cpu", params=params)
    _, card = train(cfg, steps=3, batch_source=src, opts=opts,
                    state=on_card, adaptive=False)
    _, cpu = train(cfg, steps=3, batch_source=src, opts=opts,
                   state=on_cpu, adaptive=False)
    a, b = [h["loss"] for h in card], [h["loss"] for h in cpu]
    rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    row = dict(card=a, cpu=b, max_rel_diff=rel, rtol=CARD_VS_CPU_RTOL)
    log("card-vs-cpu " + json.dumps(row))
    if not rel <= CARD_VS_CPU_RTOL:
        raise AssertionError(f"card and CPU losses differ by {rel}")
    del on_card
    torch.cuda.empty_cache()
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.launch import serve as launcher
    from repro_torch.models.module import leaves

    # -- 1. device ----------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; host {os.cpu_count()} "
        f"cores, torch CPU threads {torch.get_num_threads()}")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build()
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.2f} s)")

    # -- 3. kernel vs plain -------------------------------------------------
    kernel_rows = [dict(check_paged_decode(torch, c),
                        kernel="paged_decode_attention", library_ms=None)
                   for c in kernel_cases(torch)]
    torch.cuda.empty_cache()
    kernel_rows += [check_mla(torch, c) for c in mla_cases(torch)]
    torch.cuda.empty_cache()
    kernel_rows += train_kernel_cases(torch)

    # -- 4. serve -----------------------------------------------------------
    cfg = serve_config()
    stats = launcher.main(["--engine", "--arch", "moe-gpt3-s",
                           "--requests", "4", "--prompt-len", "16:128",
                           "--gen", "16:32", "--num-partitions", "4",
                           "--seed", "1"])
    if stats["requests_done"] != 4:
        raise AssertionError(f"launcher finished {stats['requests_done']}")
    reqs = requests(cfg.vocab_size, 16, seed=0)
    torch.cuda.reset_peak_memory_stats()
    engine, handles, host, chunks = serve(
        cfg, reqs, preempt="recompute", num_pages=65, attn_kernel="auto",
        reset=build.reset_launches)
    serve_launches = collections.Counter(build.LAUNCHES)
    launches = serve_launches["paged_decode_attention"]
    check_serve_launches(cfg, engine, serve_launches, chunks,
                         "paged_decode_attention")
    s = engine.stats()
    if s["preempt_recompute"] < 1:
        raise AssertionError("the small pool forced no preemption")
    params = sum(t.numel() for t in leaves(engine.params))
    serve_row = dict(
        arch=cfg.name, params=params, dtype=cfg.compute_dtype,
        requests=s["requests_done"], prefill_tok_per_s=s["prefill_tok_per_s"],
        decode_tok_per_s=s["decode_tok_per_s"], p50_ttft_s=s["p50_ttft_s"],
        p50_itl_s=s["p50_itl_s"],
        p50_decode_step_ms=s["p50_decode_step_s"] * 1e3,
        decode_steps=s["decode_steps"], prefill_steps=s["prefill_steps"],
        preempt_recompute=s["preempt_recompute"], kernel_launches=launches,
        launches=dict(serve_launches),
        max_memory_allocated=torch.cuda.max_memory_allocated())
    log("serve " + json.dumps(serve_row))
    log("serve-sample " + json.dumps(serve_sample(1, engine, host)))
    log("decode-profile " + json.dumps(profile_decode(torch, engine)))
    del engine, handles
    torch.cuda.empty_cache()

    # -- 5. kernel vs gather ------------------------------------------------
    gather_vs_kernel(torch, "moe-gpt3-s")

    # -- 6. serve DeepSeek-V2-Lite ------------------------------------------
    deepseek_launches = deepseek_phase(torch, build, launcher)

    # -- 7. kernel vs gather, DeepSeek-V2-Lite -------------------------------
    gather_vs_kernel(torch, DEEPSEEK)

    # -- 8. train -----------------------------------------------------------
    train_rows, train_launches = train_phase(torch, build)

    # -- 9. card vs CPU -----------------------------------------------------
    card_vs_cpu(torch)

    # -- 10. kernels line ---------------------------------------------------
    main_launches = serve_launches + deepseek_launches + train_launches
    def head(kernel, case="train", dtype="bfloat16"):
        return next(r for r in kernel_rows if r["kernel"] == kernel
                    and r["case"] == case and r["dtype"] == dtype
                    and not r.get("window"))

    def entry(name, src, replaces, row, **extra):
        mine = [r for r in kernel_rows if r["kernel"] == row["kernel"]]
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/" + src,
                "replaces": "src/repro/kernels/" + replaces,
                "launches": main_launches[name],
                "max_abs_err": row["max_abs_err"], "tol": row["tol"],
                "max_abs_err_float32": max(r["max_abs_err"] for r in mine
                                           if r["dtype"] == "float32"),
                "max_abs_err_bfloat16": max(r["max_abs_err"] for r in mine
                                            if r["dtype"] == "bfloat16"),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], **extra}

    log("library_ms: null for paged_decode_attention (no single PyTorch "
        "call attends over a page table), paged_mla_decode (no single "
        "call attends over a page table whose keys are latents shared by "
        "the heads), topk_router (softmax then "
        "torch.topk is two calls, and topk promises no tie order) and "
        "grouped_ffn (no single call runs a per-expert GEMM -> activation "
        "-> GEMM); flash_attention's is scaled_dot_product_attention "
        "(is_causal), a yardstick the port never calls")
    print(json.dumps({"kernels": [
        entry("paged_decode_attention", "paged_attention/csrc/"
              "paged_decode.cu", "paged_attention/kernel.py:69",
              head("paged_decode_attention", "engine")),
        entry("paged_mla_decode", "paged_attention/csrc/"
              "paged_mla_decode.cu", "paged_attention/kernel.py:142",
              head("paged_mla_decode", "engine")),
        entry("grouped_ffn", "grouped_ffn/csrc/grouped_ffn.cu",
              "grouped_ffn/kernel.py:61", head("grouped_ffn")),
        entry("topk_router", "topk_router/csrc/topk_router.cu",
              "topk_router/kernel.py:42", head("topk_router", "train",
                                               "float32")),
        entry("flash_attention", "flash_attention/csrc/flash_attention.cu",
              "flash_attention/kernel.py:67", head("flash_attention")),
    ]}), flush=True)

    # -- 11. result ---------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
