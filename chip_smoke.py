#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Runs on one NVIDIA card, from the root of a checkout, and imports the
port only (never ``jax``, never the JAX package ``repro``). Phases, in
order; any failure ends the run with a non-zero exit and no result line:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off;
2. build: compiles every CUDA kernel from the checkout's sources;
3. kernel vs plain: each kernel against its plain PyTorch version at the
   serving engine's shapes and at one memory-bound GQA shape, fp32 and
   bf16, with and without a window, within ``ref.tolerance`` (1e-5 in
   fp32; one bf16 rounding of the largest output in bf16); each timed
   (device time from ``torch.profiler``, wall time from CUDA events)
   beside its plain version and its bound;
4. serve: full-width moe-gpt3-s in bf16 through the launcher's ``main``
   and then through ``Engine`` with 16 seeded requests and a page pool
   small enough to force recompute preemption; the decode kernel must
   have launched once per attention layer of every decode step; then a
   ``torch.profiler`` trace of 10 full-batch decode steps;
5. kernel vs gather: equal greedy tokens at full width, 2 layers, fp32;
   then the serve run again with the gather path twice and the kernel
   once (order kernel, gather, gather, kernel: two samples of each on
   this machine), and the share of equal bf16 tokens (printed, not
   held);
6. the ``kernels`` JSON line; 7. the ``ok`` JSON line, last.

Exits non-zero without CUDA, and in a directory holding this file alone.
"""
from __future__ import annotations

import dataclasses
import json
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
    cases = []
    for dtype in ("bfloat16", "float32"):
        for window in (0, 100):
            cases.append(paged_case(torch, "engine", dtype=dtype,
                                    window=window, seed=len(cases), **eng))
        cases.append(paged_case(torch, "gqa_4k", dtype=dtype, window=0,
                                seed=len(cases), **gqa))
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
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[case["dtype"]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA)
    if dev <= 0:
        raise AssertionError("the profiler saw no device time")
    return dev / 1e3 / iters, wall


def check_paged_decode(torch, case):
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_decode_attention_ref)
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
               max_abs_err=err, tol=tol,
               max_abs_ref=ref.float().abs().max().item(),
               ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, wall_ms=wall_ms, plain_wall_ms=plain_wall_ms)
    log("kernel-case " + json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------

def serve_config(num_layers=None, dtype="bfloat16"):
    from repro_torch.configs import get_config
    cfg = get_config("moe-gpt3-s")
    cfg = dataclasses.replace(
        cfg, compute_dtype=dtype,
        num_layers=num_layers or cfg.num_layers,
        moe=dataclasses.replace(cfg.moe, num_partitions=4))
    return cfg


def requests(vocab: int, n: int, seed: int, prompt=(16, 384), gen=(32, 64)):
    from repro_torch.launch.serve import synthetic_requests
    return synthetic_requests(n, vocab, prompt, gen, seed)


def serve(cfg, reqs, *, seed=0, device="cuda", reset=None, **opts):
    """Run ``reqs`` through a fresh ``Engine``; returns it, the requests
    and the run's host clocks: wall seconds and the CPU seconds of the
    thread that drives the engine (a CUDA sync spins, so CPU well below
    wall means the thread waited off-core: for a core, or asleep). ``reset`` is called right before the engine
    runs."""
    from repro_torch.serve import Engine, EngineOptions
    engine = Engine(cfg, options=EngineOptions(device=device, **ENGINE,
                                               **opts), seed=seed)
    handles = [engine.submit(p, max_new_tokens=m) for p, m in reqs]
    if reset is not None:
        reset()
    wall, cpu = time.perf_counter(), time.thread_time()
    engine.run_until_idle()
    host = dict(wall_s=time.perf_counter() - wall,
                thread_cpu_s=time.thread_time() - cpu)
    for r, (_, m) in zip(handles, reqs):
        if len(r.output) != m:
            raise AssertionError(f"request {r.rid}: {len(r.output)} of "
                                 f"{m} tokens ({r.finish_reason})")
    return engine, handles, host


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
    kernel time per step, and the kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import RequestState
    batch = [engine.submit(p, max_new_tokens=m)
             for p, m in requests(engine.cfg.vocab_size,
                                  engine.kv.max_slots, seed=3,
                                  prompt=(64, 64), gen=(64, 64))]
    while any(r.state != RequestState.DECODE for r in batch):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            if engine.step()["kind"] != "decode":
                raise AssertionError("profiled step was not a decode")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    engine.run_until_idle()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(
        steps=steps, wall_ms_per_step=wall / steps * 1e3,
        device_ms_per_step=device_s / steps * 1e3,
        device_busy_share=device_s / wall,
        kernels_per_step=sum(e.count for e in kernels) / steps,
        top=[dict(name=e.key[:60],
                  ms_per_step=e.self_device_time_total / 1e3 / steps,
                  calls_per_step=e.count / steps) for e in top])


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
    rows = [check_paged_decode(torch, c) for c in kernel_cases(torch)]
    torch.cuda.empty_cache()

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
    engine, handles, host = serve(cfg, reqs, preempt="recompute",
                                  num_pages=65,
                            attn_kernel="auto", reset=build.reset_launches)
    launches = build.LAUNCHES["paged_decode_attention"]
    s = engine.stats()
    n_attn = cfg.num_layers
    if s["attn_kernel"] != "kernel":
        raise AssertionError(f"auto resolved to {s['attn_kernel']}")
    if launches != s["decode_steps"] * n_attn or launches == 0:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{s['decode_steps']} decode steps x {n_attn}")
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
        max_memory_allocated=torch.cuda.max_memory_allocated())
    log("serve " + json.dumps(serve_row))
    log("serve-sample " + json.dumps(serve_sample(1, engine, host)))
    kernel_tokens = [list(r.output) for r in handles]
    log("decode-profile " + json.dumps(profile_decode(torch, engine)))
    del engine, handles
    torch.cuda.empty_cache()

    # -- 5. kernel vs gather ------------------------------------------------
    cfg2 = serve_config(num_layers=2, dtype="float32")
    small = requests(cfg2.vocab_size, 8, seed=2, prompt=(16, 200),
                     gen=(16, 32))
    outs = {}
    for kern in ("kernel", "gather"):
        eng, hs, _ = serve(cfg2, small, attn_kernel=kern,
                           preempt="recompute")
        outs[kern] = [list(r.output) for r in hs]
        del eng, hs
    if outs["kernel"] != outs["gather"]:
        raise AssertionError("fp32 2-layer greedy tokens differ between "
                             "the kernel and gather decode paths")
    log(f"kernel-vs-gather fp32 2 layers: {sum(map(len, outs['kernel']))} "
        f"greedy tokens equal")
    tokens = {}
    for run, kern in enumerate(("gather", "gather", "kernel"), start=2):
        eng, hs, host = serve(cfg, reqs, preempt="recompute", num_pages=65,
                              attn_kernel=kern)
        log("serve-sample " + json.dumps(serve_sample(run, eng, host)))
        tokens.setdefault(kern, [list(r.output) for r in hs])
        del eng, hs
        torch.cuda.empty_cache()
    total = sum(map(len, kernel_tokens))
    for name, other in (("gather", tokens["gather"]),
                        ("kernel, second run", tokens["kernel"])):
        same = sum(a == b for ka, ga in zip(kernel_tokens, other)
                   for a, b in zip(ka, ga))
        log(f"kernel-vs-{name} bf16 full depth: {same}/{total} tokens "
            f"agree ({same / total:.4f}), not held")

    # -- 6. kernels line ----------------------------------------------------
    head = next(r for r in rows if r["case"] == "engine"
                and r["dtype"] == "bfloat16" and r["window"] == 0)
    log("library_ms: null — no single PyTorch call computes attention "
        "over a page table (scaled_dot_product_attention needs the pages "
        "gathered first, which is the plain version)")
    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/"
                  "paged_decode.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:69",
        "launches": launches,
        "max_abs_err": head["max_abs_err"],
        "max_abs_err_float32": max(r["max_abs_err"] for r in rows
                                   if r["dtype"] == "float32"),
        "max_abs_err_bfloat16": max(r["max_abs_err"] for r in rows
                                    if r["dtype"] == "bfloat16"),
        "tol": head["tol"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None}]}), flush=True)

    # -- 7. result ----------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
