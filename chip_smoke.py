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
   probabilities within 1e-6), and its fused route-and-plan launch at
   every MoE chunk shape of the main paths, with the path's capacity and
   a tight one (indices, destinations and flags equal, probabilities
   within 1e-6, the serving statistics within 1e-6 relative), each fp32
   row beside the device ms and launches of the routing it replaced
   (``route`` then ``dispatch_plan``) and of ``route_and_plan``; the
   expert FFN at the training chunk and
   the serving capacity, gated silu, a ragged C and DeepSeek-V2-Lite's
   M 2048, and on two dispatch buffers that the port's own route ->
   dispatch_plan -> dispatch builds from 8 seeded decode tokens
   (moe-gpt3-s top-1, DeepSeek-V2-Lite top-6: the experts no token
   reached must come out exactly 0, and the bound counts only the
   weights of the experts that were reached), and in bf16 at the
   training chunks of moe-bert-l and moe-gpt3-xl (E 64, C 40, M 1024 / H
   4096 and M 2048 / H 8192); flash attention at the
   training shape, with a window, with GQA, at head dim 128 and at MLA's
   head dim 192 (B 4 x S 1024 and the fixed-batch loop's B 8 x S 64, 16
   heads; the ``kernels`` line carries these rows), and in bf16 at the
   two larger paper models' training batches (B 8 x S 1024, D 128, 8 and
   16 heads); at the GQA decoders' shapes (``gqa_phase.kernel_cases``,
   the ``kernels`` line's ``gqa`` rows): paged decode over 8 slots of
   the engines' lengths at D 80, G 4, window 4096 (h2o-danube-1.8b) and
   D 256, G 2, window 1024 and none (gemma3-12b), flash attention at D 80
   and D 256, causal and windowed, over the windowed models' longest
   prompts (4,100 and 1,040 tokens; ``scaled_dot_product_attention``
   with GQA and the window as a mask is the yardstick). Limits: 1e-5 in
   fp32 (the MLA kernel: ``ref.tolerance_mla``, the same in both
   dtypes); in bf16 each kernel's ``ref.tolerance``: one
   rounding of the largest output for paged decode and the expert FFN,
   and for flash attention a limit per element (one output rounding plus
   the bf16 rounding of its probabilities, weighted by |v|);
4. serve: full-width moe-gpt3-s in bf16 through the launcher's ``main``
   and then through ``Engine`` with 16 seeded requests and a page pool
   small enough to force recompute preemption. Every serve run calls
   ``Engine.warmup()`` first, which captures the decode step into a CUDA
   graph: each run must capture once and replay once per decode step,
   recording one step's launches. The decode kernel must have launched
   once per attention layer of every decode step, and the router and
   expert-FFN kernels once per MoE layer of every chunk (one a decode
   step, ``n`` a prefill step), each replay counted as the launches it
   recorded; then a ``torch.profiler`` trace of 10 full-batch decode
   steps (with the host launch calls a step, the CUDA launches of one
   MoE layer and ``replay_vs_eager``: one replay against one eager step
   on the same inputs, the same kernels of the port, the recorded
   launches, logits within 2^-7·max|logit| + 1e-5). Then capture vs
   eager in turns (2 pairs of the same 16-request run, each mode's
   10-step profile: decode step ms, tokens/s, busy share, kernels and
   host launch calls a step), and offload: the same run under
   ``preempt="offload"`` (at least one offload, each swap's bytes and
   GB/s) and under ``"auto"`` (each victim's ``PreemptionCost``: its
   recompute and offload seconds and the choice, which must be the mode
   applied), and at 2 layers in fp32 the greedy tokens of offload and
   recompute equal;
5. prefix cache, moe-gpt3-s: full width, bf16, n = 4, the decode step
   captured, on the JAX package's chat trace built here
   (``chat_trace``: 16 conversations share a 256-token system prompt,
   user turns of 2-128 tokens, 32-64 new tokens a turn; the second turn
   resubmits each whole history plus 2-8 tokens), the cache off and on
   in turns, 2 pairs. Each leg logs hits, hit tokens, prefill tokens
   run, TTFT p50 / p99 a turn, copies on write (bytes, device ms),
   evicted pages, peak logical / physical pages and the p50 decode step
   ms, and checks: every request complete, ``check_integrity()``, one
   capture and a replay a decode step, ``check_serve_launches`` over the
   chunks run, a warm turn with hit tokens, and each copy-on-write
   target bit-equal to its source, which stays unchanged while it is
   published;
6. cancel, moe-gpt3-s at full width, captured, ``preempt="offload"``
   with a 65-page pool: one request cancelled in each stage (queued,
   mid-prefill, offloaded, decoding), each followed by
   ``check_integrity()``, its slot and host pages released and its
   ``on_done`` fired once; the others complete, and a cancel of a
   finished request returns False; at 2 layers in fp32 with capacity
   factor 8.0 the survivors' tokens equal the run without cancels;
7. telemetry, replay and ingress, moe-gpt3-s at full width, bf16,
   captured (``obs_phase``): phase 4's run with the tracer off and on in
   turns, 2 pairs (launches, launches a replay, captures, replays and
   builds equal; p50 decode step ms and decode tokens/s each way, the
   ``telemetry-overhead`` line; the first traced run's trace written to
   ``build/`` and checked: B/E balanced, ADMIT and RETIRE a request, an
   ``engine.step`` span a step, a ``PREFILL`` span a prefill step); the
   same run with ``/metrics`` scraped every 50 ms from a thread while
   the engine steps, a final scrape equal to ``stats()``; a Poisson
   replay of 64 requests at once (the sustained req/s) and offered at
   50% and 120% of it (req/s, tok/s, TTFT, ITL and latency p50 / p99
   from the registry); the HTTP/SSE ingress: two requests alone equal
   to in-process, 8 SSE clients against the same 8 in-process (TTFT,
   ITL, each token's SSE delay after its emit, the p50 decode step
   under the ingress), a client hanging up mid-stream (cancelled within
   one engine step, ``check_integrity()``, every page back), ``reject``
   giving 429 with ``Retry-After``; at 2 layers in fp32 with capacity
   factor 8.0 SSE tokens, sequential and 8 at once, equal in-process,
   and a ``degrade``-clamped stream a prefix of its request alone;
8. kernel vs gather: equal greedy decode tokens at full width, 2
   layers, fp32, capacity factor 8.0, through the kernel captured and
   eager, the gather path and ``dense_greedy_reference`` (one request at
   a time over a dense cache); then at the config's 1.25, measured and
   not asserted (``oracle-cf1.25``): (a) the requests equal to the oracle
   and each first differing (request, token), (b) two identical captured
   runs against each other;
9. serve DeepSeek-V2-Lite: full width and depth (27 layers, 16.2 B
   parameters) in bf16 through the launcher's ``main``, then through
   ``Engine`` with 8 seeded requests: memory right after the engine's
   init under 40 GB, the MLA kernel launched once per layer of every
   decode step, router and expert FFN once per layer of every MoE chunk,
   every request complete; a 10-step decode profile; capture vs eager in
   turns (2 pairs); ``preempt="auto"`` with a 48-page pool, each
   victim's ``PreemptionCost`` (recompute and offload seconds, choice)
   and the swap bytes and GB/s;
10. prefix cache, DeepSeek-V2-Lite: as 5 over the same weights, with 8
   conversations, one pair;
11. the dense-cache path: the launcher's fixed-batch loop (no
   ``--engine``; ``lm.prefill`` through the flash kernel, at D 192 for
   MLA, and ``lm.decode_step`` over a dense cache) in bf16 at full width
   and depth over phases 4 and 9's weights, moe-gpt3-s and
   DeepSeek-V2-Lite, 2 batches of 8 (``fixed-batch`` lines: tokens,
   tok/s, the dense decode step's p50 ms beside the captured engine's,
   ``max_memory_allocated``, launches checked per prefill and step);
   then full-width, full-depth moe-gpt3-s in fp32: the captured engine's
   greedy tokens of 8 requests equal to ``dense_greedy_reference``'s at
   capacity factor 8.0, and the 1.25 measurement of phase 8
   (``tools/dense_phase.py`` runs this phase alone);
12. kernel vs gather, DeepSeek-V2-Lite: as 8, at 2 layers;
13. prefix on vs off, exact: both models at 2 layers in fp32, capacity
   factor 8.0, the chat trace through the captured kernel path: greedy
   tokens of both turns equal with the cache on and off (where a pair
   parts: the step, the top-2 logit gap there and the largest K/V
   difference of reused against recomputed pages, then a failure);
14. train: full-width moe-gpt3-s (bf16 compute, fp32 params, AdamW),
   batch 8 x 1024, n = 4, through ``runtime.train``: 6 steps under NONE,
   2 under each of S1-S4; every loss finite and each kernel launched
   exactly ``LAUNCHES_PER_STEP`` times a step; step ms, tokens/s, peak
   memory and a profiled step's device-busy share per strategy;
15. train-memory (``tools/train_phase.py`` runs it alone), each run a
   ``train-memory`` line (peak memory, the optimizer state's bytes from
   its tensors within 1% of their reckoning from the parameter shapes,
   median step ms, losses, launches): (a) full-width moe-gpt3-s (bf16
   compute, fp32 params, batch 8 x 1024, n = 4, S4), 3 steps under
   ``adamw``, ``adamw8bit`` and ``adafactor`` from the same init, losses
   finite and each kernel launched its count a step; (b) the same under
   AdamW, 2 steps under remat ``nothing``, ``dots`` and ``full``: step
   0's loss equal within 1e-6 relative, peak memory ordered full <= dots
   <= nothing (``train-memory-remat``); (c) ``adamw8bit`` at
   ``CKPT_LAYERS`` layers (its disk traffic scales with depth) with a
   ``Checkpointer`` in a temporary directory, saving at steps 2 and 4;
   a run from a fresh init resumed from the step-2 checkpoint alone: the
   state it restores bit-equal to a clone taken at the save, its losses
   the uninterrupted run's within ``CARD_VS_CPU_RTOL``
   (``train-memory-ckpt``: each save's blocking copy in ms and GB/s, the
   writer's seconds, the restore's); (d)
   moe-bert-l at full width and depth, 2 steps under ``adamw8bit`` and 2
   under ``adafactor``, and moe-gpt3-xl at full width and 4 layers, 2
   steps under ``adafactor``: finite losses and launches a step;
16. adaptive (n, strategy): full-width moe-gpt3-s trained by
   ``runtime.train`` through the online controller over batches of
   8192, 4096 and 2048 tokens (``ADAPTIVE_TRACE``, a retune timer of 4
   steps), candidates measured by wall clock on the card beside the
   analytic core's figures on ``GPU_H100``: the measurement must leave
   the train state bit-equal, one step function per (n, strategy,
   shape), launches per step at each step's own n, finite losses; one
   pipelined MoE layer's memory under NONE and S1-S4 at n 1-8 beside
   ``MoEMemory``; eta, sigma, the host link's bytes/s and the host time
   of a launch (``eta_sigma``); ``Engine`` with its adaptive defaults on
   8 requests, launches per prefill chunk at each bucket's resolved n,
   and a mid-run wall-clock probe that must write only the sink page;
17. card vs CPU: 3 fp32 steps of 2-layer full-width moe-gpt3-s on the
   card (kernels) and on the CPU (plain versions), losses within
   ``CARD_VS_CPU_RTOL``;
18. expert parallelism (``tools/ep_phase.py``, which runs it alone): two
   gloo processes sharing the card (one card cannot host two NCCL
   ranks), mesh (1, 2): which collectives gloo runs on CUDA tensors
   (``ep-probe``); full-width moe-gpt3-s at 4 layers, fp32, trained
   under NONE and S4 against a one-rank run (``ep-train``: loss, every
   gathered gradient leaf); full-width DeepSeek-V2-Lite at 2 layers
   through ``lm.prefill`` and 4 ``lm.decode_step``s with ``dist``
   against the one-rank run (``ep-decode``: greedy tokens equal, logits,
   the expert FFN's launches at the EP shapes); a profile
   of the overlapped schedule (``ep-trace``: whether chunk i+1's
   dispatch All-to-All overlaps chunk i's expert FFN). Each rank's
   train and decode paths must give the expert FFN exactly the inputs
   ``ep_phase.ffn_cases`` names (phase 3 holds the kernel at those
   shapes) and launch the router and expert-FFN kernels once a call;
   those launches join the main paths' counts. The train launcher under
   ``torch.distributed.run`` on NCCL, saving a checkpoint each step
   (``ep-launcher``, 30-47 s, nearly all of it a fresh process's
   start-up), runs only in ``tools/ep_phase.py``: with it the script
   ran past its 1,200 s limit on a slower host;
19. the serving engine over ranks (``tools/serve_ranks_phase.py``, which
   runs it alone): gloo processes sharing the card, eager decode steps.
   Two ranks (mesh (1, 2)): full-width, full-depth moe-gpt3-s in bf16
   over replicated pools, 8 requests, both ranks' tokens equal, each
   rank's memory after init, the eager decode step's p50, the kernels'
   launches a decode step and layer with the expert FFN's decode calls
   at ``[32, 8, 768]`` (``serve-ranks``; phase 3 holds the kernel at
   that shape); at 2 layers in fp32, capacity factor 8.0, the greedy
   tokens of moe-gpt3-s at (1, 2) "replicated" and, over three ranks
   (mesh (3, 1)), of moe-gpt3-s "dp" (plain, a recompute storm and an
   offload storm) and DeepSeek-V2-Lite "dp" (plain, an offload storm)
   equal to the one-device captured engine's and
   ``dense_greedy_reference``'s, every shard drained
   (``serve-ranks-exact``); each rank's KV pool bytes under "dp"
   against "replicated" (``serve-ranks-bytes``: a third plus one sink
   page). Its launches join the main paths' counts;
20. training over ranks, finished (``tools/ep_state_phase.py``, which
   runs it alone): gloo processes sharing the card, full-width
   moe-gpt3-s at 2 layers, fp32. Four ranks (mesh (2, 2), ZeRO-3 expert
   shards): 2 steps of ``adamw8bit`` and ``adafactor`` against the
   one-device optimizer fed the ranks' gathered gradients (bit-equal,
   and rtol 1e-6 for Adafactor), each rank's optimizer state bytes equal
   to their reckoning (``ep-optim``); in the ``adafactor`` run a
   checkpoint saved after step 1, the state restored from it into a
   fresh (2, 2) state and stepped again bit-equal to the run's step 2,
   each rank's blocking save and file bytes, and the checkpoint restored
   onto one device bit-equal (``ep-ckpt``). Two more ranks (mesh (1, 2),
   beside the four): a profile of
   one bf16 MoE layer's backward pass under NONE and S4, overlapped and
   serial: which All-to-Alls span another chunk's expert FFN, the
   backward's ms and peak memory (``ep-trace-bwd``). The expert FFN's
   inputs are ``ep_state_phase.ffn_cases``' (phase 3 holds the kernel at
   them); its launches join the main paths' counts;
21. the GQA + RoPE decoders (``tools/gqa_phase.py``, which runs it
   alone): llama3-8b, h2o-danube-1.8b and gemma3-12b at full width and
   depth and qwen1.5-110b at full width and 16 of its 80 layers, bf16,
   weights drawn on the card: ``Engine`` warmed up and serving 8
   requests of 16-20 new tokens through the captured decode step, on
   the windowed models one crossing the window as it decodes and on
   gemma3-12b one prompt past it (``gqa-serve``: peak memory, init and
   warmup seconds, the decode step's p50; launches checked; the 10-step
   profile only when the tool runs alone);
   each request's greedy tokens against ``dense_greedy_reference`` on
   the same weights, a parting allowed only at a near-tie of bf16
   logits: along the engine's tokens each within ``gqa_phase.TIE_REL``
   (4 bf16 epsilons) of the oracle's best logit (``gqa-oracle``); the serve
   launcher's engine and its fixed-batch loop on those weights
   (``gqa-launcher``); the first 4 requests (the window's among them)
   in fp32 at full depth (qwen1.5-110b at 8 layers), every token equal
   to the oracle's (``gqa-exact``). Its launches join the main paths' counts;
22. the ``kernels`` JSON line (the expert FFN's row carrying its EP
   shapes, ``ep``; paged decode and flash attention their GQA rows,
   ``gqa``); 23. the ``ok`` JSON line, last.

The serving phases 4-10 and 12-13 fix n = 4 (``adaptive=False``, the
launcher's ``--num-partitions 4``), so their numbers compare with earlier
runs; phase 11's fixed-batch loop resolves n for its prefill tokens, as
the JAX launcher's loop does.

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
sys.path.insert(0, str(ROOT / "tools"))                 # ep_phase

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


def device_profile(torch, fn, iters: int) -> tuple:
    """(device ms, CUDA launches) per call of ``fn``, from
    ``torch.profiler``: the summed time of the kernels it launches. A
    trace now and then comes back empty or short of events (a flash row
    once came back at a tenth of its CUDA-event time, under its bound): a
    trace with no device time, or whose events are not a whole number a
    call, is taken again, up to 3 traces, and the one with the most
    device time is kept."""
    from torch.profiler import ProfilerActivity, profile
    best = (0.0, 0)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        dev = sum(e.self_device_time_total for e in kernels)
        count = sum(e.count for e in kernels)
        best = max(best, (dev, count))
        if dev > 0 and count % iters == 0:
            break
        log(f"device_profile: a trace of {count} events and {dev} us "
            f"over {iters} calls; again")
    if best[0] <= 0:
        raise AssertionError("the profiler saw no device time in 3 traces")
    return best[0] / 1e3 / iters, best[1] / iters


def cuda_ms(torch, fn, iters: int) -> tuple:
    """(device ms, wall ms) per call of ``fn``: the summed time of the
    CUDA kernels it launches, from ``torch.profiler``, and CUDA-event time
    over back-to-back calls, which includes any host time the device
    waits out (Python wrapper, launch)."""
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
    return device_profile(torch, fn, iters)[0], wall


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


def route_inputs(torch, arch, t, seed, train):
    """One MoE chunk's router inputs at ``arch``'s full width: bf16 tokens
    ``[T, M]`` and fp32 gate weights (scale 0.02, under autograd when
    ``train``), and the config."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    e = cfg.moe.num_experts
    params = {"w_gate": randn(torch, (cfg.d_model, e), seed + 1, 0.02)
              .requires_grad_(train)}
    if cfg.moe.gate_bias:
        params["b_gate"] = torch.zeros(e, device="cuda")
    return cfg, randn(torch, (t, cfg.d_model), seed, dtype="bfloat16"), params


def route_paths(torch, arch, t, cap, seed, train) -> dict:
    """Device ms and CUDA launches per call of an MoE chunk's routing at
    ``arch``'s width, gate product included, in the grad mode of its main
    path (autograd when ``train``, else none): ``parent``, the parent's
    ``route`` (softmax, the top-k launch, the aux ops) then
    ``dispatch_plan``; ``chunk``, ``route_and_plan`` (one router launch,
    plus in training the aux ops autograd needs), where the port has it.
    Both must give the same destinations, and in serving aux losses within
    rtol 1e-5."""
    from repro_torch.moe import dispatch as D
    from repro_torch.moe import router as R
    cfg, tokens, params = route_inputs(torch, arch, t, seed, train)
    e = cfg.moe.num_experts

    def parent():
        _, idx, aux = R.route(params, tokens, cfg)
        return D.dispatch_plan(idx, e, cap)[0], aux

    def chunk():
        _, _, dest, aux = R.route_and_plan(params, tokens, cfg, cap)
        return dest, aux

    out = {}
    with torch.enable_grad() if train else torch.no_grad():
        fns = {"parent": parent}
        if hasattr(R, "route_and_plan"):
            fns["chunk"] = chunk
            (d0, a0), (d1, a1) = parent(), chunk()
            if not torch.equal(d0, d1):
                raise AssertionError(f"route_and_plan {arch} T {t}: dest "
                                     f"differs from route + dispatch_plan")
            for key in a0:
                if not math.isclose(a0[key].item(), a1[key].item(),
                                    rel_tol=1e-5, abs_tol=1e-7):
                    raise AssertionError(f"route_and_plan {arch} T {t}: "
                                         f"{key} {a1[key].item()} vs "
                                         f"{a0[key].item()}")
        for name, fn in fns.items():
            out[f"{name}_ms"], out[f"{name}_launches"] = device_profile(
                torch, fn, 20)
    return out


def check_route_plan(torch, case, arch, t, cap, dtype, seed, train):
    """The fused route-and-plan launch against its plain version on one MoE
    chunk's gate logits (cast to ``dtype``) at ``arch``'s width:
    indices, destinations and flags equal; probabilities within 1e-6; in
    serving (``train`` False, as on that path) the statistics too, within
    1e-6 relative. Timed beside its plain version and its bound (logits
    read; probabilities, indices, destinations, flags and statistics
    written), and, for fp32 logits (the path's), beside ``route_paths``."""
    from repro_torch.kernels.topk_router import route_plan, route_plan_ref
    cfg, tokens, params = route_inputs(torch, arch, t, seed, False)
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    logits = (tokens.float() @ params["w_gate"]).to(getattr(torch, dtype))
    kw = dict(stats=not train, aux_loss_weight=m.aux_loss_weight,
              z_loss_weight=m.z_loss_weight)
    got = route_plan(logits, k, cap, **kw)
    want = route_plan_ref(logits, k, cap, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("idx", "dest", "valid"), got[1:4], want[1:4]):
        if not torch.equal(a, b):
            bad = (a != b).reshape(t, -1).any(-1).nonzero().flatten()
            raise AssertionError(f"route_plan {case} {dtype}: {name} differs "
                                 f"in rows {bad[:20].tolist()}")
    rel = 0.0
    if kw["stats"]:
        if not torch.equal(got[4]["primary_count"], want[4]["primary_count"]):
            raise AssertionError(f"route_plan {case} {dtype}: counts differ")
        for key in ("prob_sum", "z_sq_sum", "aux_loss", "z_loss"):
            a, b = got[4][key].double(), want[4][key].double()
            rel = max(rel, ((a - b).abs() / b.abs()).max().item())
        if not rel <= 1e-6:
            raise AssertionError(f"route_plan {case} {dtype}: statistics "
                                 f"{rel:.3g} off, relative")
    item = logits.element_size()
    out_bytes = t * k * (4 + 4 + 4 + 1) + (4 * (2 * e + 3) if kw["stats"]
                                           else 0)
    paths = (route_paths(torch, arch, t, cap, seed, train)
             if dtype == "float32" else {})
    return kernel_row(
        "topk_router", f"plan_{case}", dtype, (got[0] - want[0]).abs(), 1e-6,
        got[0], lambda: route_plan(logits, k, cap, **kw),
        lambda: route_plan_ref(logits, k, cap, **kw),
        roof(t * e * item + out_bytes, 5 * t * e, "float32"),
        shape=dict(T=t, E=e, k=k, C=cap, stats=kw["stats"]),
        dropped=int((~got[3]).sum()), stats_max_rel_err=rel, **paths)


# each MoE chunk's routing on the main paths: (case, arch, tokens, train)
ROUTE_SHAPES = (("train", "moe-gpt3-s", 2048, True),
                ("serve_decode", "moe-gpt3-s", 8, False),
                ("serve_prefill", "moe-gpt3-s", 16, False),
                ("deepseek_decode", "deepseek-v2-lite-16b", 8, False),
                ("deepseek_prefill", "deepseek-v2-lite-16b", 16, False),
                ("deepseek_t64", "deepseek-v2-lite-16b", 64, False))


def route_plan_cases(torch) -> list:
    """``check_route_plan`` at every shape of ``ROUTE_SHAPES``, with the
    path's capacity (``capacity_for``) and a tight one (an eighth of it,
    at least 1: routes drop), bf16 and fp32 logits."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline_moe import capacity_for
    rows = []
    for dtype in ("bfloat16", "float32"):
        for case, arch, t, train in ROUTE_SHAPES:
            m = get_config(arch).moe
            cap = capacity_for(t, m.top_k, m.capacity_factor, m.num_experts)
            for c, tag in ((cap, ""), (max(1, cap // 8), "_tight")):
                rows.append(check_route_plan(torch, case + tag, arch, t, c,
                                             dtype, 100 + len(rows), train))
    return rows


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


# the flash kernel's head-dim-192 rows (MLA's expanded prefill) as the
# kernels line carries them beside the kernel's head row
D192_KEYS = ("case", "dtype", "shape", "max_abs_err", "tol", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")


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
    both models and at the training chunks of moe-bert-l (M 1024, H 4096)
    and moe-gpt3-xl (M 2048, H 8192); attention at the training shape,
    with a window, with GQA, at head dim 128, at MLA's head dim 192 (the
    dense MLA prefill: DeepSeek-V2-Lite's 16 heads at 4 x 1024 tokens, and
    the fixed-batch loop's 8 x 64) and (bf16) at the training batches of
    moe-bert-l (8 heads of 128) and moe-gpt3-xl (16 heads of 128)."""
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
            # the training chunks of moe-bert-l and moe-gpt3-xl (phase 15)
            for case, m, h in (("train_bert_l", 1024, 4096),
                               ("train_xl", 2048, 8192)):
                rows.append(check_grouped(torch, case, 64, 40, m, h, False,
                                          "gelu", dtype, seed=10 * len(rows)))
            for case, hq in (("train_bert_l", 8), ("train_xl", 16)):
                rows.append(check_flash(torch, case, 8, 1024, hq, hq, 128, 0,
                                        dtype, seed=10 * len(rows),
                                        library=True))
        for case, b, s, hq, kv, d, window, lib in (
                ("train", 8, 1024, 8, 8, 96, 0, True),
                ("window256", 8, 1024, 8, 8, 96, 256, False),
                ("gqa4", 8, 1024, 8, 2, 96, 0, False),
                ("d128", 4, 1024, 16, 16, 128, 0, True),
                ("d192", 4, 1024, 16, 16, 192, 0, True),
                ("d192_fixed_batch", 8, 64, 16, 16, 192, 0, True)):
            rows.append(check_flash(torch, case, b, s, hq, kv, d, window,
                                    dtype, seed=10 * len(rows),
                                    library=lib))
        torch.cuda.empty_cache()
    # the expert-parallel shapes, after the others so that theirs keep
    # their seeds: the inputs phase 18's paths give the expert FFN at
    # mesh (1, 2), 32 experts a rank (``ep_phase.ffn_cases``):
    # moe-gpt3-s's training chunk [32, 2·cap, 768], DeepSeek-V2-Lite's
    # prefill chunk [32, 2·cap, 2048] and its replicated decode
    # [32, cap, 2048]
    import ep_phase
    import serve_ranks_phase
    for dtype in ("bfloat16", "float32"):
        for case, ((e, c, m), h, gated, act, _) in \
                ep_phase.ffn_cases().items():
            rows.append(check_grouped(torch, case, e, c, m, h, gated, act,
                                      dtype, seed=10 * len(rows)))
    # the serving engine's replicated decode over two ranks (phase 19):
    # [32, 8, 768], H 3072
    for dtype in ("bfloat16", "float32"):
        for case, ((e, c, m), h, gated, act) in \
                serve_ranks_phase.ffn_cases().items():
            rows.append(check_grouped(torch, case, e, c, m, h, gated, act,
                                      dtype, seed=10 * len(rows)))
    # training over ranks, finished (phase 20): the (2, 2) training chunk
    # and the (1, 2) traced layer's chunk
    import ep_state_phase
    for dtype in ("bfloat16", "float32"):
        for case, ((e, c, m), h, gated, act, _) in \
                ep_state_phase.ffn_cases().items():
            rows.append(check_grouped(torch, case, e, c, m, h, gated, act,
                                      dtype, seed=10 * len(rows)))
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 8: serving
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


def prefill_chunks(engine, bucket: int) -> int:
    """MoE chunks of one prefill step of ``bucket`` tokens: the n the
    engine resolved for the bucket, as ``pipeline_moe._resolve_partitions``
    runs it."""
    from repro_torch.core.pipeline_moe import _resolve_partitions
    n, strategy = engine.adaptive.resolutions[bucket]
    cfg = dataclasses.replace(engine.cfg, moe=dataclasses.replace(
        engine.cfg.moe, num_partitions=n, memory_reuse_strategy=strategy))
    return _resolve_partitions(cfg, bucket, "prefill")


def serve(cfg, reqs, *, seed=0, device="cuda", reset=None, engine=None,
          on_step=None, **opts):
    """Run ``reqs`` through ``engine`` (default: a fresh ``Engine``), one
    ``step`` at a time; returns it, the requests, the run's host clocks
    and its MoE chunks.
    The clocks: wall seconds and the CPU seconds of the thread that
    drives the engine (a CUDA sync spins, so CPU well below wall means
    the thread waited off-core: for a core, or asleep). The chunks: how
    many times each MoE layer ran a chunk, summed over the steps that
    ran the model (a decode runs one; a prefill of ``bucket`` tokens
    runs ``prefill_chunks`` of them). The engine's ``warmup()`` runs
    first (the decode step's capture, each bucket's resolution); then
    ``reset`` is called right before the engine serves, ``on_step(i)``
    after its step ``i``."""
    from repro_torch.serve import Engine, EngineOptions
    if engine is None:
        engine = Engine(cfg, options=EngineOptions(device=device, **ENGINE,
                                                   **opts), seed=seed)
    engine.warmup()
    handles = [engine.submit(p, max_new_tokens=m) for p, m in reqs]
    if reset is not None:
        reset()
    wall, cpu = time.perf_counter(), time.thread_time()
    infos = []
    while engine.has_work:
        infos.append(engine.step())
        if on_step is not None:
            on_step(len(infos) - 1)
    host = dict(wall_s=time.perf_counter() - wall,
                thread_cpu_s=time.thread_time() - cpu)
    chunks = sum(1 if i["kind"] == "decode" else
                 prefill_chunks(engine, i["bucket"])
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
    return dict(run=run, attn_kernel=s["attn_kernel"],
                decode_graph=engine.opts.decode_graph, **host,
                loadavg_1m=os.getloadavg()[0],
                prefill_tok_per_s=s["prefill_tok_per_s"],
                decode_tok_per_s=s["decode_tok_per_s"],
                p50_ttft_s=s["p50_ttft_s"], p50_itl_s=s["p50_itl_s"],
                p50_decode_step_ms=s["p50_decode_step_s"] * 1e3,
                decode_steps=s["decode_steps"],
                decode_replays=s["decode_replays"],
                preempt_recompute=s["preempt_recompute"],
                preempt_offload=s["preempt_offload"])


def moe_layer_kernels(torch, engine) -> float:
    """CUDA launches of one MoE layer in a decode step: the engine's first
    MoE layer, as ``moe.layer.apply`` runs it in decode mode without
    autograd, on one token per slot."""
    from repro_torch.moe import layer as moe_layer
    cfg = engine.cfg
    i = next(j for j, r in enumerate(cfg.layer_roles()) if r["moe"])
    params = engine.params["periods"][0][f"l{i}"]["moe"]
    x = randn(torch, (engine.kv.max_slots, 1, cfg.d_model), 9,
              dtype=cfg.compute_dtype)
    with torch.no_grad():
        return device_profile(torch, lambda: moe_layer.apply(
            params, x, cfg=cfg, mode="decode"), 5)[1]


HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch")
KERNEL_FAMILIES = ("paged_decode_kernel", "paged_mla_", "grouped_ffn_",
                   "route_plan_kernel")


def traced(torch, fn, tries: int = 3):
    """``fn`` under ``torch.profiler``, until the trace shows device time
    (a trace now and then comes back empty). Returns the host seconds and
    the profiler's averages: the CUDA kernels and the host launch calls
    (``HOST_LAUNCHES``: one ``cudaGraphLaunch`` per replay)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        averages = prof.key_averages()
        kernels = [e for e in averages
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(e.self_device_time_total for e in kernels) > 0:
            launches = sum(e.count for e in averages
                           if e.key in HOST_LAUNCHES)
            return wall, kernels, launches
        log("traced: the profiler saw no device time; again")
    raise AssertionError(f"the profiler saw no device time in {tries} "
                         f"traces")


def families(kernels) -> dict:
    """CUDA kernels of the port's own, by family (``KERNEL_FAMILIES``)."""
    out = collections.Counter()
    for e in kernels:
        fam = next((f for f in KERNEL_FAMILIES if f in e.key), None)
        if fam is not None:
            out[fam] += e.count
    return dict(out)


TRACE_ATTEMPTS = 3


def replay_vs_eager(torch, engine) -> dict:
    """On a captured engine whose batch is decoding: one replay of the
    decode graph and one eager run of the same step on the same inputs
    (every decoding slot's last token, its page table and length). Each
    run writes the step's KV position of each slot itself before reading
    it, so the eager run sees what the replay saw. The replay must run
    the port's kernels exactly as often as the eager step does, the eager
    step must make the wrapper calls the capture recorded, and the
    logits must agree within one bf16 rounding of the largest,
    2^-7·max|eager| + 1e-5. A pair of traces whose kernels differ is
    logged and traced again, up to ``TRACE_ATTEMPTS`` pairs."""
    import numpy as np
    from repro_torch.kernels import build
    step, kv = engine._decode, engine.kv
    if step.graph is None:
        raise AssertionError("the engine has no captured decode step")
    tokens = np.zeros((kv.max_slots, 1), np.int64)
    active = np.zeros((kv.max_slots,), bool)
    for s in engine.scheduler.decode_slots():
        tokens[s, 0] = engine.scheduler.running[s].output[-1]
        active[s] = True
    inputs = kv.decode_inputs()
    step.tokens.refresh(tokens)
    step.active.refresh(active)
    out = {}

    def replay():
        step.graph.replay()
        build.replayed(step.launches)
        out["replay"] = step.logits.float().clone()

    def eager():
        before = collections.Counter(build.LAUNCHES)
        with torch.no_grad():
            out["eager"] = step._forward(*inputs).float()
        out["calls"] = dict(collections.Counter(build.LAUNCHES) - before)

    for attempt in range(TRACE_ATTEMPTS):
        _, k_replay, l_replay = traced(torch, replay)
        _, k_eager, l_eager = traced(torch, eager)
        diff = float((out["replay"] - out["eager"]).abs().max())
        tol = 2.0 ** -7 * float(out["eager"].abs().max()) + 1e-5
        row = dict(replay_kernels=families(k_replay),
                   eager_kernels=families(k_eager),
                   replay_kernels_all=sum(e.count for e in k_replay),
                   eager_kernels_all=sum(e.count for e in k_eager),
                   replay_host_launches=l_replay,
                   eager_host_launches=l_eager,
                   recorded=dict(step.launches), eager_calls=out["calls"],
                   logits_max_abs_diff=diff, logits_tol=tol,
                   active_slots=int(active.sum()), attempt=attempt)
        if row["replay_kernels"] == row["eager_kernels"] \
                and row["replay_kernels"]:
            break
        # the profiler can lose a trace's records (it can also come back
        # empty, which ``traced`` retries): trace both runs again, and
        # fail only if no attempt shows the same kernels
        log("replay-vs-eager-retrace " + json.dumps(row))
    else:
        raise AssertionError(f"a replay ran other kernels than the eager "
                             f"step in {TRACE_ATTEMPTS} traces: {row}")
    if row["eager_calls"] != row["recorded"]:
        raise AssertionError(f"the capture recorded other launches than "
                             f"the eager step makes: {row}")
    if not diff <= tol:
        raise AssertionError(f"captured logits differ from eager: {row}")
    return row


def profile_decode(torch, engine, steps: int = 10) -> dict:
    """Trace ``steps`` decode steps of a full batch (8 fresh requests,
    prefilled first) with ``torch.profiler``: wall time per step, device
    kernel time per step, the expert FFN's and the paged decode
    attention's device time per step and share (their kernels' names
    carry ``grouped_ffn`` and ``paged_``), the kernels that take the
    most of it, the host launch calls a step (a replay is one
    ``cudaGraphLaunch`` beside sampling's few launches), the CUDA
    launches of one MoE layer (``moe_layer_kernels``) and, on a captured
    engine, ``replay_vs_eager`` of the batch's next step."""
    from repro_torch.serve import RequestState
    batch = [engine.submit(p, max_new_tokens=m)
             for p, m in requests(engine.cfg.vocab_size,
                                  engine.kv.max_slots, seed=3,
                                  prompt=(64, 64), gen=(64, 64))]
    while any(r.state != RequestState.DECODE for r in batch):
        engine.step()

    def run():
        for _ in range(steps):
            if engine.step()["kind"] != "decode":
                raise AssertionError("profiled step was not a decode")

    wall, kernels, launches = traced(torch, run)
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    check = (replay_vs_eager(torch, engine)
             if engine._decode.graph is not None else None)
    engine.run_until_idle()
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    ffn_s = sum(e.self_device_time_total for e in kernels
                if "grouped_ffn" in e.key) / 1e6
    attn_s = sum(e.self_device_time_total for e in kernels
                 if "paged_" in e.key) / 1e6
    return dict(
        steps=steps, decode_graph=engine._decode.graph is not None,
        wall_ms_per_step=wall / steps * 1e3,
        device_ms_per_step=device_s / steps * 1e3,
        device_busy_share=device_s / wall,
        grouped_ffn_ms_per_step=ffn_s / steps * 1e3,
        grouped_ffn_share_of_device=ffn_s / device_s,
        paged_attention_ms_per_step=attn_s / steps * 1e3,
        paged_attention_share_of_device=attn_s / device_s,
        kernels_per_step=sum(e.count for e in kernels) / steps,
        host_launches_per_step=launches / steps,
        kernels_per_moe_layer=moe_layer_kernels(torch, engine),
        top=[dict(name=e.key[:60],
                  ms_per_step=e.self_device_time_total / 1e3 / steps,
                  calls_per_step=e.count / steps) for e in top],
        replay_vs_eager=check)


def check_replays(cfg, engine, attn_kernel) -> None:
    """One capture per engine, one replay per decode step (the capture
    is ``warmup``'s), and the launches it recorded are one decode step's:
    the decode kernel once per attention layer, router and expert FFN
    once per MoE layer."""
    s = engine.stats()
    n_moe = cfg.num_periods * sum(r["moe"] for r in cfg.layer_roles())
    want = {attn_kernel: cfg.num_layers, "grouped_ffn": n_moe,
            "topk_router": n_moe}
    if s["decode_captures"] != 1 or s["decode_replays"] != s["decode_steps"] \
            or dict(engine._decode.launches) != want:
        raise AssertionError(f"captures {s['decode_captures']}, replays "
                             f"{s['decode_replays']} for "
                             f"{s['decode_steps']} decode steps, recorded "
                             f"{dict(engine._decode.launches)} != {want}")


def capture_vs_eager(torch, build, cfg, reqs, pairs, params, attn_kernel,
                     tag, **opts) -> dict:
    """``pairs`` pairs of serve runs of ``reqs`` with the decode step
    captured and eager, in turns (captured first in even pairs, eager
    first in odd ones), each on a fresh ``Engine`` over the same
    ``params``; every run must launch as ``check_serve_launches`` asks,
    and every captured run must replay as ``check_replays`` asks. Then
    a 10-step ``profile_decode`` of each mode. Logs a
    ``capture-vs-eager`` line per run and a ``capture-vs-eager-summary``
    line; returns the summary."""
    import gc
    import statistics
    from repro_torch.serve import Engine, EngineOptions
    runs = []
    for pair in range(pairs):
        modes = (True, False) if pair % 2 == 0 else (False, True)
        for graph in modes:
            engine = Engine(cfg, params, options=EngineOptions(
                device="cuda", decode_graph=graph, **ENGINE, **opts))
            engine, handles, host, chunks = serve(
                cfg, reqs, engine=engine, reset=build.reset_launches)
            check_serve_launches(cfg, engine, collections.Counter(
                build.LAUNCHES), chunks, attn_kernel)
            if graph:
                check_replays(cfg, engine, attn_kernel)
            row = dict(serve_sample(len(runs), engine, host), arch=cfg.name,
                       pair=pair)
            log(f"capture-vs-eager {tag} " + json.dumps(row))
            runs.append(row)
            del engine, handles
            gc.collect()
    summary = dict(arch=cfg.name, tag=tag, pairs=pairs)
    for graph in (True, False):
        mine = [r for r in runs if r["decode_graph"] == graph]
        engine = Engine(cfg, params, options=EngineOptions(
            device="cuda", decode_graph=graph, **ENGINE, **opts))
        engine.warmup()
        prof = profile_decode(torch, engine)
        log(f"capture-vs-eager-profile {tag} " + json.dumps(prof))
        summary["captured" if graph else "eager"] = dict(
            p50_decode_step_ms=[r["p50_decode_step_ms"] for r in mine],
            median_p50_decode_step_ms=statistics.median(
                r["p50_decode_step_ms"] for r in mine),
            decode_tok_per_s=[r["decode_tok_per_s"] for r in mine],
            wall_s=[r["wall_s"] for r in mine],
            profile_wall_ms_per_step=prof["wall_ms_per_step"],
            profile_device_ms_per_step=prof["device_ms_per_step"],
            device_busy_share=prof["device_busy_share"],
            kernels_per_step=prof["kernels_per_step"],
            host_launches_per_step=prof["host_launches_per_step"])
        del engine
        gc.collect()
    log("capture-vs-eager-summary " + json.dumps(summary))
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phases 9 and 11: serving DeepSeek-V2-Lite
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


def deepseek_phase(torch, build, launcher) -> tuple:
    """Full-width, full-depth DeepSeek-V2-Lite in bf16: the launcher, then
    an ``Engine`` (8 slots, 16-token pages, 64-token chunks) serving 8
    seeded requests (prompts 16-256, 16-32 new tokens), its decode
    profile, capture vs eager in turns and the same requests under
    ``preempt="auto"`` with a 48-page pool. Returns the first ``Engine``
    run's kernel launches, the weights (for the prefix-cache and dense
    phases) and that run's p50 decode step ms."""
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
                                               attn_kernel="auto",
                                               adaptive=False, **ENGINE),
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
    check_replays(cfg, engine, "paged_mla_decode")
    log("decode-profile-deepseek " + json.dumps(profile_decode(torch,
                                                               engine)))
    params = engine.params
    del engine, handles
    gc.collect()
    torch.cuda.empty_cache()
    capture_vs_eager(torch, build, cfg, reqs, 2, params, "paged_mla_decode",
                     "deepseek", adaptive=False)
    # "auto" preemption with a pool tight enough to preempt: 48 pages for
    # 8 requests whose prompts need 77 and whose budgets need 90
    engine = Engine(cfg, params, options=EngineOptions(
        device="cuda", preempt="auto", num_pages=48, adaptive=False,
        **ENGINE))
    swaps = timed_swaps(torch, engine.kv)
    engine, handles, host, chunks = serve(cfg, reqs, engine=engine,
                                          reset=build.reset_launches)
    check_auto(cfg, engine, chunks, "paged_mla_decode", "deepseek", swaps,
               host)
    del engine, handles
    gc.collect()
    torch.cuda.empty_cache()
    return launches, params, row["p50_decode_step_ms"]


def with_capacity(cfg, cf: float):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def oracle_tokens(cfg, params, reqs) -> list:
    """``dense_greedy_reference`` of each request, one at a time."""
    from repro_torch.serve import dense_greedy_reference
    return [dense_greedy_reference(params, cfg, p, m) for p, m in reqs]


def captured_tokens(cfg, params, reqs, reset=None) -> tuple:
    """Greedy tokens of a captured kernel-path engine over ``params``,
    and its launches from ``reset`` on."""
    from repro_torch.serve import Engine, EngineOptions
    eng = Engine(cfg, params, options=EngineOptions(
        device="cuda", attn_kernel="kernel", adaptive=False, **ENGINE))
    eng, hs, _, _ = serve(cfg, reqs, engine=eng, reset=reset)
    out = [list(r.output) for r in hs]
    return out, eng


def oracle_at_125(cfg, params, reqs, tag: str) -> dict:
    """At the config's capacity factor 1.25, measured and not asserted:
    (a) how many requests of the captured engine equal the oracle, and
    each first differing (request, token): batched decode drops tokens
    that the one-request oracle does not; (b) two identical captured
    runs against each other: a difference there is run to run, what
    idle slots sharing one sink offset would cause."""
    cfg = with_capacity(cfg, 1.25)
    runs = [captured_tokens(cfg, params, reqs)[0] for _ in range(2)]
    want = oracle_tokens(cfg, params, reqs)
    parted = [[i, first_parting([g], [w])[1]]
              for i, (g, w) in enumerate(zip(runs[0], want)) if g != w]
    row = dict(tag=tag, capacity_factor=1.25, requests=len(reqs),
               tokens=sum(map(len, want)),
               equal_to_oracle=len(reqs) - len(parted),
               first_differing=parted,
               run_to_run_equal=runs[0] == runs[1],
               run_to_run_first_parting=first_parting(runs[0], runs[1]))
    log("oracle-cf1.25 " + json.dumps(row))
    return row


def gather_vs_kernel(torch, arch: str) -> None:
    """Equal greedy tokens through the decode kernel, captured and eager,
    through the gather path (captured) and from ``dense_greedy_reference``
    (one request at a time over a dense cache): full width, 2 layers,
    fp32, capacity factor 8.0 (no token is dropped, so the batch does not
    change a request's tokens), 8 requests; then ``oracle_at_125``."""
    cfg = with_capacity(serve_config(num_layers=2, dtype="float32",
                                     arch=arch), 8.0)
    small = requests(cfg.vocab_size, 8, seed=2, prompt=(16, 200),
                     gen=(16, 32))
    outs = {}
    params = None
    for kern, graph in (("kernel", True), ("kernel", False),
                        ("gather", True)):
        eng, hs, _, _ = serve(cfg, small, attn_kernel=kern,
                              decode_graph=graph, preempt="recompute",
                              adaptive=False)
        if eng.stats()["decode_captures"] != int(graph):
            raise AssertionError(f"{arch} {kern}: "
                                 f"{eng.stats()['decode_captures']} "
                                 f"captures with decode_graph={graph}")
        outs[(kern, graph)] = [list(r.output) for r in hs]
        params = eng.params
        del eng, hs
    outs[("oracle", False)] = oracle_tokens(cfg, params, small)
    ref = outs[("kernel", True)]
    for key, got in outs.items():
        if got != ref:
            raise AssertionError(
                f"{arch}: fp32 2-layer greedy tokens of {key} differ from "
                f"the captured kernel path's at (request, token) "
                f"{first_parting(got, ref)}")
    log(f"kernel-vs-gather {arch} fp32 2 layers capacity 8.0: "
        f"{sum(map(len, ref))} greedy tokens equal (kernel captured, "
        f"kernel eager, gather captured, dense_greedy_reference)")
    oracle_at_125(cfg, params, small, f"{arch} 2 layers")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 11: the dense-cache path
# ---------------------------------------------------------------------------

FIXED_BATCH = {"moe-gpt3-s": ("128", "32"), DEEPSEEK: ("64", "16")}


def fixed_batch(torch, build, launcher, arch: str, params,
                engine_p50_ms=None) -> collections.Counter:
    """The launcher's fixed-batch loop (no ``--engine``) at full width and
    depth in bf16 over ``params``: 2 batches of 8 prompts, prefill (n
    resolved for the batch's tokens) and dense decode. Checks each
    request batch's tokens and the launches: flash once per attention
    layer of every prefill, router and expert FFN once per MoE layer of
    every chunk (the prefill's n, a decode step's one). Logs tok/s, the
    dense decode step's p50 ms beside the captured engine's
    (``engine_p50_ms``, from the serve phase), and
    ``max_memory_allocated`` beside what the card held before (every
    weight still alive). Returns the launches."""
    from repro_torch.core.pipeline_moe import _resolve_partitions
    plen, gen = FIXED_BATCH[arch]
    argv = ["--arch", arch, "--batch", "8", "--prompt-len", plen,
            "--gen", gen, "--requests", "2", "--seed", "1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    build.reset_launches()
    stats = launcher.main(argv, params=params)
    torch.cuda.synchronize()
    launches = collections.Counter(build.LAUNCHES)
    cfg = serve_config(arch=arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_partitions=stats["num_partitions"]))
    chunks = _resolve_partitions(cfg, 8 * int(plen), "prefill")
    n_moe = cfg.num_periods * sum(r["moe"] for r in cfg.layer_roles())
    want = {"flash_attention": cfg.num_layers * 2,
            "topk_router": n_moe * (2 * chunks + stats["decode_steps"]),
            "grouped_ffn": n_moe * (2 * chunks + stats["decode_steps"])}
    if {k: launches[k] for k in want} != want or not stats["decode_steps"]:
        raise AssertionError(f"fixed-batch {arch}: launches "
                             f"{dict(launches)}, expected {want}")
    if stats["tokens_generated"] < 2 * 8 * (int(gen) // 2):
        raise AssertionError(f"fixed-batch {arch}: {stats}")
    row = dict(arch=arch, dtype=cfg.compute_dtype, batch=8,
               prompt_len=int(plen), gen=int(gen), requests=2,
               tokens=stats["tokens_generated"], wall_s=stats["wall_s"],
               tok_per_s=stats["tok_per_s"],
               p50_decode_step_ms=stats["p50_decode_step_ms"],
               engine_p50_decode_step_ms=engine_p50_ms,
               decode_steps=stats["decode_steps"],
               n=stats["num_partitions"], strategy=stats["strategy"],
               prefill_chunks=chunks,
               memory_allocated_before=held,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches=dict(launches))
    log("fixed-batch " + json.dumps(row))
    return launches


def oracle_full_depth(torch, build) -> collections.Counter:
    """Full-width, full-depth moe-gpt3-s in fp32 (7.8 GB of weights),
    8 seeded requests: the captured engine's greedy tokens equal
    ``dense_greedy_reference``'s at capacity factor 8.0; then
    ``oracle_at_125``. Returns the launches of the engine run and of
    the oracle's prefills and decode steps."""
    import gc

    from repro_torch.models import lm
    cfg = with_capacity(serve_config(dtype="float32"), 8.0)
    params = lm.init(cfg, 0, device="cuda")
    reqs = requests(cfg.vocab_size, 8, seed=4, prompt=(16, 128),
                    gen=(16, 32))
    got, eng = captured_tokens(cfg, params, reqs, reset=build.reset_launches)
    launches = collections.Counter(build.LAUNCHES)
    check_replays(cfg, eng, "paged_decode_attention")
    del eng
    build.reset_launches()
    t0 = time.perf_counter()
    want = oracle_tokens(cfg, params, reqs)
    oracle_s = time.perf_counter() - t0
    oracle_launches = collections.Counter(build.LAUNCHES)
    if oracle_launches["flash_attention"] != cfg.num_layers * len(reqs):
        raise AssertionError(f"the oracle's prefills launched flash "
                             f"{oracle_launches['flash_attention']} times")
    if got != want:
        raise AssertionError(
            f"moe-gpt3-s fp32 full depth capacity 8.0: the captured "
            f"engine parts from dense_greedy_reference at (request, "
            f"token) {first_parting(got, want)}")
    log(f"oracle-vs-engine moe-gpt3-s fp32 12 layers capacity 8.0: "
        f"{sum(map(len, want))} greedy tokens of {len(reqs)} requests "
        f"equal (captured engine, dense_greedy_reference in "
        f"{oracle_s:.1f} s)")
    oracle_at_125(cfg, params, reqs, "moe-gpt3-s 12 layers")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches + oracle_launches


def timed_swaps(torch, kv) -> list:
    """Wrap the cache's ``offload_slot`` and ``restore_slot`` in host
    clocks between two ``torch.cuda.synchronize`` calls; returns the list
    they fill with (kind, bytes, seconds)."""
    out = []
    for name in ("offload_slot", "restore_slot"):
        def timed(*args, _fn=getattr(kv, name), _name=name, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nbytes = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            out.append((_name, nbytes, time.perf_counter() - t0))
            return nbytes
        setattr(kv, name, timed)
    return out


def swap_row(engine, swaps) -> dict:
    """The run's preemptions by mode, each victim's costs and choice
    (``Engine.preempt_log``), and the swap bytes and GB/s each way."""
    s = engine.stats()
    row = dict(preempt_recompute=s["preempt_recompute"],
               preempt_offload=s["preempt_offload"], resumes=s["resumes"],
               swap_out_bytes=s["swap_out_bytes"],
               swap_in_bytes=s["swap_in_bytes"], victims=engine.preempt_log)
    for kind, key in (("offload_slot", "out"), ("restore_slot", "in")):
        mine = [(n, t) for k, n, t in swaps if k == kind]
        if mine:
            row[f"swap_{key}_gb_per_s"] = (sum(n for n, _ in mine) / 1e9
                                           / sum(t for _, t in mine))
            row[f"swap_{key}_ms_each"] = [t * 1e3 for _, t in mine]
    return row


def check_auto(cfg, engine, chunks, attn_kernel, tag, swaps,
               host=None) -> None:
    """A ``preempt="auto"`` run on the card: launches and replays as the
    other runs, offload allowed, at least one victim, and every victim
    preempted by its ``PreemptionCost`` choice. Logs an ``auto-preempt``
    line with each victim's costs and the swaps (``swap_row``)."""
    from repro_torch.kernels import build
    check_serve_launches(cfg, engine, collections.Counter(build.LAUNCHES),
                         chunks, attn_kernel)
    check_replays(cfg, engine, attn_kernel)
    row = dict(arch=cfg.name, dtype=cfg.compute_dtype, preempt="auto",
               offload_allowed=engine.offload_allowed,
               **({} if host is None else host))
    row.update(swap_row(engine, swaps))
    if not engine.offload_allowed or not row["victims"] or any(
            v.get("choice") != v["mode"] for v in row["victims"]):
        raise AssertionError(f"auto preemption: offload not allowed, no "
                             f"victim, or a mode other than its cost's "
                             f"choice: {row}")
    log(f"auto-preempt {tag} " + json.dumps(row))


def offload_phase(torch, build, params) -> collections.Counter:
    """moe-gpt3-s under ``preempt="offload"`` with phase 4's 16 requests
    and 65-page pool: at full width and depth in bf16 (over ``params``)
    every request completes with at least one offload, the kernels launch
    as ``check_serve_launches`` asks; the same run under ``"auto"``
    (``check_auto``); then at 2 layers in fp32, the greedy tokens of the
    offload run equal those of the recompute run of the same requests.
    Returns the full-depth offload run's launches."""
    from repro_torch.serve import Engine, EngineOptions
    cfg = serve_config()
    reqs = requests(cfg.vocab_size, 16, seed=0)
    engine = Engine(cfg, params, options=EngineOptions(
        device="cuda", preempt="offload", num_pages=65, adaptive=False,
        **ENGINE))
    swaps = timed_swaps(torch, engine.kv)
    engine, handles, host, chunks = serve(cfg, reqs, engine=engine,
                                          reset=build.reset_launches)
    launches = collections.Counter(build.LAUNCHES)
    check_serve_launches(cfg, engine, launches, chunks,
                         "paged_decode_attention")
    check_replays(cfg, engine, "paged_decode_attention")
    row = dict(serve_sample(0, engine, host), arch=cfg.name,
               dtype=cfg.compute_dtype, preempt="offload")
    row.update(swap_row(engine, swaps))
    if row["preempt_offload"] < 1:
        raise AssertionError(f"the 65-page pool made no offload: {row}")
    log("offload-serve " + json.dumps(row))
    del engine, handles
    engine = Engine(cfg, params, options=EngineOptions(
        device="cuda", preempt="auto", num_pages=65, adaptive=False,
        **ENGINE))
    engine, handles, host, chunks = serve(cfg, reqs, engine=engine,
                                          reset=build.reset_launches)
    check_auto(cfg, engine, chunks, "paged_decode_attention", "moe-gpt3-s",
               swaps=[])
    del engine, handles
    small = serve_config(num_layers=2, dtype="float32")
    outs = {}
    for mode in ("offload", "recompute"):
        eng, hs, _, _ = serve(small, reqs, preempt=mode, num_pages=65,
                              adaptive=False)
        outs[mode] = ([list(r.output) for r in hs],
                      eng.stats()[f"preempt_{mode}"])
        del eng, hs
    if outs["offload"][0] != outs["recompute"][0] or outs["offload"][1] < 1:
        raise AssertionError(f"fp32 2-layer offload run: "
                             f"{outs['offload'][1]} offloads, tokens equal "
                             f"to recompute's: "
                             f"{outs['offload'][0] == outs['recompute'][0]}")
    log(f"offload-vs-recompute moe-gpt3-s fp32 2 layers: "
        f"{sum(map(len, outs['offload'][0]))} greedy tokens equal, "
        f"{outs['offload'][1]} offloads, {outs['recompute'][1]} recomputes")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 5, 6, 10 and 12: the prefix cache and cancel
# ---------------------------------------------------------------------------

SYSTEM_LEN = 256                        # the chat trace's shared prompt
NEW_CHAT_EVERY = 4                      # turn 3: system prompt alone
# a conversation's two turns: 256 + 128 user + 64 + 8 follow-up + 64
PREFIX_ENGINE = dict(ENGINE, max_seq_len=544)
ATTN_OF = {"moe-gpt3-s": "paged_decode_attention",
           DEEPSEEK: "paged_mla_decode"}


def chat_trace(vocab: int, n: int, seed: int, user=(2, 128), gen=(32, 64),
               follow=(2, 8)) -> tuple:
    """The JAX package's chat trace (``run_prefix_compare`` in
    ``benchmarks/serving.py``), built here: ``n`` conversations share one
    ``SYSTEM_LEN``-token system prompt, each first turn adds ``user``
    tokens and asks ``gen`` new ones; the second turn (built once the
    first has drained) is the whole history plus ``follow`` tokens, with
    the same ``gen``. Returns (turn-1 prompts, gens, follow-ups)."""
    import numpy as np
    rng = np.random.Generator(np.random.Philox(key=seed))
    system = rng.integers(0, vocab, size=SYSTEM_LEN, dtype=np.int32)
    turn1 = [np.concatenate([system, rng.integers(
        0, vocab, size=int(rng.integers(user[0], user[1] + 1)),
        dtype=np.int32)]) for _ in range(n)]
    gens = [int(rng.integers(gen[0], gen[1] + 1)) for _ in range(n)]
    ups = [rng.integers(0, vocab, size=int(rng.integers(follow[0],
                                                        follow[1] + 1)),
                        dtype=np.int32) for _ in range(n)]
    return turn1, gens, ups


def page_bits(torch, kv, page: int) -> list:
    """One physical page of every pool leaf, as raw bits."""
    from repro_torch.models.module import leaves
    return [bits(torch, t[page]).clone() for t in leaves(kv.pools)]


def watch_cow(torch, kv) -> list:
    """Wrap the cache's ``ensure_private``: where a call finds shared
    pages in the range it privatises, the shared pages are read before
    it, the call is timed with CUDA events on the current stream, and
    right after it each copy-on-write target must be bit-equal to its
    source as it was, and the source unchanged. Returns the list the
    calls fill: per copying call its copies and device ms, and per copy
    the source, its trie node and its bits (``check_cow_sources``)."""
    out = []
    real = kv.ensure_private

    def wrapped(slot, tokens):
        pages = list(kv._slot_pages[slot])
        lo = int(kv.lens[slot]) // kv.page_size
        hi = min(kv.pages_for(tokens), len(pages))
        shared = {pages[i]: page_bits(torch, kv, pages[i])
                  for i in range(lo, hi) if kv._refs[pages[i]] > 1}
        if not shared:
            return real(slot, tokens)
        copies = kv.prefix_cow_copies
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ok = real(slot, tokens)
        end.record()
        end.synchronize()
        moved = [(pages[i], kv._slot_pages[slot][i]) for i in range(lo, hi)
                 if pages[i] in shared and kv._slot_pages[slot][i] != pages[i]]
        for src, dst in moved:
            want = shared[src]
            if not (all(torch.equal(a, b) for a, b in
                        zip(page_bits(torch, kv, dst), want))
                    and all(torch.equal(a, b) for a, b in
                            zip(page_bits(torch, kv, src), want))):
                raise AssertionError(f"copy-on-write of page {src} into "
                                     f"{dst} is not bit-equal")
            out.append(dict(src=src, node=kv._node_of_page.get(src),
                            bits=want))
        out.append(dict(copies=kv.prefix_cow_copies - copies,
                        ms=start.elapsed_time(end)))
        return ok

    kv.ensure_private = wrapped
    return out


def check_cow_sources(torch, kv, cows) -> int:
    """After a run: every copy-on-write source that is still published
    under the same trie node holds the bits it had when it was copied.
    Returns how many were checked."""
    checked = 0
    for c in cows:
        if "src" in c and c["node"] is not None \
                and kv._node_of_page.get(c["src"]) is c["node"]:
            if not all(torch.equal(a, b) for a, b in
                       zip(page_bits(torch, kv, c["src"]), c["bits"])):
                raise AssertionError(f"the published page {c['src']} "
                                     f"changed after it was copied")
            checked += 1
    return checked


def chat_run(torch, build, cfg, params, trace, mode, attn_kernel,
             **opts) -> dict:
    """One leg of the chat trace on a fresh ``Engine`` over ``params``
    (``prefix_cache=mode``, the decode step captured): ``warmup()``,
    turn 1, drain, turn 2 (each history plus its follow-up), drain, then
    a third turn in which every ``NEW_CHAT_EVERY``-th client opens a new
    conversation with the system prompt alone (16 full pages, all
    cached: the hit stops at its last token, mid-page, so that token's
    prefill copies the shared page on write), drain. Checks
    that every request completes, ``check_integrity()``, the captures
    and replays (``check_replays``), the launches
    (``check_serve_launches``, its chunks those the run ran), bit-exact
    copies on write, and, with the cache on, a warm turn that hits and a
    copy on write. Returns the leg's row (with its engine and the
    outputs, turn by turn, under ``engine`` and ``outputs``)."""
    import numpy as np
    from repro_torch.serve import Engine, EngineOptions
    from repro_torch.serve.engine import quantile
    engine = Engine(cfg, params, options=EngineOptions(
        device="cuda", prefix_cache=mode, **dict(PREFIX_ENGINE, **opts)))
    engine.warmup()
    kv = engine.kv
    cows = watch_cow(torch, kv)
    build.reset_launches()
    turn1, gens, ups = trace
    peak = dict(logical=0, physical=0, sharing=1.0)
    chunks = [0]

    def drain():
        while engine.has_work:
            info = engine.step()
            if info.get("tokens"):
                chunks[0] += (1 if info["kind"] == "decode" else
                              prefill_chunks(engine, info["bucket"]))
            held = [p for s in engine.scheduler.running
                    for p in kv._slot_pages[s]]
            if held:
                peak["logical"] = max(peak["logical"], len(held))
                peak["physical"] = max(peak["physical"], len(set(held)))
                peak["sharing"] = max(peak["sharing"],
                                      len(held) / len(set(held)))

    wall = time.perf_counter()
    r1 = [engine.submit(p, max_new_tokens=g) for p, g in zip(turn1, gens)]
    drain()
    cold = engine.stats()
    turn2 = [np.concatenate([p, np.asarray(r.output, np.int32), f])
             for p, r, f in zip(turn1, r1, ups)]
    r2 = [engine.submit(p, max_new_tokens=g) for p, g in zip(turn2, gens)]
    drain()
    warm = engine.stats()
    again = list(range(0, len(turn1), NEW_CHAT_EVERY))
    r3 = [engine.submit(turn1[i][:SYSTEM_LEN], max_new_tokens=gens[i])
          for i in again]
    drain()
    wall = time.perf_counter() - wall
    kv.check_integrity()
    s = engine.stats()
    for r, g in zip(r1 + r2 + r3, gens + gens + [gens[i] for i in again]):
        if len(r.output) != g:
            raise AssertionError(f"{mode}: request {r.rid} gave "
                                 f"{len(r.output)} of {g} tokens")
    check_replays(cfg, engine, attn_kernel)
    check_serve_launches(cfg, engine, collections.Counter(build.LAUNCHES),
                         chunks[0], attn_kernel)
    warm_hit = warm["prefix_hit_tokens"] - cold["prefix_hit_tokens"]
    if mode == "on" and (warm_hit <= 0 or not s["prefix_cow_copies"]):
        raise AssertionError(f"the warm turn hit {warm_hit} cached tokens, "
                             f"{s['prefix_cow_copies']} copies on write")
    ttft = {f"turn{i}": [r.ttft_s for r in rs] for i, rs in
            ((1, r1), (2, r2), (3, r3))}
    calls = [c for c in cows if "ms" in c]
    row = dict(
        arch=cfg.name, dtype=cfg.compute_dtype, prefix_cache=mode,
        conversations=len(turn1), wall_s=wall,
        prefix_hits=s["prefix_hits"], prefix_misses=s["prefix_misses"],
        prefix_hit_tokens=s["prefix_hit_tokens"],
        warm_hit_tokens=warm_hit,
        warm_prompt_tokens=int(sum(len(p) for p in turn2)),
        warm_hit_rate=warm_hit / sum(len(p) for p in turn2),
        prefill_tokens=s["prefill_tokens"], prefill_steps=s["prefill_steps"],
        **{f"ttft_p{q}_{t}_s": quantile(v, q) for t, v in ttft.items()
           for q in (50, 99)},
        cow_copies=s["prefix_cow_copies"], cow_bytes=s["prefix_cow_bytes"],
        cow_calls=len(calls), cow_ms=[c["ms"] for c in calls],
        cow_sources_checked=check_cow_sources(torch, kv, cows),
        evicted_pages=s["prefix_evicted_pages"],
        cached_pages=s["prefix_cached_pages"],
        peak_logical_pages=peak["logical"],
        peak_physical_pages=peak["physical"],
        peak_page_sharing_x=peak["sharing"],
        peak_used_pages=kv.peak_used_pages, pool_pages=kv.num_pages,
        decode_steps=s["decode_steps"],
        p50_decode_step_ms=s["p50_decode_step_s"] * 1e3,
        decode_replays=s["decode_replays"], chunks=chunks[0],
        launches=dict(build.LAUNCHES))
    row["engine"] = engine
    row["outputs"] = [list(r.output) for r in r1 + r2 + r3]
    return row


def prefix_pairs(torch, build, cfg, params, trace, attn_kernel, tag,
                 pairs) -> collections.Counter:
    """``pairs`` pairs of chat-trace legs with the prefix cache off and
    on, in turns (off first in even pairs); logs a ``prefix-cache`` line
    per leg and a ``prefix-cache-summary`` line. Returns the launches of
    the legs with the cache on."""
    import gc
    import statistics
    legs, launches = [], collections.Counter()
    for pair in range(pairs):
        for mode in (("off", "on") if pair % 2 == 0 else ("on", "off")):
            row = chat_run(torch, build, cfg, params, trace, mode,
                           attn_kernel, adaptive=False)
            del row["engine"], row["outputs"]
            if mode == "on":
                launches.update(row["launches"])
            row["pair"] = pair
            log(f"prefix-cache {tag} " + json.dumps(row))
            legs.append(row)
            gc.collect()
    summary = dict(arch=cfg.name, tag=tag, pairs=pairs)
    for mode in ("off", "on"):
        mine = [r for r in legs if r["prefix_cache"] == mode]
        summary[mode] = {k: [r[k] for r in mine] for k in (
            "warm_hit_rate", "ttft_p50_turn2_s", "ttft_p99_turn2_s",
            "ttft_p50_turn1_s", "prefill_tokens", "cow_copies",
            "peak_logical_pages", "peak_physical_pages", "peak_used_pages",
            "p50_decode_step_ms", "wall_s")}
        summary[mode]["median_ttft_p50_turn2_s"] = statistics.median(
            r["ttft_p50_turn2_s"] for r in mine)
    log("prefix-cache-summary " + json.dumps(summary))
    torch.cuda.empty_cache()
    return launches


def first_parting(a, b):
    """(request, token) of the first place two output lists differ."""
    return next(((i, j) for i, (x, y) in enumerate(zip(a, b))
                 for j in range(max(len(x), len(y)))
                 if x[j:j + 1] != y[j:j + 1]), None)


def parting_report(torch, cfg, params, on, seq, upto) -> dict:
    """Where an on/off pair parts: ``seq`` (a second-turn prompt, whose
    first ``upto`` tokens are the prompt, then the tokens emitted before
    the parting) prefilled afresh in 64-token chunks into a cache of its
    own; the top-2 logit gap at its end, and the largest K/V difference
    between the pages that the on-leg's trie holds for the prompt and
    these recomputed ones."""
    import numpy as np
    from repro_torch.device import dtype_of
    from repro_torch.models import lm
    from repro_torch.models.module import leaves
    from repro_torch.serve.paged_kv import PagedKVCache
    ps = PREFIX_ENGINE["page_size"]
    pages = -(-len(seq) // ps)
    kv = PagedKVCache(cfg, num_pages=pages + 1, page_size=ps, max_slots=1,
                      max_pages_per_seq=pages,
                      dtype=dtype_of(cfg.compute_dtype), device="cuda")
    kv.alloc_slot(0, len(seq))
    with torch.no_grad():
        for pos in range(0, len(seq), 64):
            c = min(64, len(seq) - pos)
            toks = torch.as_tensor(np.asarray(seq[pos:pos + c], np.int64)
                                   [None], device="cuda")
            logits, _ = lm.prefill_chunk_paged(
                params, kv.pools, kv.device_page_table(0),
                kv.device_lens(0), toks, c, cfg, write_sink=kv.sink_row(0))
            kv.lens[0] += c
    top = torch.topk(logits[0].float(), 2).values
    path = on.kv._walk(0, on.kv._page_keys(seq[:upto]))
    diff = 0.0
    for i, node in enumerate(path):
        mine = int(kv.page_table[0, i])
        for s, t in zip(leaves(on.kv.pools), leaves(kv.pools)):
            diff = max(diff, float((s[node.page].float()
                                    - t[mine].float()).abs().max()))
    return dict(top2_logit_gap=float(top[0] - top[1]),
                pages_compared=len(path), max_kv_diff=diff)


def prefix_exact(torch, build, arch, n) -> int:
    """Prefix on against off at 2 layers in fp32 (TF32 off), capacity
    factor 8.0 (no token dropped), the decode step captured through the
    kernels: the greedy tokens of both turns must be equal. Where a
    second-turn pair parts, logs the parting step, the top-2 logit gap
    there and the largest K/V difference of reused against recomputed
    pages (``parting_report``) before failing. Returns the tokens
    compared."""
    import gc
    cfg = serve_config(num_layers=2, dtype="float32", arch=arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    trace = chat_trace(cfg.vocab_size, n, seed=21)
    legs = {}
    params = None
    for mode in ("off", "on"):
        row = chat_run(torch, build, cfg, params, trace, mode,
                       ATTN_OF[arch], adaptive=False)
        params = row["engine"].params
        legs[mode] = row
    off, on = legs["off"]["outputs"], legs["on"]["outputs"]
    if off != on:
        where = first_parting(off, on)
        report = dict(arch=arch, request=where[0], token=where[1])
        turn1 = trace[0]
        if where[0] >= n:                     # a second-turn request
            i = where[0] - n
            prompt = list(turn1[i]) + off[i] + list(trace[2][i])
            report.update(parting_report(
                torch, cfg, params, legs["on"]["engine"],
                prompt + on[where[0]][:where[1]], len(prompt)))
        log("prefix-exact-parted " + json.dumps(report))
        raise AssertionError(f"{arch}: prefix on/off tokens part at "
                             f"{where}")
    tokens = sum(map(len, on))
    log(f"prefix-exact {arch} fp32 2 layers: {tokens} greedy tokens equal "
        f"(cache off, on; {legs['on']['warm_hit_tokens']} warm hit tokens, "
        f"{legs['on']['cow_copies']} copies on write)")
    del legs
    gc.collect()
    return tokens


def cancel_run(torch, build, cfg, params, reqs, *, cancels=True) -> dict:
    """``reqs`` under ``preempt="offload"`` with a 65-page pool on a
    fresh captured ``Engine``, cancelling one request in each stage on
    the way: the last request while queued, then the first found
    mid-prefill, then the first offloaded, then the first decoding. After
    each cancel: ``check_integrity()``, the slot released, the victim's
    host pages gone; at the end every other request complete,
    ``on_done`` fired once a request, and a cancel of a finished request
    returns False. Returns outputs, the victims and the stats."""
    from repro_torch.serve import Engine, EngineOptions, RequestState
    engine = Engine(cfg, params, options=EngineOptions(
        device="cuda", preempt="offload", num_pages=65, adaptive=False,
        **ENGINE))
    engine.warmup()
    build.reset_launches()
    kv, sched = engine.kv, engine.scheduler
    done = collections.Counter()
    handles = [engine.submit(p, max_new_tokens=m,
                             on_done=lambda r: done.update([r.rid]))
               for p, m in reqs]
    victims, chunks = {}, 0

    def cancel(stage, req):
        slot = req.slot
        host = kv.host_bytes
        parked = req.rid in kv._offloaded
        if not engine.cancel(req):
            raise AssertionError(f"cancel of a live request returned False")
        kv.check_integrity()
        if slot >= 0 and (slot in sched.running
                          or kv.slot_page_count(slot)):
            raise AssertionError(f"slot {slot} not released")
        if parked and (req.rid in kv._offloaded or kv.host_bytes >= host):
            raise AssertionError("the offloaded victim's host pages stayed")
        if done[req.rid] != 1 or req.state != RequestState.CANCELLED:
            raise AssertionError(f"on_done fired {done[req.rid]} times")
        victims[stage] = req.rid

    finders = {
        "prefill": lambda r: (r.state == RequestState.PREFILL and 0 <
                              int(kv.lens[r.slot]) < r.prefill_len),
        "offloaded": lambda r: (r.state == RequestState.PREEMPTED
                                and r.preempt_mode == "offload"),
        "decode": lambda r: r.state == RequestState.DECODE and r.output}
    if cancels:
        cancel("queued", handles[-1])
    order = list(finders) if cancels else []
    while engine.has_work:
        info = engine.step()
        if info.get("tokens"):
            chunks += (1 if info["kind"] == "decode" else
                       prefill_chunks(engine, info["bucket"]))
        if order:
            hit = next((r for r in handles if finders[order[0]](r)), None)
            if hit is not None:
                cancel(order.pop(0), hit)
    if order:
        raise AssertionError(f"no request reached {order}")
    kv.check_integrity()
    for r, (_, m) in zip(handles, reqs):
        if r.rid not in victims.values() and len(r.output) != m:
            raise AssertionError(f"request {r.rid}: {len(r.output)} of {m}")
        if done[r.rid] != 1:
            raise AssertionError(f"on_done of {r.rid} fired {done[r.rid]}")
        if r.rid not in victims.values() and engine.cancel(r):
            raise AssertionError("a cancel of a finished request went on")
    if kv.host_bytes or kv.offloaded_count or any(kv._slot_pages):
        raise AssertionError("host or device pages left after the run")
    s = engine.stats()
    check_replays(cfg, engine, "paged_decode_attention")
    check_serve_launches(cfg, engine, collections.Counter(build.LAUNCHES),
                         chunks, "paged_decode_attention")
    return dict(outputs=[list(r.output) for r in handles], victims=victims,
                stats=s, launches=collections.Counter(build.LAUNCHES))


def cancel_phase(torch, build, params) -> collections.Counter:
    """Cancel at full width (moe-gpt3-s, bf16, over ``params``, captured)
    with phase 4's 16 requests (``cancel_run``), then at 2 layers in fp32
    with capacity factor 8.0 the same schedule with and without the
    cancels: the survivors' tokens must be equal. Returns the full-width
    run's launches."""
    cfg = serve_config()
    reqs = requests(cfg.vocab_size, 16, seed=0)
    run = cancel_run(torch, build, cfg, params, reqs)
    s = run["stats"]
    row = dict(arch=cfg.name, dtype=cfg.compute_dtype,
               victims=run["victims"],
               requests_cancelled=s["requests_cancelled"],
               cancelled_by_stage=s["cancelled_by_stage"],
               requests_done=s["requests_done"],
               preempt_offload=s["preempt_offload"],
               swap_out_bytes=s["swap_out_bytes"],
               decode_replays=s["decode_replays"],
               decode_steps=s["decode_steps"])
    want = {"queued": 1, "prefill": 1, "preempted": 1, "decode": 1}
    if s["cancelled_by_stage"] != want:
        raise AssertionError(f"cancelled by stage {s['cancelled_by_stage']}")
    log("cancel " + json.dumps(row))
    small = serve_config(num_layers=2, dtype="float32")
    small = dataclasses.replace(small, moe=dataclasses.replace(
        small.moe, capacity_factor=8.0))
    with_cancels = cancel_run(torch, build, small, None, reqs)
    without = cancel_run(torch, build, small, None, reqs, cancels=False)
    gone = set(with_cancels["victims"].values())
    pairs = [(a, b) for i, (a, b) in enumerate(zip(
        with_cancels["outputs"], without["outputs"])) if i not in gone]
    if any(a != b for a, b in pairs):
        raise AssertionError("fp32 2-layer survivors' tokens differ from the "
                             "run without cancels")
    log(f"cancel-survivors moe-gpt3-s fp32 2 layers: "
        f"{sum(len(a) for a, _ in pairs)} greedy tokens of {len(pairs)} "
        f"survivors equal to the run without cancels "
        f"(victims {with_cancels['victims']})")
    torch.cuda.empty_cache()
    return run["launches"]


# ---------------------------------------------------------------------------
# phase 7: telemetry, the Poisson replay and the HTTP/SSE ingress
# ---------------------------------------------------------------------------

REPLAY_REQUESTS = 64
REPLAY_PROMPT, REPLAY_GEN = (4, 256), (2, 64)


def obs_engine(cfg, params, obs=None, **opts):
    """A captured ``Engine`` at the serving shapes, n fixed, recording
    into ``obs``."""
    from repro_torch.serve import Engine, EngineOptions
    return Engine(cfg, params, options=EngineOptions(
        device="cuda", obs=obs, adaptive=False, **dict(ENGINE, **opts)))


def wait_for(pred, what: str, timeout: float = 120.0) -> None:
    deadline = time.perf_counter() + timeout
    while not pred():
        if time.perf_counter() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def metric(text: str, name: str) -> float:
    """One sample of a Prometheus exposition."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"{name} not in the exposition")


def check_trace(doc, engine, n: int) -> dict:
    """A recorded trace: B/E balanced and nested per (pid, tid); ``n``
    ADMIT and RETIRE instants; one ``engine.step`` span a step and one
    ``PREFILL`` span a prefill step that ran the model."""
    real = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    stacks = {}
    for e in real:
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks.setdefault(key, []).append(e["name"])
        elif e["ph"] == "E" and (not stacks.get(key)
                                 or stacks[key].pop() != e["name"]):
            raise AssertionError(f"unbalanced E event {e}")
    if any(stacks.values()):
        raise AssertionError(f"spans left open: {stacks}")
    names = collections.Counter(e["name"] for e in real)
    s = engine.stats()
    want = {"ADMIT": n, "RETIRE": n, "engine.step": s["engine_steps"],
            "PREFILL": s["prefill_steps"]}
    got = {k: names[k] for k in want}
    if got != want:
        raise AssertionError(f"trace counts {got} != {want}")
    return dict(events=len(real), preempt=names["PREEMPT"],
                resume=names["RESUME"], **got)


def telemetry_pairs(torch, build, cfg, params, reqs, pairs=2) -> tuple:
    """Phase 4's run (16 requests, recompute with a 65-page pool) with
    the tracer off and on in turns, ``pairs`` pairs: the launches of the
    run and those recorded a replay, captures, replays and builds must
    be equal in every run; the first traced run's trace is written to
    ``build/`` and checked (``check_trace``). Logs a ``telemetry`` line a
    run and returns the summary and the launches."""
    import gc
    import statistics
    from repro_torch.obs import Recorder, Tracer
    runs, launches, keys = [], collections.Counter(), (
        "per_replay", "launches", "decode_captures", "decode_replays",
        "prefill_builds", "decode_steps", "prefill_steps")
    trace_row = None
    for pair in range(pairs):
        for on in ((False, True) if pair % 2 == 0 else (True, False)):
            obs = Recorder(tracer=Tracer()) if on else Recorder()
            engine = obs_engine(cfg, params, obs, preempt="recompute",
                                num_pages=65)
            engine, handles, host, chunks = serve(
                cfg, reqs, engine=engine, reset=build.reset_launches)
            got = collections.Counter(build.LAUNCHES)
            check_serve_launches(cfg, engine, got, chunks,
                                 "paged_decode_attention")
            check_replays(cfg, engine, "paged_decode_attention")
            s = engine.stats()
            row = dict(run=len(runs), pair=pair, tracer=on,
                       p50_decode_step_ms=s["p50_decode_step_s"] * 1e3,
                       decode_tok_per_s=s["decode_tok_per_s"],
                       wall_s=host["wall_s"],
                       per_replay=dict(engine._decode.launches),
                       launches=dict(got), **{k: s[k] for k in keys[2:]})
            if on and trace_row is None:
                path = ROOT / "build" / "telemetry_trace.json"
                path.parent.mkdir(exist_ok=True)
                obs.tracer.write(str(path))
                trace_row = dict(check_trace(json.loads(path.read_text()),
                                             engine, len(reqs)),
                                 path=str(path.relative_to(ROOT)))
                log("telemetry-trace " + json.dumps(trace_row))
            log("telemetry " + json.dumps(row))
            runs.append(row)
            launches += got
            del engine, handles
            gc.collect()
    first = {k: runs[0][k] for k in keys}
    for r in runs[1:]:
        if {k: r[k] for k in keys} != first:
            raise AssertionError(f"run {r['run']} (tracer {r['tracer']}) "
                                 f"launched or built differently: "
                                 f"{ {k: r[k] for k in keys} } != {first}")

    def med(on, key):
        return statistics.median(r[key] for r in runs if r["tracer"] == on)
    off_ms, on_ms = med(False, "p50_decode_step_ms"), \
        med(True, "p50_decode_step_ms")
    summary = dict(arch=cfg.name, pairs=pairs, off_p50_decode_step_ms=[
        r["p50_decode_step_ms"] for r in runs if not r["tracer"]],
        on_p50_decode_step_ms=[r["p50_decode_step_ms"] for r in runs
                               if r["tracer"]],
        off_decode_tok_per_s=med(False, "decode_tok_per_s"),
        on_decode_tok_per_s=med(True, "decode_tok_per_s"),
        overhead_pct=100.0 * (on_ms - off_ms) / off_ms,
        per_replay=first["per_replay"], trace=trace_row)
    log("telemetry-overhead " + json.dumps(summary))
    return summary, launches


def metrics_run(torch, build, cfg, params, reqs) -> collections.Counter:
    """Phase 4's run with a ``MetricsServer`` started after ``warmup()``
    and a thread scraping ``/metrics`` every 50 ms while the main thread
    steps (the refresh makes no CUDA call); then a scrape after the run
    must agree with ``stats()``. Returns the run's launches."""
    import threading
    import urllib.request
    from repro_torch.obs import MetricsServer, Recorder
    engine = obs_engine(cfg, params, Recorder(), preempt="recompute",
                        num_pages=65)
    engine.warmup()
    server = MetricsServer(engine.obs.registry, port=0,
                           refresh=engine._refresh_gauges).start()
    scrapes, errors, stop = [], [], threading.Event()

    def scrape():
        return urllib.request.urlopen(server.url + "/metrics",
                                      timeout=30).read().decode()

    def scraper():
        while not stop.is_set():
            try:
                step = engine.step_count
                scrapes.append((step, scrape()))
            except Exception as e:                  # noqa: BLE001
                errors.append(repr(e))
            stop.wait(0.05)

    chunks = 0
    try:
        handles = [engine.submit(p, max_new_tokens=m) for p, m in reqs]
        build.reset_launches()
        thread = threading.Thread(target=scraper, daemon=True)
        thread.start()
        while engine.has_work:
            info = engine.step()
            if info.get("tokens"):
                chunks += (1 if info["kind"] == "decode" else
                           prefill_chunks(engine, info["bucket"]))
        stop.set()
        thread.join(timeout=60)
        final = scrape()
    finally:
        stop.set()
        server.stop()
    launches = collections.Counter(build.LAUNCHES)
    if errors:
        raise AssertionError(f"scrapes failed: {errors[:3]}")
    mid = [step for step, _ in scrapes if 0 < step < engine.step_count]
    if not mid:
        raise AssertionError(f"no scrape in the middle of the run "
                             f"({len(scrapes)} scrapes)")
    s = engine.stats()
    got = dict(
        requests_done=metric(final, "repro_requests_done_total"),
        tokens_generated=metric(final, "repro_tokens_generated_total"),
        preempt_recompute=metric(final,
                                 'repro_preempts_total{mode="recompute"}'),
        running_slots=metric(final, "repro_running_slots"),
        queue_waiting=metric(final, "repro_waiting_requests"),
        free_pages=metric(final, 'repro_kv_free_pages{shard="0"}'))
    want = dict(requests_done=s["requests_done"],
                tokens_generated=s["tokens_generated"],
                preempt_recompute=s["preempt_recompute"],
                running_slots=s["running_slots"],
                queue_waiting=s["queue_waiting"],
                free_pages=s["free_units_by_shard"]["0"])
    if got != want or want["running_slots"] != 0 or \
            want["free_pages"] != engine.kv.num_pages - 1 or \
            want["requests_done"] != len(reqs) or \
            not want["preempt_recompute"]:
        raise AssertionError(f"/metrics {got} != stats() {want}")
    check_serve_launches(cfg, engine, launches, chunks,
                         "paged_decode_attention")
    check_replays(cfg, engine, "paged_decode_attention")
    log("metrics-scrape " + json.dumps(dict(
        scrapes=len(scrapes), mid_run=len(mid), steps=engine.step_count,
        **got)))
    return launches


def replay_row(build, cfg, params, trace, time_scale: float,
               offered=None) -> tuple:
    """One ``serve.trace.replay`` of ``trace`` on a fresh captured engine
    (the worst-case pool: nothing preempts). Returns the row (req/s,
    tok/s and the p50 / p99 of TTFT, ITL and latency, each from the
    registry) and the replay's launches."""
    from repro_torch.obs import Recorder
    from repro_torch.serve import replay
    engine = obs_engine(cfg, params, Recorder(), preempt="recompute")
    engine.warmup()
    build.reset_launches()
    t0 = time.perf_counter()
    done = replay(engine, trace, time_scale=time_scale)
    wall = time.perf_counter() - t0
    launches = collections.Counter(build.LAUNCHES)
    for r, e in zip(done, trace):
        if len(r.output) != e.max_new_tokens:
            raise AssertionError(f"replay request {r.rid}: {len(r.output)} "
                                 f"of {e.max_new_tokens} tokens")
    check_replays(cfg, engine, "paged_decode_attention")
    reg, s = engine.obs.registry, engine.stats()
    if reg.get("repro_requests_done_total").value != len(trace):
        raise AssertionError("the registry missed requests")
    row = dict(requests=len(trace), time_scale=time_scale,
               offered_req_per_s=offered, wall_s=wall,
               req_per_s=len(trace) / wall,
               tok_per_s=s["tokens_generated"] / wall,
               decode_steps=s["decode_steps"],
               prefill_steps=s["prefill_steps"],
               p50_decode_step_ms=s["p50_decode_step_s"] * 1e3)
    for key, fam in (("ttft", "repro_ttft_seconds"),
                     ("itl", "repro_itl_seconds"),
                     ("latency", "repro_latency_seconds")):
        for p in (50, 99):
            row[f"{key}_p{p}_ms"] = reg.get(fam).quantile(p) * 1e3
    return row, launches


def replay_phase(build, cfg, params) -> collections.Counter:
    """``poisson_trace`` of 64 requests: all at once (``time_scale=0``,
    the most req/s the engine sustains), then offered at ~50% and ~120%
    of that rate. Logs a ``poisson-replay`` line a run."""
    from repro_torch.serve import poisson_trace

    def trace(rate):
        return poisson_trace(REPLAY_REQUESTS, rate=rate,
                             vocab_size=cfg.vocab_size,
                             prompt_len_range=REPLAY_PROMPT,
                             gen_len_range=REPLAY_GEN, seed=5)
    row, launches = replay_row(build, cfg, params, trace(1.0), 0.0)
    log("poisson-replay " + json.dumps(row))
    peak = row["req_per_s"]
    for share in (0.5, 1.2):
        row, got = replay_row(build, cfg, params, trace(share * peak), 1.0,
                              offered=share * peak)
        log("poisson-replay " + json.dumps(dict(row, share=share)))
        launches += got
    return launches


class TimedClient:
    """An ``IngressClient`` that stamps each SSE event's arrival on the
    process clock (``times``), so its delay after the engine's emit
    (``Request.token_times``, same clock) can be read."""

    def __init__(self, srv, timeout: float = 300.0):
        from repro_torch.serve import IngressClient

        class Client(IngressClient):
            def _events(inner, f):
                for ev in IngressClient._events(f):
                    self.times.append(time.perf_counter())
                    yield ev
        self.client = Client(srv.host, srv.port, timeout=timeout)
        self.times = []

    def generate(self, prompt, **kw):
        self.times = []
        return self.client.generate(prompt, **kw)


def steps_between(engine, rid: int) -> int:
    """``engine.step`` spans that started after the request's
    ``DISCONNECT`` (stamped once its cancel is queued) and before its
    ``CANCEL``."""
    from repro_torch.obs import PID_INGRESS, PID_REQUESTS
    ev = engine.obs.tracer.export()["traceEvents"]
    t0 = next(e["ts"] for e in ev if e["name"] == "DISCONNECT"
              and e["pid"] == PID_INGRESS and e["tid"] == rid)
    t1 = next(e["ts"] for e in ev if e["name"] == "CANCEL"
              and e["pid"] == PID_REQUESTS and e["tid"] == rid)
    return sum(1 for e in ev if e["name"] == "engine.step"
               and t0 < e["ts"] < t1)


def serve_alone(engine, reqs) -> list:
    """Each request served alone, one after the other, in-process."""
    out = []
    for p, m in reqs:
        r = engine.submit(p, max_new_tokens=m)
        engine.run_until_idle()
        out.append(list(r.output))
    return out


# 8 SSE clients in a process of their own (stdin: host, port and the
# requests as JSON; stdout: each stream's status, tokens, TTFT and the
# arrival of each event on time.perf_counter(), which is CLOCK_MONOTONIC
# on Linux and so comparable with the engine's stamps)
CLIENT_PROCESS = r"""
import json, sys, threading, time
sys.path.insert(0, sys.argv[1])
from repro_torch.serve.ingress import IngressClient
spec = json.loads(sys.stdin.read())
out = [None] * len(spec["reqs"])

def run(i, prompt, m):
    times = []

    class Client(IngressClient):
        def _events(self, f):
            for ev in IngressClient._events(f):
                times.append(time.perf_counter())
                yield ev
    r = Client(spec["host"], spec["port"], timeout=300).generate(
        prompt, max_new_tokens=m)
    out[i] = dict(status=r.status, tokens=r.tokens, ttft_s=r.ttft_s,
                  times=times)

threads = [threading.Thread(target=run, args=(i, p, m), daemon=True)
           for i, (p, m) in enumerate(spec["reqs"])]
for t in threads:
    t.start()
for t in threads:
    t.join(300)
print(json.dumps(out))
"""


def ingress_burst(engine, srv, reqs, *, remote: bool) -> dict:
    """``reqs`` as SSE streams all at once, from client threads of this
    process or (``remote``) of a process of their own: TTFT and ITL p50
    at the client, the engine's ITL p50, each token's SSE delay after
    its emit (p50, p99) and the p50 decode step meanwhile."""
    import concurrent.futures
    from repro_torch.obs import quantile
    mark, d0 = len(engine.done), len(engine.step_s["decode"])
    if remote:
        spec = dict(host=srv.host, port=srv.port,
                    reqs=[([int(t) for t in p], m) for p, m in reqs])
        proc = subprocess.run(
            [sys.executable, "-c", CLIENT_PROCESS, str(ROOT / "src")],
            input=json.dumps(spec), capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"client process: {proc.stderr[-2000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
    else:
        clients = [TimedClient(srv) for _ in reqs]
        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
            futs = [ex.submit(c.generate, p, max_new_tokens=m)
                    for c, (p, m) in zip(clients, reqs)]
            res = [dict(status=r.status, tokens=r.tokens, ttft_s=r.ttft_s,
                        times=c.times)
                   for c, r in zip(clients, (f.result(timeout=300)
                                             for f in futs))]
    wait_for(lambda: len(engine.done) == mark + len(reqs)
             and not engine.has_work, "the streams' retirement")
    d1 = len(engine.step_s["decode"])
    if any(r["status"] != 200 or len(r["tokens"]) != m
           for r, (_, m) in zip(res, reqs)):
        raise AssertionError("an SSE stream came short")
    served = {tuple(r.prompt): r for r in engine.done[mark:]}
    delay, itl = [], []
    for r, (p, _) in zip(res, reqs):
        req, times = served[tuple(int(t) for t in p)], r["times"]
        if [int(t) for t in req.output] != r["tokens"]:
            raise AssertionError("SSE tokens differ from the engine's")
        delay += [t - e for t, e in zip(times, req.token_times)]
        itl += [b - a for a, b in zip(times, times[1:])]
    if min(delay) < 0:
        raise AssertionError(f"an event arrived {min(delay)} s before "
                             f"its emit: the clocks differ")
    reqs_served = list(served.values())
    return dict(
        clients="process" if remote else "threads",
        ttft_p50_ms=quantile([r["ttft_s"] for r in res], 50) * 1e3,
        itl_p50_ms=quantile(itl, 50) * 1e3,
        engine_ttft_p50_ms=quantile([r.ttft_s for r in reqs_served],
                                    50) * 1e3,
        engine_itl_p50_ms=quantile([g for r in reqs_served
                                    for g in r.itl_s], 50) * 1e3,
        sse_delay_p50_ms=quantile(delay, 50) * 1e3,
        sse_delay_p99_ms=quantile(delay, 99) * 1e3,
        p50_decode_step_ms=quantile(engine.step_s["decode"][d0:d1],
                                    50) * 1e3)


def ingress_full(torch, build, cfg, params, reqs) -> collections.Counter:
    """Full width, bf16: an in-process engine and an ingress engine,
    both fresh, serve the same work in the same order, so their sink
    pages share a history: two requests alone (tokens must be equal),
    then 8 at once, in-process against 8 SSE clients (``ingress_burst``,
    once from threads of this process and once from a process of their
    own): TTFT and ITL p50, each token's SSE delay after its emit, and
    the p50 decode step meanwhile. Then a client hangs up mid-stream
    (cancelled within one engine step, ``check_integrity()``, every page
    back), and ``reject`` answers 429 with ``Retry-After`` under
    overload. Returns the ingress's launches."""
    import concurrent.futures
    from repro_torch.obs import Recorder, Tracer, quantile
    from repro_torch.serve import IngressClient, IngressOptions, \
        IngressServer
    alone, eight = reqs[:2], reqs[:8]
    inproc = obs_engine(cfg, params, Recorder(), preempt="recompute")
    inproc.warmup()
    want_alone = serve_alone(inproc, alone)
    d0 = len(inproc.step_s["decode"])
    handles = [inproc.submit(p, max_new_tokens=m) for p, m in eight]
    inproc.run_until_idle()
    row = dict(
        arch=cfg.name, dtype=cfg.compute_dtype, streams=len(eight),
        inproc_ttft_p50_ms=quantile([r.ttft_s for r in handles], 50) * 1e3,
        inproc_itl_p50_ms=quantile([g for r in handles for g in r.itl_s],
                                   50) * 1e3,
        inproc_p50_decode_step_ms=quantile(inproc.step_s["decode"][d0:],
                                           50) * 1e3)
    del inproc, handles

    engine = obs_engine(cfg, params, Recorder(tracer=Tracer()),
                        preempt="recompute")
    engine.warmup()
    build.reset_launches()
    srv = IngressServer(engine, options=IngressOptions(
        admission_queue=8)).start()
    try:
        cli = IngressClient(srv.host, srv.port, timeout=300)
        got_alone = [cli.generate(p, max_new_tokens=m).tokens
                     for p, m in alone]
        if got_alone != want_alone:
            raise AssertionError("a request served alone through the "
                                 "ingress gave other tokens than in-process")
        # a stream ends at its last event, the engine retires it just
        # after: wait for that before reading the engine
        wait_for(lambda: len(engine.done) == len(alone)
                 and not engine.has_work, "the alone requests' retirement")
        row["alone_tokens_equal"] = sum(map(len, got_alone))
        row["threads"] = ingress_burst(engine, srv, eight, remote=False)
        row["process"] = ingress_burst(engine, srv, eight, remote=True)
        # hang-up mid-stream
        victim = TimedClient(srv).generate(reqs[8][0], max_new_tokens=64,
                                           disconnect_after=3)
        wait_for(lambda: engine.cancelled and not engine.has_work,
                 "the disconnected request's cancel")
        between = steps_between(engine, engine.cancelled[-1].rid)
        engine.kv.check_integrity()
        if between > 1 or len(victim.tokens) != 3 or \
                engine.kv.free_pages != engine.kv.num_pages - 1:
            raise AssertionError(f"disconnect: {between} steps before the "
                                 f"cancel, {engine.kv.free_pages} free "
                                 f"pages of {engine.kv.num_pages - 1}")
    finally:
        srv.stop(timeout=120)
    srv = IngressServer(engine, options=IngressOptions(
        admission_queue=1, shed_policy="reject")).start()
    try:
        cli = IngressClient(srv.host, srv.port, timeout=300)
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            blocker = ex.submit(cli.generate, reqs[9][0],
                                max_new_tokens=64)
            wait_for(lambda: srv._inflight >= 1, "the blocker's admission")
            shed = cli.generate(reqs[10][0], max_new_tokens=4)
            held = blocker.result(timeout=300)
        if shed.status != 429 or shed.retry_after_s < 1 or \
                len(held.tokens) != 64:
            raise AssertionError(f"reject: status {shed.status}, "
                                 f"Retry-After {shed.retry_after_s}")
    finally:
        srv.stop(timeout=120)
    launches = collections.Counter(build.LAUNCHES)
    check_replays(cfg, engine, "paged_decode_attention")
    reg = engine.obs.registry.snapshot()
    row.update(
        disconnect_steps_to_cancel=between,
        rejected=reg["repro_ingress_requests_total"]['outcome="rejected"'],
        disconnects=reg["repro_ingress_disconnects_total"])
    log("ingress " + json.dumps(row))
    return launches


def ingress_exact(torch, build) -> None:
    """2 layers, fp32, capacity factor 8.0 (no token is dropped, so the
    batch does not change a request's tokens): SSE tokens, sequential and
    8 at once, equal the in-process engine's; under ``degrade`` a clamped
    stream's tokens are a prefix of the request served alone."""
    import concurrent.futures
    from repro_torch.serve import IngressClient, IngressOptions, \
        IngressServer
    cfg = serve_config(num_layers=2, dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    reqs = requests(cfg.vocab_size, 8, seed=0)
    ref = obs_engine(cfg, None, preempt="recompute")
    ref.warmup()
    handles = [ref.submit(p, max_new_tokens=m) for p, m in reqs]
    ref.run_until_idle()
    want = [list(r.output) for r in handles]
    engine = obs_engine(cfg, ref.params, preempt="recompute")
    engine.warmup()
    srv = IngressServer(engine).start()
    try:
        cli = IngressClient(srv.host, srv.port, timeout=300)
        seq = [cli.generate(p, max_new_tokens=m).tokens for p, m in reqs]
        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
            futs = [ex.submit(cli.generate, p, max_new_tokens=m)
                    for p, m in reqs]
            together = [f.result(timeout=300).tokens for f in futs]
    finally:
        srv.stop(timeout=120)
    if seq != want or together != want:
        raise AssertionError("fp32 SSE tokens differ from in-process")
    srv = IngressServer(engine, options=IngressOptions(
        admission_queue=1, shed_policy="degrade",
        degrade_max_new=2)).start()
    try:
        cli = IngressClient(srv.host, srv.port, timeout=300)
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            blocker = ex.submit(cli.generate, reqs[1][0],
                                max_new_tokens=reqs[1][1])
            wait_for(lambda: srv._inflight >= 1, "the blocker's admission")
            clamped = cli.generate(reqs[0][0], max_new_tokens=reqs[0][1])
            blocker.result(timeout=300)
    finally:
        srv.stop(timeout=120)
    if not clamped.degraded or clamped.tokens != want[0][:2]:
        raise AssertionError(f"degrade: {clamped.tokens} is not a prefix "
                             f"of {want[0][:4]}...")
    log(f"ingress-exact moe-gpt3-s fp32 2 layers: {sum(map(len, want))} "
        f"greedy tokens of {len(reqs)} SSE streams equal to in-process, "
        f"sequential and {len(reqs)} at once; a degraded stream's "
        f"{len(clamped.tokens)} tokens a prefix of its request alone")
    engine.kv.check_integrity()


def obs_phase(torch, build, params) -> collections.Counter:
    """Phase 7 (moe-gpt3-s, full width, bf16, over phase 4's params):
    the tracer off and on in turns, ``/metrics`` scraped mid-run, the
    Poisson replay, the ingress; then the ingress's exact-token checks
    at 2 layers in fp32. Returns the full-width runs' launches."""
    cfg = serve_config()
    reqs = requests(cfg.vocab_size, 16, seed=0)
    _, launches = telemetry_pairs(torch, build, cfg, params, reqs)
    launches += metrics_run(torch, build, cfg, params, reqs)
    launches += replay_phase(build, cfg, params)
    launches += ingress_full(torch, build, cfg, params, reqs)
    torch.cuda.empty_cache()
    ingress_exact(torch, build)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 14 and 17: training
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


# ---------------------------------------------------------------------------
# phase 15: train-memory (optimizers, remat, checkpoints, the paper models)
# ---------------------------------------------------------------------------

MEMORY_OPTIMIZERS = ("adamw", "adamw8bit", "adafactor")
MEMORY_REMATS = ("nothing", "dots", "full")
# (arch, layers or None for the config's depth, optimizers): the paper's
# two larger models; moe-gpt3-xl's full depth does not fit one card under
# any optimizer (13.5 B parameters: 108 GB of fp32 weights, gradients
# and Adafactor state), so it trains at 4 layers (2 MoE layers)
PAPER_MODELS = (("moe-bert-l", None, ("adamw8bit", "adafactor")),
                ("moe-gpt3-xl", 4, ("adafactor",)))
STATE_RTOL = 0.01               # measured state bytes against the reckoning
LOSS0_RTOL = 1e-6               # step 0's loss across the remat policies
TRAIN_KERNELS = ("flash_attention", "topk_router", "grouped_ffn")


def memory_config(arch="moe-gpt3-s", optimizer="adamw", remat="nothing",
                  num_layers=None):
    """A paper model at full width in bf16 compute (fp32 params), n = 4
    chunks under S4, with the given optimizer and remat policy."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, compute_dtype="bfloat16", optimizer=optimizer,
        remat_policy=remat, num_layers=num_layers or cfg.num_layers,
        moe=dataclasses.replace(cfg.moe, num_partitions=4,
                                memory_reuse_strategy="s4"))


def reckoned_state_bytes(cfg) -> int:
    """The optimizer state's bytes reckoned from the parameter shapes of
    the JAX tree (period leaves stacked): AdamW 2 x 4 B a parameter; the
    8-bit AdamW 2 x (1 B a parameter + a 4 B scale a row) for a leaf of
    JAX rank 2 or more, else 2 x 4 B; Adafactor 4 B a ``vr`` / ``vc``
    element for a leaf of JAX rank 2 or more, else 4 B a parameter."""
    from repro_torch.models import lm
    from repro_torch.optim.groups import groups
    total = 0
    for g in groups(lm.specs_tree(cfg)):
        shape = tuple(g.leaves[0].shape)
        if g.stacked:
            shape = (len(g.leaves),) + shape
        n = math.prod(shape)
        big = len(shape) >= 2
        if cfg.optimizer == "adamw" or not big:
            total += 8 * n if cfg.optimizer != "adafactor" else 4 * n
        elif cfg.optimizer == "adamw8bit":
            total += 2 * (n + 4 * (n // shape[-1]))
        else:
            total += 4 * (math.prod(shape[:-1])
                          + math.prod(shape[:-2] + shape[-1:]))
    return total


def opt_bytes(state) -> int:
    """The optimizer state's bytes, counted from its tensors."""
    from repro_torch.optim.groups import paths
    out = 0
    for _, x in paths(state["opt"]):
        if isinstance(x, tuple):          # an 8-bit moment: q and scale
            out += sum(t.nbytes for t in x)
        elif hasattr(x, "nbytes"):
            out += x.nbytes
    return out


def memory_run(torch, build, cfg, steps, tag, *, state=None, seed=0,
               expect=True, **train_kw) -> tuple:
    """``steps`` steps of ``cfg`` through ``runtime.train`` on batches of
    8 x 1024 (``SyntheticTokens``, seed 0), from ``state`` or a fresh
    init. Checks finite losses and, with ``expect``, each kernel's
    launches against ``launches_per_step``. Logs a ``train-memory`` row:
    peak memory, the optimizer state's bytes beside their reckoning (which
    must agree within ``STATE_RTOL``), the median step ms, the losses and
    the launches. Returns (state, row)."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import lm
    from repro_torch.runtime import TrainOptions, init_state, train
    import gc
    opts = TrainOptions(lr=1e-4, warmup=2, total_steps=20)
    torch.cuda.synchronize()
    gc.collect()                  # what an earlier run left in a cycle
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    if state is None:
        state = init_state(cfg, opts, seed=seed)
    build.reset_launches()
    src = SyntheticTokens(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0)
    state, hist = train(cfg, steps=steps, batch_source=src, opts=opts,
                        state=state, adaptive=False, **train_kw)
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in TRAIN_KERNELS}
    ran = len(hist)
    per = launches_per_step(cfg, TRAIN_BATCH * TRAIN_SEQ, 4, "s4")
    if expect and launches != {k: v * ran for k, v in per.items()}:
        raise AssertionError(f"{tag}: launches {launches}, expected "
                             f"{per} a step x {ran}")
    losses = [h["loss"] for h in hist]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: losses {losses}")
    ms = sorted(h["step_time_s"] * 1e3 for h in hist[1:] or hist)
    n_params = lm.count_params(cfg)
    measured = opt_bytes(state)
    reckoned = reckoned_state_bytes(cfg)
    row = dict(tag=tag, arch=cfg.name, layers=cfg.num_layers,
               params=n_params, optimizer=cfg.optimizer,
               remat=cfg.remat_policy, strategy="s4", n=4,
               steps=[h["step"] for h in hist], losses=losses,
               step_ms=ms[len(ms) // 2],
               step_ms_all=[h["step_time_s"] * 1e3 for h in hist],
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               start_allocated=start,
               param_bytes=4 * n_params, state_bytes=measured,
               reckoned_state_bytes=reckoned,
               state_bytes_per_param=measured / n_params,
               launches=launches, launches_per_step=per)
    log("train-memory " + json.dumps(row))
    if abs(measured - reckoned) > STATE_RTOL * reckoned:
        raise AssertionError(f"{tag}: state {measured} B against the "
                             f"reckoned {reckoned} B")
    return state, row


def memory_optimizers(torch, build) -> collections.Counter:
    """(a) Full-width moe-gpt3-s, 3 steps under each optimizer from the
    same init."""
    launches = collections.Counter()
    for opt in MEMORY_OPTIMIZERS:
        state, row = memory_run(torch, build, memory_config(optimizer=opt),
                                3, f"optimizer-{opt}")
        launches.update(row["launches"])
        del state
    return launches


def memory_remat(torch, build) -> collections.Counter:
    """(b) The same shape under AdamW, 2 steps under each remat policy
    from the same init: step 0's loss equal within ``LOSS0_RTOL`` (the
    forward is the same), peak memory ordered full <= dots <= nothing.
    The recompute launches the kernels again, so the launches are logged
    and held to at least those of ``nothing``."""
    launches = collections.Counter()
    rows = {}
    for remat in MEMORY_REMATS:
        state, rows[remat] = memory_run(
            torch, build, memory_config(remat=remat), 2, f"remat-{remat}",
            expect=remat == "nothing")
        launches.update(rows[remat]["launches"])
        del state
    base = rows["nothing"]
    loss0 = [rows[r]["losses"][0] for r in MEMORY_REMATS]
    diff = max(abs(x - loss0[0]) / abs(loss0[0]) for x in loss0)
    peak = {r: rows[r]["max_memory_allocated"] for r in MEMORY_REMATS}
    summary = dict(loss0=dict(zip(MEMORY_REMATS, loss0)),
                   loss0_max_rel_diff=diff, rtol=LOSS0_RTOL, peak=peak,
                   step_ms={r: rows[r]["step_ms"] for r in MEMORY_REMATS},
                   launches={r: rows[r]["launches"] for r in MEMORY_REMATS})
    log("train-memory-remat " + json.dumps(summary))
    if not diff <= LOSS0_RTOL:
        raise AssertionError(f"remat: step-0 losses {loss0}")
    if not peak["full"] <= peak["dots"] <= peak["nothing"]:
        raise AssertionError(f"remat: peak memory {peak}")
    for r in MEMORY_REMATS:
        if any(rows[r]["launches"][k] < base["launches"][k]
               for k in TRAIN_KERNELS):
            raise AssertionError(f"remat {r}: launches {rows[r]['launches']}")
    return launches


# the checkpoint part's depth: at 12 layers its ~12 GB written, moved
# and read back took ~75-86 s of the script's 1,200 s, at 4 layers
# 45-53 s; the script's phase 20 took that time back
CKPT_LAYERS = 2


def memory_ckpt(torch, build) -> collections.Counter:
    """(c) moe-gpt3-s under ``adamw8bit`` with a ``Checkpointer`` in a
    temporary directory: 4 steps with a save at step 2 (a clone of the
    state taken on the card at that save) and at 4. Then the step-2
    checkpoint alone is moved to a second directory, as if the run had
    died before step 4's, and a run from a fresh init (another seed) over
    it resumes: the state it restores must equal the clone bit for bit,
    and its steps 2-3 must give the uninterrupted run's losses within
    CARD_VS_CPU_RTOL. Logs each save's blocking part (the copy to the
    host: ms, GB/s) and its writer's seconds, and the restore's."""
    import shutil
    import tempfile

    from repro_torch.ckpt import Checkpointer
    from repro_torch.runtime import TrainOptions, init_state

    class Cloning(Checkpointer):
        """Clones the state on the card at its step-2 save; records each
        save's blocking copy and its writer's seconds."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.clone, self.saves = None, []

        def save(self, step, state, block=False):
            self.wait()
            if self.saves:
                self.saves[-1]["write_s"] = self.last_write_s
            if step == 2 and self.clone is None:
                self.clone = [t.detach().clone()
                              for t in state_tensors(state)]
            super().save(step, state, block)
            self.saves.append(dict(step=step, bytes=self.last_bytes,
                                   copy_ms=self.last_copy_s * 1e3,
                                   copy_gb_s=self.last_bytes
                                   / self.last_copy_s / 1e9))

    class Checked(Checkpointer):
        """Times its restore and holds the restored state to ``clone``."""

        def __init__(self, *a, clone, **k):
            super().__init__(*a, **k)
            self.clone, self.restore_s, self.checked = clone, None, 0

        def restore_latest(self, abstract=None, like=None, shardings=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().restore_latest(like=like)
            torch.cuda.synchronize()
            self.restore_s = time.perf_counter() - t0
            got = state_tensors(out["state"])
            if out["step"] != 2 or len(got) != len(self.clone) or not all(
                    torch.equal(x.detach().view(torch.uint8),
                                y.view(torch.uint8))
                    for x, y in zip(got, self.clone)):
                raise AssertionError("ckpt: the restored step-2 state "
                                     "differs from the clone taken at the "
                                     "save")
            self.checked, self.clone = len(got), None
            return out

    cfg = memory_config(optimizer="adamw8bit", num_layers=CKPT_LAYERS)
    root = tempfile.mkdtemp(prefix="train-memory-")
    du = shutil.disk_usage(root)
    log(f"train-memory-ckpt dir {root}: {du.free / 1e9:.1f} GB free of "
        f"{du.total / 1e9:.1f} GB")
    launches = collections.Counter()
    try:
        a, b = os.path.join(root, "a"), os.path.join(root, "b")
        ck = Cloning(a, keep=3)
        state, full = memory_run(torch, build, cfg, 4, "ckpt-uninterrupted",
                                 checkpointer=ck, ckpt_every=2)
        launches.update(full["launches"])
        ck.saves[-1]["write_s"] = ck.last_write_s
        del state
        os.makedirs(b)
        os.rename(os.path.join(a, "step_0000000002"),
                  os.path.join(b, "step_0000000002"))
        checked = Checked(b, keep=3, clone=ck.clone)
        ck.clone = None
        fresh = init_state(cfg, TrainOptions(lr=1e-4, warmup=2,
                                             total_steps=20), seed=1)
        state, resumed = memory_run(torch, build, cfg, 4, "ckpt-resumed",
                                    state=fresh, checkpointer=checked,
                                    ckpt_every=2)
        launches.update(resumed["launches"])
        del state, fresh
        if resumed["steps"] != [2, 3] or not checked.checked:
            raise AssertionError(f"ckpt: resumed at {resumed['steps']}")
        rel = max(abs(x - y) / abs(y) for x, y in
                  zip(resumed["losses"], full["losses"][2:]))
        row = dict(saves=ck.saves, restore_s=checked.restore_s,
                   restore_gb_s=ck.saves[0]["bytes"] / checked.restore_s
                   / 1e9, resumed_save_copy_ms=checked.last_copy_s * 1e3,
                   resumed_save_write_s=checked.last_write_s,
                   leaves=checked.checked, bit_equal=True,
                   uninterrupted=full["losses"][2:],
                   resumed=resumed["losses"], max_rel_diff=rel,
                   rtol=CARD_VS_CPU_RTOL)
        log("train-memory-ckpt " + json.dumps(row))
        if not rel <= CARD_VS_CPU_RTOL:
            raise AssertionError(f"ckpt: resumed losses differ by {rel}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def memory_models(torch, build) -> collections.Counter:
    """(d) moe-bert-l at full width and depth (2 steps under adamw8bit,
    then 2 under adafactor, each from its own init) and moe-gpt3-xl at
    full width and 4 layers (2 steps under adafactor): finite losses,
    launches a step, peak memory beside the reckoned state."""
    launches = collections.Counter()
    for arch, layers, opts in PAPER_MODELS:
        for opt in opts:
            state, row = memory_run(
                torch, build, memory_config(arch, opt, num_layers=layers), 2,
                f"model-{arch}-{opt}")
            launches.update(row["launches"])
            del state
    torch.cuda.empty_cache()
    return launches


MEMORY_PARTS = {"optim": memory_optimizers, "remat": memory_remat,
                "ckpt": memory_ckpt, "models": memory_models}


def train_memory_phase(torch, build, parts=tuple(MEMORY_PARTS)
                       ) -> collections.Counter:
    """Phase 15, ``train-memory``: the named parts in order; returns the
    launches of their runs."""
    launches = collections.Counter()
    for part in parts:
        t0 = time.perf_counter()
        launches += MEMORY_PARTS[part](torch, build)
        log(f"train-memory part {part} {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 16: adaptive (n, strategy)
# ---------------------------------------------------------------------------

ADAPTIVE_TRACE = (8, 4, 8, 2, 8, 4)     # batches of TRAIN_SEQ tokens
ADAPTIVE_RETUNE_EVERY = 4
LAYER_TOKENS = 8192                     # the single-layer memory runs
LAYER_PARTITIONS = (1, 2, 4, 8)
STRATEGIES = ("none", "s1", "s2", "s3", "s4")


def adaptive_config(dtype="bfloat16"):
    """Full-width moe-gpt3-s with the adaptive placeholders."""
    from repro_torch.configs import get_config
    cfg = get_config("moe-gpt3-s")
    return dataclasses.replace(cfg, compute_dtype=dtype, moe=dataclasses.replace(
        cfg.moe, num_partitions=0, memory_reuse_strategy="adaptive"))


def launches_per_step(cfg, tokens: int, n: int, strategy: str) -> dict:
    """One train step's launches at a resolved (n, strategy): flash once
    per attention layer; router and expert FFN once per chunk of every
    MoE layer, twice under S1-S4 (the checkpoint's recompute)."""
    from repro_torch.core.pipeline_moe import _resolve_partitions
    rcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_partitions=n, memory_reuse_strategy=strategy))
    chunks = _resolve_partitions(rcfg, tokens, "train")
    n_moe = cfg.num_periods * sum(r["moe"] for r in cfg.layer_roles())
    per = n_moe * chunks * (1 if strategy == "none" else 2)
    return {"flash_attention": cfg.num_layers, "topk_router": per,
            "grouped_ffn": per}


def state_tensors(state) -> list:
    """Every tensor of a train state: parameters and optimizer state."""
    out = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "data_ptr"):
            out.append(x)
    walk(state["params"])
    walk(state["opt"])
    return out


def bits(torch, t):
    """The raw bits of a tensor, for bit-equal comparisons."""
    t = t.detach()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def candidate_row(cfg, b: int, n: int, strategy, seconds: float) -> dict:
    """A measured candidate beside what the analytic core says of the
    same workload on ``GPU_H100``: the simulator's makespan of one MoE
    layer and Eq. 10's cost of each strategy, at ep 1."""
    from repro_torch.core import GPU_H100, all_costs, moe_workload, simulate
    w = moe_workload(cfg, b, 1, dp=1)
    return dict(tokens=b, n=n, strategy=strategy.value, ms=seconds * 1e3,
                simulate_ms=simulate(w, GPU_H100, n, strategy) * 1e3,
                eq10_ms={k: v * 1e3 for k, v in
                         all_costs(w, GPU_H100, n).items()})


def adaptive_train_phase(torch, build) -> collections.Counter:
    """Full-width moe-gpt3-s (bf16 compute, fp32 params, AdamW) with the
    adaptive placeholders, trained by ``runtime.train`` through an
    ``AdaptiveController(AdaptiveOptions(retune_every=4))`` over
    ``VaryingSyntheticTokens`` (batches ``ADAPTIVE_TRACE`` x 1024).
    Checks: the controller measures candidates by wall clock on the
    card; each measurement leaves the parameters and both AdamW moments
    bit-equal; one step function per distinct (n, strategy, shape); no
    more searches than (retune epoch, token count) pairs, and more than
    the distinct token counts (the timer re-measured under shape churn);
    finite losses; each step's own launches (measurements apart) match
    its resolved n. Returns the run's launches, measurements included."""
    from repro_torch.data import VaryingSyntheticTokens
    from repro_torch.runtime import (AdaptiveController, AdaptiveOptions,
                                     TrainOptions, init_state, train)
    cfg = adaptive_config()
    opts = TrainOptions(lr=1e-4, warmup=2, total_steps=20)
    state = init_state(cfg, opts, seed=0)
    ctl = AdaptiveController(cfg, opts, AdaptiveOptions(
        retune_every=ADAPTIVE_RETUNE_EVERY))
    if ctl.resolver.measure_fn != ctl._wallclock_measure:
        raise AssertionError("the controller does not measure by wall clock")
    inner, measured, cands = ctl.resolver.measure_fn, collections.Counter(), []

    def measure(b, n, strategy):
        live = state_tensors(ctl._probe[0])
        before = [bits(torch, t).clone() for t in live]
        launched = collections.Counter(build.LAUNCHES)
        seconds = inner(b, n, strategy)
        measured.update(collections.Counter(build.LAUNCHES) - launched)
        if not all(torch.equal(bits(torch, t), x)
                   for t, x in zip(live, before)):
            raise AssertionError(f"measuring (b {b}, n {n}, {strategy}) "
                                 f"wrote the train state")
        del before
        cands.append(candidate_row(cfg, b, n, strategy, seconds))
        return seconds

    ctl.resolver.measure_fn = measure
    snaps = []
    src = VaryingSyntheticTokens(cfg, ADAPTIVE_TRACE, seq=TRAIN_SEQ, seed=0)
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    state, hist = train(
        cfg, steps=len(ADAPTIVE_TRACE), batch_source=src, opts=opts,
        state=state, adaptive=ctl, heartbeat=lambda s, m: snaps.append(
            (collections.Counter(build.LAUNCHES),
             collections.Counter(measured))))
    torch.cuda.synchronize()
    total = collections.Counter(build.LAUNCHES)
    if ctl.resolver.candidates_measured < 1 or not cands:
        raise AssertionError("no candidate was measured")
    steps, prev = [], (collections.Counter(), collections.Counter())
    for h, snap in zip(hist, snaps):
        tokens = ADAPTIVE_TRACE[h["step"]] * TRAIN_SEQ
        want = launches_per_step(cfg, tokens, h["n"], h["strategy"])
        got = {k: (snap[0][k] - prev[0][k]) - (snap[1][k] - prev[1][k])
               for k in want}
        if got != want:
            raise AssertionError(f"adaptive step {h['step']} (n {h['n']}, "
                                 f"{h['strategy']}): launches {got}, "
                                 f"expected {want}")
        if not math.isfinite(h["loss"]):
            raise AssertionError(f"adaptive step {h['step']}: loss "
                                 f"{h['loss']}")
        steps.append(dict(step=h["step"], tokens=tokens, n=h["n"],
                          strategy=h["strategy"], loss=h["loss"],
                          step_ms=h["step_time_s"] * 1e3,
                          retune_ms=h.get("retune_time_s", 0.0) * 1e3,
                          launches=got))
        prev = snap
    keys = {(h["n"], h["strategy"], ADAPTIVE_TRACE[h["step"]]) for h in hist}
    if ctl.rejit_count != len(keys):
        raise AssertionError(f"{ctl.rejit_count} step functions built for "
                             f"{len(keys)} (n, strategy, shape) keys")
    last, epoch, pairs = 0, 0, set()
    for s in range(len(ADAPTIVE_TRACE)):
        if s and s - last >= ADAPTIVE_RETUNE_EVERY:
            last, epoch = s, epoch + 1
        pairs.add((epoch, ADAPTIVE_TRACE[s]))
    calls = ctl.resolver.search_calls
    if not len(set(ADAPTIVE_TRACE)) < calls <= len(pairs):
        raise AssertionError(f"{calls} searches for {len(pairs)} (epoch, "
                             f"tokens) pairs and "
                             f"{len(set(ADAPTIVE_TRACE))} token counts")
    row = dict(trace=[b * TRAIN_SEQ for b in ADAPTIVE_TRACE],
               retune_every=ADAPTIVE_RETUNE_EVERY, measure="wallclock",
               hw=ctl.aopts.hw.name, rejit_count=ctl.rejit_count,
               retune_count=ctl.retune_count, search_calls=calls,
               candidates_measured=ctl.resolver.candidates_measured,
               retune_s=ctl.resolver.retune_s, steps=steps,
               measurement_launches=dict(measured),
               max_memory_allocated=torch.cuda.max_memory_allocated())
    log("adaptive-train " + json.dumps(row))
    for c in cands:
        log("adaptive-candidate " + json.dumps(c))
    del state, ctl
    torch.cuda.empty_cache()
    return total


def strategy_memory(torch) -> list:
    """One pipelined MoE layer alone (``core.pipeline_moe``) at
    moe-gpt3-s width (8192 tokens, bf16 weights and tokens, E 64, M 768,
    H 3072), forward and backward under NONE and S1-S4 at each n of
    ``LAYER_PARTITIONS``: the bytes the forward leaves held for the
    backward (its output apart) and the peak of forward plus backward,
    both above the allocation at entry, beside ``MoEMemory(b, m, h, e,
    n, bytes_per=2).totals()``."""
    from repro_torch.core import MoEMemory, pipelined_moe
    from repro_torch.models import module
    from repro_torch.moe import layer as moe_layer
    cfg = adaptive_config()
    m = cfg.moe
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = module.build(moe_layer.specs(cfg), gen, "cuda",
                          leaf_fn=lambda path, x: x.to(torch.bfloat16)
                          .requires_grad_(True))
    x = randn(torch, (LAYER_TOKENS, cfg.d_model), 11,
              dtype="bfloat16").requires_grad_(True)
    flat = [x] + module.leaves(params)
    rows = []
    for strategy in STRATEGIES:
        for n in LAYER_PARTITIONS:
            scfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                m, num_partitions=n, memory_reuse_strategy=strategy))
            torch.cuda.synchronize()
            entry = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out, aux = pipelined_moe(params, x, cfg=scfg, mode="train")
            torch.cuda.synchronize()
            held = (torch.cuda.memory_allocated() - entry
                    - out.numel() * out.element_size())
            loss = out.float().square().mean() + sum(aux.values())
            grads = torch.autograd.grad(loss, flat)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - entry
            del out, aux, loss, grads
            pred = MoEMemory(b=LAYER_TOKENS, m=cfg.d_model, h=m.d_expert,
                             e=m.num_experts, n=n, bytes_per=2).totals()
            row = dict(strategy=strategy, n=n, tokens=LAYER_TOKENS,
                       forward_held_bytes=held, peak_bytes=peak,
                       moememory=pred)
            log("strategy-memory " + json.dumps(row))
            rows.append(row)
    del params, x, flat
    torch.cuda.empty_cache()
    return rows


def eta_sigma(torch) -> dict:
    """What one card can measure of the paper's Fig. 3: one train chunk's
    T_DI (n 4 of 8192 tokens: [64, C, 768] bf16) copied to pinned host
    memory and back, alone and on a side stream under a running bf16
    GEMM of the expert shape ([64, C1, 768] x [64, 768, 3072], C1 the
    capacity of the whole 8192 tokens); the GEMM alone and under a
    running copy stream. host bytes/s = bytes of the two copies / their
    time alone; eta_comp = copy time alone / under the GEMM; sigma = GEMM
    time alone / under the copies. Also the host seconds of one eager
    launch (``add_`` on one element; the device keeps up). mu (comm under
    compute) needs a second rank and is not measured."""
    from repro_torch.core import capacity_for
    cfg = adaptive_config()
    m = cfg.moe
    c4 = capacity_for(LAYER_TOKENS // 4, m.top_k, m.capacity_factor,
                      m.num_experts)
    c1 = capacity_for(LAYER_TOKENS, m.top_k, m.capacity_factor,
                      m.num_experts)
    t_di = randn(torch, (m.num_experts, c4, cfg.d_model), 1, dtype="bfloat16")
    back = torch.empty_like(t_di)
    host = torch.empty(t_di.shape, dtype=t_di.dtype, pin_memory=True)
    a = randn(torch, (m.num_experts, c1, cfg.d_model), 2, dtype="bfloat16")
    w = randn(torch, (m.num_experts, cfg.d_model, m.d_expert), 3,
              dtype="bfloat16", scale=0.03)
    nbytes = t_di.numel() * t_di.element_size()
    main, side = torch.cuda.current_stream(), torch.cuda.Stream()

    def copy_pair():
        host.copy_(t_di, non_blocking=True)
        back.copy_(host, non_blocking=True)

    def gemm():
        torch.bmm(a, w)

    def window(stream, fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record(stream)
            for _ in range(reps):
                fn()
            end.record(stream)
        return start, end

    def ms(ev, reps):
        return ev[0].elapsed_time(ev[1]) / reps

    for _ in range(3):                                       # warm-up
        copy_pair()
        gemm()
    side.wait_stream(main)
    torch.cuda.synchronize()
    alone = window(side, copy_pair, 50)
    torch.cuda.synchronize()
    copy_alone = ms(alone, 50)
    alone = window(main, gemm, 200)
    torch.cuda.synchronize()
    gemm_alone = ms(alone, 200)
    # copies inside a GEMM window about 4x as long as theirs
    g_reps = max(200, int(4 * 50 * copy_alone / gemm_alone))
    long_gemm = window(main, gemm, g_reps)
    copy_under = window(side, copy_pair, 50)
    torch.cuda.synchronize()
    # GEMMs inside a copy window about 4x as long as theirs
    c_reps = max(50, int(4 * 200 * gemm_alone / copy_alone))
    long_copy = window(side, copy_pair, c_reps)
    gemm_under = window(main, gemm, 200)
    torch.cuda.synchronize()
    nested = [long_gemm[0].elapsed_time(copy_under[0]) >= 0
              and copy_under[1].elapsed_time(long_gemm[1]) >= 0,
              long_copy[0].elapsed_time(gemm_under[0]) >= 0
              and gemm_under[1].elapsed_time(long_copy[1]) >= 0]
    one = torch.zeros(1, device="cuda")
    for _ in range(100):
        one.add_(1.0)
    torch.cuda.synchronize()
    reps = 5000
    t0 = time.perf_counter()
    for _ in range(reps):
        one.add_(1.0)
    torch.cuda.synchronize()
    launch_s = (time.perf_counter() - t0) / reps
    row = dict(t_di_shape=list(t_di.shape), t_di_bytes=nbytes,
               gemm_shape=[list(a.shape), list(w.shape)],
               copy_pair_ms_alone=copy_alone,
               copy_pair_ms_under_gemm=ms(copy_under, 50),
               gemm_ms_alone=gemm_alone,
               gemm_ms_under_copy=ms(gemm_under, 200),
               windows_nested=nested,
               host_bytes_per_s=2 * nbytes / (copy_alone / 1e3),
               eta_comp=copy_alone / ms(copy_under, 50),
               sigma=gemm_alone / ms(gemm_under, 200),
               launch_overhead_s=launch_s,
               mu="not measured: needs a second rank")
    log("eta-sigma " + json.dumps(row))
    if not all(nested):
        raise AssertionError(f"eta/sigma windows did not nest: {row}")
    del t_di, back, host, a, w
    torch.cuda.empty_cache()
    return row


def pools_snapshot(torch, engine) -> tuple:
    """Every pool's non-sink pages (raw bits), the lengths and the page
    table of an engine."""
    from repro_torch.models.module import leaves
    from repro_torch.serve.paged_kv import SINK_PAGE
    pages = [bits(torch, t[SINK_PAGE + 1:]).clone()
             for t in leaves(engine.kv.pools)]
    return pages, engine.kv.lens.copy(), engine.kv.page_table.copy()


def adaptive_serve_phase(torch, build) -> collections.Counter:
    """``Engine`` on full-width moe-gpt3-s in bf16 with its defaults
    (adaptive, measure auto), 8 seeded requests: it must measure prefill
    candidates by wall clock on the card (in its warmup, whose
    launches are not counted); the decode kernel launches
    once per layer of each decode step, router and expert FFN once per
    MoE layer of each chunk at each bucket's resolved n (measurements
    apart); every request completes. Mid-run, a probe of
    ``_wallclock_measure`` on the live engine must leave every non-sink
    page, the lengths and the page table bit-equal. Returns the run's
    launches, measurements included."""
    from repro_torch.core import Strategy
    from repro_torch.serve import Engine, EngineOptions
    cfg = serve_config()
    engine = Engine(cfg, options=EngineOptions(device="cuda", **ENGINE),
                    seed=0)
    if not engine.opts.adaptive or engine.measure != "wallclock":
        raise AssertionError("the engine does not resolve buckets by wall "
                             "clock")
    inner, measured, cands = (engine.adaptive.resolver.measure_fn,
                              collections.Counter(), [])

    def measure(b, n, strategy):
        launched = collections.Counter(build.LAUNCHES)
        seconds = inner(b, n, strategy)
        measured.update(collections.Counter(build.LAUNCHES) - launched)
        cands.append(candidate_row(engine.cfg, b, n, strategy, seconds))
        return seconds

    engine.adaptive.resolver.measure_fn = measure
    probe = {}

    def on_step(i):
        if probe or engine.stats()["decode_steps"] < 4:
            return
        before = pools_snapshot(torch, engine)
        launched = collections.Counter(build.LAUNCHES)
        probe["ms"] = engine._wallclock_measure(ENGINE["chunk"], 2,
                                                Strategy.S4) * 1e3
        measured.update(collections.Counter(build.LAUNCHES) - launched)
        after = pools_snapshot(torch, engine)
        if not (all(torch.equal(x, y) for x, y in zip(before[0], after[0]))
                and (before[1] == after[1]).all()
                and (before[2] == after[2]).all()):
            raise AssertionError("the wall-clock probe wrote outside the "
                                 "sink page")
        probe.update(step=i, pages_checked=engine.kv.num_pages - 1)

    def reset():           # warmup measured every bucket already
        build.reset_launches()
        measured.clear()

    reqs = requests(cfg.vocab_size, 8, seed=7)
    engine, handles, host, chunks = serve(cfg, reqs, engine=engine,
                                          reset=reset, on_step=on_step)
    total = collections.Counter(build.LAUNCHES)
    if not probe:
        raise AssertionError("the probe never ran")
    check_serve_launches(engine.cfg, engine, total - measured, chunks,
                         "paged_decode_attention")
    check_replays(engine.cfg, engine, "paged_decode_attention")
    s = engine.stats()
    row = dict(arch=cfg.name, dtype=cfg.compute_dtype,
               requests=s["requests_done"], resolutions=s["resolutions"],
               search_calls=engine.adaptive.search_calls,
               candidates_measured=engine.adaptive.resolver
               .candidates_measured,
               retune_s=engine.adaptive.resolver.retune_s,
               prefill_steps=s["prefill_steps"],
               decode_steps=s["decode_steps"], chunks=chunks,
               prefill_tok_per_s=s["prefill_tok_per_s"],
               decode_tok_per_s=s["decode_tok_per_s"],
               p50_ttft_s=s["p50_ttft_s"], probe=probe,
               launches=dict(total - measured),
               measurement_launches=dict(measured), **host)
    log("adaptive-serve " + json.dumps(row))
    for c in cands:
        log("adaptive-serve-candidate " + json.dumps(c))
    del engine, handles
    torch.cuda.empty_cache()
    return total


def main() -> int:
    t_start = time.perf_counter()
    import gc

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
    log(f"phase 2 at {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    secs = build.build()
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.2f} s)")

    # -- 3. kernel vs plain -------------------------------------------------
    log(f"phase 3 at {time.perf_counter() - t_start:.1f} s")
    kernel_rows = [dict(check_paged_decode(torch, c),
                        kernel="paged_decode_attention", library_ms=None)
                   for c in kernel_cases(torch)]
    torch.cuda.empty_cache()
    kernel_rows += [check_mla(torch, c) for c in mla_cases(torch)]
    torch.cuda.empty_cache()
    kernel_rows += train_kernel_cases(torch)
    kernel_rows += route_plan_cases(torch)
    import gqa_phase
    kernel_rows += gqa_phase.kernel_cases(torch)
    torch.cuda.empty_cache()

    # -- 4. serve -----------------------------------------------------------
    log(f"phase 4 at {time.perf_counter() - t_start:.1f} s")
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
        adaptive=False, reset=build.reset_launches)
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
    check_replays(cfg, engine, "paged_decode_attention")
    engine_p50 = {"moe-gpt3-s": serve_row["p50_decode_step_ms"]}
    log("serve " + json.dumps(serve_row))
    log("serve-sample " + json.dumps(serve_sample(1, engine, host)))
    log("decode-profile " + json.dumps(profile_decode(torch, engine)))
    params = engine.params
    del engine, handles
    torch.cuda.empty_cache()
    # 2 pairs keep the whole script near half of its time limit
    capture_vs_eager(torch, build, cfg, reqs, 2, params,
                     "paged_decode_attention", "moe-gpt3-s",
                     preempt="recompute", num_pages=65, adaptive=False)
    offload_launches = offload_phase(torch, build, params)

    # -- 5. prefix cache, moe-gpt3-s ----------------------------------------
    log(f"phase 5 at {time.perf_counter() - t_start:.1f} s")
    prefix_launches = prefix_pairs(
        torch, build, cfg, params, chat_trace(cfg.vocab_size, 16, seed=11),
        "paged_decode_attention", "moe-gpt3-s", pairs=2)

    # -- 6. cancel ----------------------------------------------------------
    log(f"phase 6 at {time.perf_counter() - t_start:.1f} s")
    cancel_launches = cancel_phase(torch, build, params)

    # -- 7. telemetry, the Poisson replay and the ingress --------------------
    log(f"phase 7 at {time.perf_counter() - t_start:.1f} s")
    obs_launches = obs_phase(torch, build, params)
    gpt_params = params
    del params

    # -- 8. kernel vs gather ------------------------------------------------
    log(f"phase 8 at {time.perf_counter() - t_start:.1f} s")
    gather_vs_kernel(torch, "moe-gpt3-s")

    # -- 9. serve DeepSeek-V2-Lite ------------------------------------------
    log(f"phase 9 at {time.perf_counter() - t_start:.1f} s")
    deepseek_launches, params, engine_p50[DEEPSEEK] = deepseek_phase(
        torch, build, launcher)

    # -- 10. prefix cache, DeepSeek-V2-Lite ----------------------------------
    log(f"phase 10 at {time.perf_counter() - t_start:.1f} s")
    cfg = serve_config(arch=DEEPSEEK)
    prefix_launches += prefix_pairs(
        torch, build, cfg, params, chat_trace(cfg.vocab_size, 8, seed=12),
        "paged_mla_decode", "deepseek", pairs=1)

    # -- 11. the dense-cache path -------------------------------------------
    log(f"phase 11 at {time.perf_counter() - t_start:.1f} s")
    dense_launches = fixed_batch(torch, build, launcher, "moe-gpt3-s",
                                 gpt_params, engine_p50["moe-gpt3-s"])
    dense_launches += fixed_batch(torch, build, launcher, DEEPSEEK, params,
                                  engine_p50[DEEPSEEK])
    del params, gpt_params
    gc.collect()
    torch.cuda.empty_cache()
    dense_launches += oracle_full_depth(torch, build)

    # -- 12. kernel vs gather, DeepSeek-V2-Lite ----------------------------
    log(f"phase 12 at {time.perf_counter() - t_start:.1f} s")
    gather_vs_kernel(torch, DEEPSEEK)

    # -- 13. prefix on vs off, exact ----------------------------------------
    log(f"phase 13 at {time.perf_counter() - t_start:.1f} s")
    for arch, n in (("moe-gpt3-s", 16), (DEEPSEEK, 8)):
        prefix_exact(torch, build, arch, n)
    torch.cuda.empty_cache()

    # -- 14. train ----------------------------------------------------------
    log(f"phase 14 at {time.perf_counter() - t_start:.1f} s")
    train_rows, train_launches = train_phase(torch, build)

    # -- 15. train-memory ---------------------------------------------------
    log(f"phase 15 at {time.perf_counter() - t_start:.1f} s")
    memory_launches = train_memory_phase(torch, build)

    # -- 16. adaptive (n, strategy) ----------------------------------------
    log(f"phase 16 at {time.perf_counter() - t_start:.1f} s")
    adaptive_launches = adaptive_train_phase(torch, build)
    strategy_memory(torch)
    eta_sigma(torch)
    adaptive_launches += adaptive_serve_phase(torch, build)

    # -- 17. card vs CPU ----------------------------------------------------
    log(f"phase 17 at {time.perf_counter() - t_start:.1f} s")
    card_vs_cpu(torch)

    # -- 18. expert parallelism --------------------------------------------
    log(f"phase 18 at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    import ep_phase
    # the NCCL launcher run (ep_phase's "launcher") is left to the tool
    # alone, for this script's time limit
    ep_launches = ep_phase.ep_phase(tuple(p for p in ep_phase.PARTS
                                          if p != "launcher"))

    # -- 19. the serving engine over ranks -----------------------------------
    log(f"phase 19 at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    import serve_ranks_phase
    with torch.no_grad():
        ep_launches += serve_ranks_phase.serve_ranks()

    # -- 20. training over ranks, finished ----------------------------------
    log(f"phase 20 at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    import ep_state_phase
    ep_launches += ep_state_phase.ep_state_phase()

    # -- 21. the GQA + RoPE decoders -----------------------------------------
    log(f"phase 21 at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    gqa_launches = gqa_phase.gqa_phase(torch, build)

    # -- 22. kernels line ---------------------------------------------------
    log(f"phase 22 at {time.perf_counter() - t_start:.1f} s")
    main_launches = (serve_launches + offload_launches + prefix_launches
                     + cancel_launches + obs_launches + deepseek_launches
                     + dense_launches + train_launches + memory_launches
                     + adaptive_launches + ep_launches + gqa_launches)
    gqa_cases = {c[0] for c in gqa_phase.PAGED + gqa_phase.FLASH}

    def gqa_rows(kernel):
        return [{k: r[k] for k in D192_KEYS} for r in kernel_rows
                if r["kernel"] == kernel and r["case"] in gqa_cases]
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
        "torch.topk is two calls, topk promises no tie order, and the "
        "dispatch plan is a sort and more) and "
        "grouped_ffn (no single call runs a per-expert GEMM -> activation "
        "-> GEMM); flash_attention's is scaled_dot_product_attention "
        "(is_causal; with GQA and the window as a mask in its gqa rows), "
        "a yardstick the port never calls")
    print(json.dumps({"kernels": [
        entry("paged_decode_attention", "paged_attention/csrc/"
              "paged_decode.cu", "paged_attention/kernel.py:69",
              head("paged_decode_attention", "engine"),
              gqa=gqa_rows("paged_decode_attention")),
        entry("paged_mla_decode", "paged_attention/csrc/"
              "paged_mla_decode.cu", "paged_attention/kernel.py:142",
              head("paged_mla_decode", "engine")),
        entry("grouped_ffn", "grouped_ffn/csrc/grouped_ffn.cu",
              "grouped_ffn/kernel.py:61", head("grouped_ffn"),
              ep=[{k: r[k] for k in D192_KEYS} for r in kernel_rows
                  if r["kernel"] == "grouped_ffn"
                  and r["case"].startswith("ep_")]),
        entry("topk_router", "topk_router/csrc/topk_router.cu",
              "topk_router/kernel.py:42", head("topk_router", "plan_train",
                                               "float32"),
              entry="route_plan: probs, idx, dest and valid in one launch"),
        entry("flash_attention", "flash_attention/csrc/flash_attention.cu",
              "flash_attention/kernel.py:67", head("flash_attention"),
              d192=[{k: r[k] for k in D192_KEYS} for r in kernel_rows
                    if r["kernel"] == "flash_attention"
                    and r["case"].startswith("d192")],
              gqa=gqa_rows("flash_attention")),
    ]}), flush=True)

    # -- 23. result ---------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
