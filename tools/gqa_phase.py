#!/usr/bin/env python3
"""The GQA + RoPE decoders served on the card: ``chip_smoke.py``'s phase
21, and the same phase alone, from the root of a checkout:

    python3 tools/gqa_phase.py [ARCH,...] [--kernels]

ARCH: any of ``llama3-8b``, ``h2o-danube-1.8b``, ``gemma3-12b``,
``qwen1.5-110b`` (default: all four, in that order); ``--kernels`` first
runs the phase's kernel rows (``kernel_cases``: ``chip_smoke.py`` runs
them in its phase 3). Builds the kernels from the checkout, prints the
card's name and power limit first, and needs one CUDA card. Run alone,
the phase also profiles 10 decode steps a model (``chip_smoke.py``
leaves the profile out, for its time limit).

Each model at full width, weights drawn on the card from seed 0 (at the
depth of ``TARGETS``: qwen1.5-110b's 80 layers of bf16 weights take ~222
GB, so it serves 16):

1. ``gqa-serve``: ``Engine`` in bf16 with its defaults (the adaptive
   prefill resolver: a dense model resolves nothing), ``warmup()``
   (the decode step captured), then 8 requests of 16-20 new tokens: on
   the windowed models one crossing the window while it decodes
   (h2o-danube-1.8b: window 4096; gemma3-12b: its local layers' 1024)
   and, on gemma3-12b, one prompt past it. Checks: every request
   complete, one capture and a replay a decode step, the paged decode
   kernel launched once a layer of every decode step. Prints peak memory
   (``max_memory_allocated`` from before the engine's init), the init
   and warmup seconds, the captured decode step's median ms and, run
   alone, a profile of 10 full-batch decode steps (device ms and busy
   share, the paged kernel's ms, the top kernels).
   ``gqa-oracle``: each request's greedy tokens against
   ``dense_greedy_reference`` on the same bf16 weights (its prefill
   through the flash kernel, a launch a layer). The logits are bf16
   here, whose top two often lie a bf16 step apart or tie (at the first
   token too), and the engine's chunked prefill and 8-row decode round
   otherwise than the oracle's whole-prompt prefill and batch of one: a
   request may part from the oracle where its top two are that close.
   The oracle is then forced along the engine's tokens, and at every
   step the engine's token must lie below the oracle's best logit by at
   most ``TIE_REL`` of that logit's magnitude, a bound fixed here, not
   measured in the run; else the phase fails. Each parting is printed:
   request, step, the two tokens, the oracle's top-2 gap and best logit
   there, and the largest relative margin along the engine's path;
2. ``gqa-launcher``: ``python -m repro_torch.launch.serve --engine`` on
   the same weights (``main(params=)``; 4 requests, the default
   resolver, ``--num-layers`` at the cut depth), and the fixed-batch loop
   without ``--engine`` (a batch of 8 sequences of 64 prompt tokens);
3. ``gqa-exact``: the first ``EXACT_REQUESTS`` of those requests (the
   window's among them) through the captured engine in fp32, weights
   drawn in fp32, at full depth (qwen1.5-110b at 8 layers: 16 of fp32
   weights take 97 GB):
   every greedy token equal to ``dense_greedy_reference``'s, any
   difference a failure with the request, the step and the oracle's
   top-2 gap printed. fp32 logits do not tie, so here the tokens must be
   equal.

``gqa_phase`` returns the launches of its runs, which join the main
paths' counts in ``chip_smoke.py``'s kernels line.
"""
import collections
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# arch -> serve depth (0: the config's), fp32 depth (0: the config's),
# the prompts past and across the window (prompt, new tokens), the
# engine's max_seq_len
TARGETS = {
    "llama3-8b": dict(layers=0, exact_layers=0, long=(), max_seq_len=512),
    "h2o-danube-1.8b": dict(layers=0, exact_layers=0, long=((4090, 20),),
                            max_seq_len=4160),
    "gemma3-12b": dict(layers=0, exact_layers=0,
                       long=((1040, 20), (1016, 20)), max_seq_len=1088),
    "qwen1.5-110b": dict(layers=16, exact_layers=8, long=(),
                         max_seq_len=512),
}
REQUESTS, PROMPTS, NEW = 8, (16, 384), (16, 20)
EXACT_REQUESTS = 4                  # the fp32 check's, for the time limit
CHUNK = 256                         # prefill tokens a step
# bf16: an engine token's logit at most this share of |the oracle's best
# logit| below that best: 4 bf16 epsilons (2^-7 each). Two bf16 logits
# differ by up to one epsilon of their size from their own rounding; the
# rest is the bf16 residual stream rounded in another order (chunked
# prefill, 8-row products). On an H100 (PERF.md) the oracle's own
# incremental and whole-prompt evaluations of a step differed by up to
# 0.13 at best logits of 3.5-4.5, and the engine's tokens sat at most
# 0.0625 (1.6%) below the oracle's best.
TIE_REL = 4 * 2.0 ** -7
KERNEL = "paged_decode_attention"


def target_config(arch: str, layers: int, dtype: str = "bfloat16"):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers or cfg.num_layers,
                               compute_dtype=dtype)


def engine_options(t: dict):
    from repro_torch.serve import EngineOptions
    return EngineOptions(device="cuda", max_slots=8, page_size=16,
                         max_seq_len=t["max_seq_len"], chunk=CHUNK)


def gqa_requests(cfg, t: dict, seed: int = 0) -> list:
    """``REQUESTS`` (prompt, new tokens): the window's prompts of ``t``
    first, the rest drawn from ``seed`` within the engine's budget."""
    rng = np.random.default_rng(seed)
    hi = min(PROMPTS[1], t["max_seq_len"] - NEW[1])
    out = [(rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32), m)
           for n, m in t["long"]]
    while len(out) < REQUESTS:
        n = int(rng.integers(PROMPTS[0], hi + 1))
        out.append((rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32),
                    int(rng.integers(NEW[0], NEW[1] + 1))))
    return out


def _free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def run_engine(torch, build, cfg, t, reqs) -> tuple:
    """Build the engine (weights from seed 0), warm it up, serve ``reqs``
    through the captured decode step. Returns the engine, the requests,
    the serve run's launches and its numbers."""
    from repro_torch.models.module import leaves
    from repro_torch.serve import Engine
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, options=engine_options(t), seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    programs = engine.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    build.reset_launches()
    t0 = time.perf_counter()
    handles = [engine.submit(p, max_new_tokens=m) for p, m in reqs]
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = collections.Counter(build.LAUNCHES)
    s = engine.stats()
    for r, (p, m) in zip(handles, reqs):
        if len(r.output) != m:
            raise AssertionError(f"{cfg.name}: request {r.rid} gave "
                                 f"{len(r.output)} of {m} tokens")
    want = {KERNEL: cfg.num_layers}
    if (s["decode_captures"] != 1
            or s["decode_replays"] != s["decode_steps"]
            or dict(engine._decode.launches) != want
            or launches[KERNEL] != cfg.num_layers * s["decode_steps"]):
        raise AssertionError(
            f"{cfg.name}: captures {s['decode_captures']}, replays "
            f"{s['decode_replays']} for {s['decode_steps']} decode steps, "
            f"recorded {dict(engine._decode.launches)} != {want}, "
            f"{KERNEL} launched {launches[KERNEL]}")
    row = dict(arch=cfg.name, layers=cfg.num_layers,
               dtype=cfg.compute_dtype,
               params=sum(x.numel() for x in leaves(engine.params)),
               init_s=init_s, init_bytes=init_bytes, warmup_s=warmup_s,
               warmup_programs=programs,
               peak_bytes=torch.cuda.max_memory_allocated(),
               kv_pool_bytes=s["cache_bytes"], requests=len(reqs),
               prompt_lens=[len(p) for p, _ in reqs],
               window=cfg.attn.window, serve_wall_s=wall,
               p50_decode_step_ms=s["p50_decode_step_s"] * 1e3,
               decode_tok_per_s=s["decode_tok_per_s"],
               prefill_tok_per_s=s["prefill_tok_per_s"],
               decode_steps=s["decode_steps"],
               prefill_steps=s["prefill_steps"],
               launches=dict(launches))
    return engine, handles, launches, row


def forced_logits(torch, params, cfg, prompt, tokens) -> list:
    """The oracle's computation forced along ``tokens`` (the engine's):
    its logits before each of them."""
    from repro_torch.models import lm
    dev = params["embed"]["tok"].device
    toks = torch.as_tensor(np.asarray(prompt, np.int64)[None], device=dev)
    logits, cache = lm.prefill(params, toks, cfg,
                               max_len=len(prompt) + len(tokens),
                               dtype=torch.float32)
    out = [logits[0, -1].float()]
    for tok in tokens[:-1]:
        logits, cache = lm.decode_step(
            params, cache, torch.tensor([[int(tok)]], device=dev), cfg)
        out.append(logits[0].float())
    return out


def parting(torch, params, cfg, i, prompt, want, got) -> dict:
    """Where request ``i``'s tokens part from the oracle's: the step, the
    two tokens, the oracle's top-2 gap and its gap between the two (its
    computation forced along the engine's tokens is its own up to the
    parting) and its best logit there. Then, along the engine's tokens,
    the largest margin of an engine token below the oracle's best,
    relative to that best's magnitude: a near-tie when it is at most
    ``TIE_REL``."""
    step = next(j for j, (a, b) in enumerate(zip(want, got)) if a != b)
    forced = forced_logits(torch, params, cfg, prompt, got)
    inc = forced[step]
    top = torch.topk(inc, 2).values
    margins = [(float(lg.max() - lg[t]), float(lg.max().abs()))
               for lg, t in zip(forced, got)]
    worst = max(range(len(margins)),
                key=lambda j: margins[j][0] / margins[j][1])
    margin, best = margins[worst]
    return dict(request=i, step=step, oracle_token=int(want[step]),
                engine_token=int(got[step]),
                top2_gap=float(top[0] - top[1]),
                gap=float(inc[want[step]] - inc[got[step]]),
                best_logit=float(top[0]), forced_max_margin=margin,
                forced_best_logit=best, forced_max_rel=margin / best,
                forced_worst_step=worst,
                near_tie=margin <= TIE_REL * best)


def against_oracle(torch, build, engine, handles, reqs, *, exact: bool
                   ) -> tuple:
    """Each request's greedy tokens against ``dense_greedy_reference``
    on the engine's weights: with ``exact``, every token equal; else a
    request may part at a near-tie (``parting``). Returns (the oracle's
    launches, the row)."""
    from repro_torch.serve import dense_greedy_reference
    cfg, params = engine.cfg, engine.params
    build.reset_launches()
    t0 = time.perf_counter()
    wants = [dense_greedy_reference(params, cfg, p, m) for p, m in reqs]
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    launches = collections.Counter(build.LAUNCHES)
    if launches["flash_attention"] != cfg.num_layers * len(reqs):
        raise AssertionError(f"{cfg.name}: the oracle's prefills launched "
                             f"flash_attention {launches['flash_attention']}"
                             f" times, not {cfg.num_layers} a request")
    gots = [list(r.output) for r in handles]
    parted = [i for i, (g, w) in enumerate(zip(gots, wants)) if g != w]
    if exact and parted:
        i = parted[0]
        raise AssertionError(
            f"{cfg.name} {cfg.compute_dtype}: greedy tokens part from "
            f"dense_greedy_reference: " + json.dumps(parting(
                torch, params, cfg, i, reqs[i][0], wants[i], gots[i])))
    partings = [parting(torch, params, cfg, i, reqs[i][0], wants[i],
                        gots[i]) for i in parted]
    cross = [i for i, (p, m) in enumerate(reqs)
             if cfg.attn.window and len(p) + m > cfg.attn.window]
    row = dict(arch=cfg.name, layers=cfg.num_layers,
               dtype=cfg.compute_dtype, requests=len(reqs),
               equal=len(reqs) - len(parted), partings=partings,
               crossing_window=cross,
               crossing_equal=[i for i in cross if i not in parted],
               tokens=sum(m for _, m in reqs), oracle_s=oracle_s)
    if cfg.attn.window and not cross:
        raise AssertionError(f"{cfg.name}: no request crosses the window")
    bad = [p for p in partings if not p["near_tie"]]
    if bad:
        raise AssertionError(
            f"{cfg.name} {cfg.compute_dtype}: greedy tokens part from "
            f"dense_greedy_reference past a near-tie: {json.dumps(bad)}")
    return launches, row


def profile_decode(torch, engine, steps: int = 10) -> dict:
    """``steps`` decode steps of a full batch (8 fresh requests of 64
    prompt tokens, prefilled first) under ``torch.profiler``: wall and
    device ms a step, the device's busy share, the paged decode kernel's
    ms a step and the kernels that take the most device time."""
    from repro_torch.serve import RequestState
    rng = np.random.default_rng(3)
    batch = [engine.submit(rng.integers(0, engine.cfg.vocab_size, size=64,
                                        dtype=np.int32), max_new_tokens=32)
             for _ in range(engine.kv.max_slots)]
    while any(r.state != RequestState.DECODE for r in batch):
        engine.step()

    def run():
        for _ in range(steps):
            if engine.step()["kind"] != "decode":
                raise AssertionError("profiled step was not a decode")

    wall, kernels, launches = cs.traced(torch, run)
    engine.run_until_idle()
    device = sum(e.self_device_time_total for e in kernels) / 1e3
    attn = sum(e.self_device_time_total for e in kernels
               if "paged_" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(steps=steps, wall_ms_per_step=wall * 1e3 / steps,
                device_ms_per_step=device / steps,
                device_busy_share=device / (wall * 1e3),
                paged_attention_ms_per_step=attn / steps,
                kernels_per_step=sum(e.count for e in kernels) / steps,
                host_launches_per_step=launches / steps,
                top=[dict(name=e.key[:60],
                          ms_per_step=e.self_device_time_total / 1e3 / steps,
                          calls_per_step=e.count / steps) for e in top])


def launcher_runs(build, arch: str, cfg, params) -> collections.Counter:
    """The serve launcher's engine (4 requests) and its fixed-batch loop
    on ``params``, at ``cfg``'s depth."""
    from repro_torch.launch import serve as launcher
    depth = ["--arch", arch, "--num-layers", str(cfg.num_layers),
             "--seed", "1"]
    build.reset_launches()
    t0 = time.perf_counter()
    stats = launcher.main(["--engine", *depth, "--requests", "4",
                           "--prompt-len", "16:128", "--gen", "16:32"],
                          params=params)
    engine_s = time.perf_counter() - t0
    if stats["requests_done"] != 4 or stats["decode_captures"] != 1:
        raise AssertionError(f"{arch} launcher: {stats['requests_done']} "
                             f"requests, {stats['decode_captures']} captures")
    t0 = time.perf_counter()
    fixed = launcher.main([*depth, "--batch", "8", "--prompt-len", "64",
                           "--gen", "16", "--requests", "1"], params=params)
    fixed_s = time.perf_counter() - t0
    launches = collections.Counter(build.LAUNCHES)
    if launches["flash_attention"] != cfg.num_layers:
        raise AssertionError(f"{arch} fixed-batch: flash_attention "
                             f"launched {launches['flash_attention']} times, "
                             f"not {cfg.num_layers} a batch")
    cs.log("gqa-launcher " + json.dumps(dict(
        arch=arch, layers=cfg.num_layers, engine_s=engine_s,
        engine_p50_decode_step_ms=stats["p50_decode_step_s"] * 1e3,
        engine_requests=stats["requests_done"],
        resolutions=stats["resolutions"], fixed_s=fixed_s,
        fixed_tok_per_s=fixed["tok_per_s"],
        fixed_p50_decode_step_ms=fixed["p50_decode_step_ms"],
        launches=dict(launches))))
    return launches


def gqa_model(torch, build, arch: str, profile: bool
              ) -> collections.Counter:
    t = TARGETS[arch]
    cfg = target_config(arch, t["layers"])
    reqs = gqa_requests(cfg, t)
    engine, handles, launches, row = run_engine(torch, build, cfg, t, reqs)
    if profile:
        row["decode_profile"] = profile_decode(torch, engine)
    cs.log("gqa-serve " + json.dumps(row))
    oracle_launches, orow = against_oracle(torch, build, engine, handles,
                                           reqs, exact=False)
    cs.log("gqa-oracle " + json.dumps(orow))
    launches += oracle_launches
    params = engine.params
    del engine, handles
    launches += launcher_runs(build, arch, cfg, params)
    del params
    _free(torch)
    cfg32 = target_config(arch, t["exact_layers"], "float32")
    reqs = reqs[:EXACT_REQUESTS]
    engine, handles, exact_launches, row = run_engine(torch, build, cfg32, t,
                                                      reqs)
    oracle_launches, orow = against_oracle(torch, build, engine, handles,
                                           reqs, exact=True)
    cs.log("gqa-exact " + json.dumps(dict(
        orow, p50_decode_step_ms=row["p50_decode_step_ms"],
        peak_bytes=row["peak_bytes"])))
    del engine, handles
    _free(torch)
    return launches + exact_launches + oracle_launches


def gqa_phase(torch, build, archs=tuple(TARGETS), profile: bool = False
              ) -> collections.Counter:
    """Phase 21 over ``archs`` (with ``profile``, each model's 10-step
    decode profile too); the launches of its runs."""
    launches = collections.Counter()
    for arch in archs:
        t0 = time.perf_counter()
        with torch.no_grad():
            mine = gqa_model(torch, build, arch, profile)
        cs.log(f"gqa-model {arch} {time.perf_counter() - t0:.1f} s "
               f"launches {json.dumps(dict(mine))}")
        launches += mine
    return launches


# ---------------------------------------------------------------------------
# phase 3's rows: the kernels at these models' shapes
# ---------------------------------------------------------------------------

# the engines' decode batches: 8 slots of 16-token pages
PAGED = (  # name, Kv, G, D, pages a slot, lens, window
    ("danube_decode", 8, 4, 80, 260,
     [4101, 4114, 300, 37, 1, 2000, 4160, 250], 4096),
    ("gemma_local_decode", 8, 2, 256, 68,
     [1041, 1040, 500, 17, 1, 1088, 700, 64], 1024),
    ("gemma_global_decode", 8, 2, 256, 68,
     [1041, 1040, 500, 17, 1, 1088, 700, 64], 0),
)
# the dense prefills of the oracle: the windowed models' longest prompts
FLASH = (  # name, S, Hq, Kv, D, window
    ("danube_prefill", 4100, 32, 8, 80, 4096),
    ("danube_prefill_causal", 4100, 32, 8, 80, 0),
    ("gemma_local_prefill", 1040, 16, 8, 256, 1024),
    ("gemma_global_prefill", 1040, 16, 8, 256, 0),
)


def flash_row(torch, case, s, hq, kv, d, window, dtype, seed) -> dict:
    """The flash kernel against its plain version at one prefill; the
    library yardstick is ``scaled_dot_product_attention`` with GQA and,
    under a window, the causal window as a boolean mask (the port never
    calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ref import tolerance
    q = cs.randn(torch, (1, s, hq, d), seed, dtype=dtype)
    k = cs.randn(torch, (1, s, kv, d), seed + 1, dtype=dtype)
    v = cs.randn(torch, (1, s, kv, d), seed + 2, dtype=dtype)
    out = flash_attention(q, k, v, causal=True, window=window)
    ref = flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    if window:
        pos = torch.arange(s, device="cuda")
        mask = (pos[:, None] >= pos[None, :]) & \
            (pos[:, None] - pos[None, :] < window)

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask,
                                                  enable_gqa=True)
    else:
        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    item = q.element_size()
    return cs.kernel_row(
        "flash_attention", case, dtype, (out.float() - ref.float()).abs(),
        tolerance(q, k, v, ref, causal=True, window=window), out,
        lambda: flash_attention(q, k, v, causal=True, window=window),
        lambda: flash_attention_ref(q, k, v, causal=True, window=window),
        cs.roof((2 * s * hq * d + 2 * s * kv * d) * item,
                4 * hq * d * cs.attended_pairs(s, s, True, window), dtype),
        library_fn=lib, iters=10,
        shape=dict(B=1, S=s, Hq=hq, Kv=kv, D=d, window=window),
        max_abs_ref=ref.float().abs().max().item())


def kernel_cases(torch) -> list:
    """Phase 3's rows of the two attention kernels at these models'
    shapes, bf16 and fp32: paged decode at D 80 (G 4, window 4096) and D
    256 (G 2, window 1024 and none) over 8 slots of the engine's lengths,
    flash attention at D 80 and D 256, causal and windowed, over the
    windowed models' longest prompts."""
    rows = []
    for dtype in ("bfloat16", "float32"):
        for name, kv, g, d, np_, lens, window in PAGED:
            case = cs.paged_case(torch, name, dtype=dtype, b=len(lens),
                                 kv=kv, g=g, d=d, ps=16, np_=np_, lens=lens,
                                 extra=[0] * len(lens), window=window,
                                 seed=100 + len(rows))
            rows.append(dict(cs.check_paged_decode(torch, case),
                             kernel=KERNEL, library_ms=None))
            del case
        for name, s, hq, kv, d, window in FLASH:
            rows.append(flash_row(torch, name, s, hq, kv, d, window, dtype,
                                  seed=100 + 10 * len(rows)))
            torch.cuda.empty_cache()
    return rows


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("gqa_phase: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    kernels = "--kernels" in argv
    argv = [a for a in argv if a != "--kernels"]
    archs = argv[0].split(",") if argv else list(TARGETS)
    if any(a not in TARGETS for a in archs):
        print(f"gqa_phase: archs are {','.join(TARGETS)}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())
    t0 = time.perf_counter()
    cs.log(f"build {build.build()} ({time.perf_counter() - t0:.1f} s)")
    if kernels:
        kernel_cases(torch)
    launches = gqa_phase(torch, build, archs, profile=True)
    cs.log(f"gqa-launches {json.dumps(dict(launches))}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
