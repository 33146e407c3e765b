"""Serving launcher of the port. Two paths share one CLI, as in the JAX
launcher:

* default: the fixed-batch loop (``legacy_loop``) over a dense
  ``[batch, max_len]`` cache, the golden reference the engine is held
  to: ``--requests`` batches of ``--batch`` prompts of ``--prompt-len``
  tokens, each sequence with a budget of ``--gen // 2`` to ``--gen``
  new tokens (numpy's Philox(123), as the JAX loop draws them) and an
  EOS early exit (``--eos``), stopping masked on the host so finished
  sequences re-feed their last token. Prefill ``(n, strategy)`` is
  resolved for ``batch * prompt_len`` tokens (``MPipeMoE prefill:``
  line); decode runs n = 1. A ``request-batch`` line a batch gives its
  tokens and tok/s. The JAX loop draws its prompts with threefry
  ``PRNGKey(req)``, which torch cannot reproduce: the port draws them
  from numpy's generator seeded with ``--seed``. Flags of the engine
  alone (``--metrics-port``, ``--trace-out``, ``--prefix-cache``,
  ``--http-port``, ``--rate``) are an error here, as in the JAX
  launcher.

      PYTHONPATH=src python -m repro_torch.launch.serve \\
          --arch moe-gpt3-s --batch 4 --prompt-len 16 --gen 32

* ``--engine``: the continuous-batching engine on seeded synthetic
  prompts —

      PYTHONPATH=src python -m repro_torch.launch.serve --engine \\
          --arch moe-gpt3-s --requests 16

Builds the engine and calls its ``warmup()`` (the decode step captured
on the card, every reachable prefill bucket resolved and built), as the
JAX launcher does, printing the programs it built; then submits
``--requests`` prompts of ``--prompt-len`` (a fixed length or a
``lo:hi`` range) seeded tokens, each asking ``--gen`` (or ``lo:hi``) new
tokens, runs the engine until idle, prints the preemptions (when there
were any), each prefill bucket's resolved ``(n, strategy)`` as the JAX
launcher does and then ``stats()`` as one JSON line. ``--preempt``
(default ``auto``) and ``--num-pages`` (default 0: the worst case) set
the overload policy and the KV pool, and ``--prefix-cache on`` the
cross-request prefix cache (then a ``prefix cache:`` line: hits, misses,
prompt tokens skipped, copy-on-write copies, evicted pages), as in the
JAX launcher; a ``served`` line counts the requests done and cancelled
by stage. The other engine options are ``EngineOptions``' defaults.
Prefill ``(n, strategy)`` is resolved per bucket (``--hw``,
``--measure``; the JAX launcher's flags) unless ``--num-partitions N``
fixes n (``--batch`` sets its decode slots). Both paths run on the
card; ``--device cpu`` runs them on the CPU.

Three ways to feed the engine, as the JAX launcher has them:

* the seeded batch above (the default);
* ``--rate R [--time-scale S]``: a Poisson replay through
  ``serve.trace.run_poisson`` of ``--requests`` requests at ``R`` req/s,
  prompts of 4 up to the ``hi`` of ``--prompt-len`` tokens and 2 up to
  the ``hi`` of ``--gen`` new tokens (the JAX ``engine_loop``'s draw),
  then the JAX launcher's req/s, tok/s, latency, TTFT and ITL lines;
* ``--http-port P``: the HTTP/SSE ingress (``serve.ingress``) until ^C,
  shedding past ``--admission-queue`` by ``--shed-policy``.

Over ranks: ``--devices N`` serves the engine over the ``N`` ranks of
``torch.distributed.run`` (``(dp, ep) = ep_split(N, experts)``; NCCL
across cards, gloo when the ranks share a card or run on the CPU), and
``--kv-sharding dp`` shards the KV pools over the ranks' data axis; rank
0 prints, with a ``mesh:`` line as the JAX launcher's. The decode step
then runs eagerly (the captured step over ranks is ROADMAP.md's Queue 1
item 3d, and so is the HTTP ingress over ranks: ``--http-port`` with
``--devices`` > 1 is an error). The JAX launcher's flag rules:
``--devices`` > 1 needs ``--engine``, ``--kv-sharding dp`` needs
``--devices`` > 1:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.serve --engine --devices 2 --kv-sharding dp

In every mode ``--metrics-port`` serves live Prometheus ``/metrics``
(started after ``warmup()``, so the capture is done before the exporter
thread runs), ``--trace-out`` records spans and writes a
Perfetto-loadable trace at the end, and ``--temperature`` / ``--top-k``
/ ``--top-p`` / ``--sample-seed`` / ``--eos`` set every request's
sampling and stop.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import HW_SPECS, resolve_hw


def _range(text: str) -> Tuple[int, int]:
    lo, _, hi = text.partition(":")
    return int(lo), int(hi or lo)


def configure(args) -> ArchConfig:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.num_layers:
        if args.num_layers % cfg.period:
            raise SystemExit(f"--num-layers {args.num_layers}: {cfg.name}'s "
                             f"layers come in periods of {cfg.period}")
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    if cfg.moe is None or args.num_partitions is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_partitions=args.num_partitions))


def synthetic_requests(n: int, vocab: int, prompt_len: Tuple[int, int],
                       gen: Tuple[int, int], seed: int
                       ) -> List[Tuple[np.ndarray, int]]:
    """``n`` (prompt, max_new_tokens) pairs drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        prompt = rng.integers(0, vocab, size=length, dtype=np.int32)
        out.append((prompt, int(rng.integers(gen[0], gen[1] + 1))))
    return out


def legacy_loop(args, cfg: ArchConfig, hw, params=None) -> Dict:
    """Fixed-batch request loop over a dense ``[batch, max_len]`` cache
    (fp32, as the JAX loop's). Returns the run's numbers: tokens, wall
    seconds and tok/s over all batches, the decode steps and the p50 of
    their wall ms (the step and the host read of its tokens), and the
    resolved ``(n, strategy)``. ``params`` (compute dtype) are served in
    place of weights drawn from ``--seed``."""
    import time

    import torch

    from repro_torch.core.selector import resolve
    from repro_torch.device import resolve_device
    from repro_torch.models import lm

    batch, plen, gen = args.batch or 4, int(args.prompt_len), int(args.gen)
    if cfg.moe is not None:
        # concrete (n, strategy) for the prefill token count; decode
        # itself always runs n = 1 (pipeline_moe._resolve_partitions)
        cfg = resolve(cfg, local_tokens=batch * plen, ep_size=1, hw=hw)
        print(f"MPipeMoE prefill: n={cfg.moe.num_partitions} "
              f"strategy={cfg.moe.memory_reuse_strategy}", flush=True)
    dev = resolve_device(args.device)
    if params is None:
        params = lm.init_compute(cfg, args.seed, device=dev)
    max_len = plen + gen
    prompts = np.random.default_rng(args.seed)
    budgets = np.random.Generator(np.random.Philox(key=123))
    tokens = 0
    wall = 0.0
    step_ms: List[float] = []
    with torch.no_grad():
        for req in range(args.requests):
            toks = torch.from_numpy(prompts.integers(
                0, cfg.vocab_size, size=(batch, plen))).to(dev)
            # per-sequence generation budget (<= --gen); EOS stops earlier
            max_new = budgets.integers(max(1, gen // 2), gen + 1,
                                       size=batch)
            t0 = time.perf_counter()
            logits, cache = lm.prefill(params, toks, cfg, max_len=max_len,
                                       dtype=torch.float32)
            tok = logits[:, -1:].argmax(-1)
            last = tok[:, 0].cpu().numpy()
            done = np.zeros(batch, bool)
            n_gen = np.ones(batch, np.int64)
            if args.eos >= 0:
                done |= last == args.eos
            done |= n_gen >= max_new
            steps = 1
            while not done.all() and steps < gen:
                ts = time.perf_counter()
                logits, cache = lm.decode_step(params, cache, tok, cfg)
                # masked stop: finished sequences keep re-feeding their
                # last token, so the step's shapes never change
                keep = torch.from_numpy(done).to(dev)[:, None]
                tok = torch.where(keep, tok, logits.argmax(-1)[:, None])
                last = tok[:, 0].cpu().numpy()
                step_ms.append((time.perf_counter() - ts) * 1e3)
                n_gen += ~done
                if args.eos >= 0:
                    done |= last == args.eos
                done |= n_gen >= max_new
                steps += 1
            dt = time.perf_counter() - t0
            total = int(n_gen.sum())
            tokens += total
            wall += dt
            print(f"request-batch {req}: {batch} seqs x ({plen} prompt + "
                  f"<= {gen} gen) {total} tokens in {dt * 1e3:.0f}ms -> "
                  f"{total / dt:.1f} tok/s (stopped early: "
                  f"{int(done.sum())})", flush=True)
    return {"arch": cfg.name, "batch": batch, "requests": args.requests,
            "tokens_generated": tokens, "wall_s": wall,
            "tok_per_s": tokens / wall if wall else 0.0,
            "decode_steps": len(step_ms),
            "p50_decode_step_ms": (float(np.median(step_ms)) if step_ms
                                   else 0.0),
            "num_partitions": (cfg.moe.num_partitions if cfg.moe else None),
            "strategy": (cfg.moe.memory_reuse_strategy if cfg.moe
                         else None)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--engine", action="store_true",
                    help="the continuous-batching engine (default: the "
                         "fixed-batch loop over a dense cache)")
    ap.add_argument("--batch", type=int, default=None,
                    help="fixed-batch loop: sequences a batch (default 4); "
                         "engine: decode slots (default: EngineOptions')")
    ap.add_argument("--arch", default="moe-gpt3-s")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's tiny same-family reduction")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the depth to N layers, a multiple of the "
                         "layer period (0 = the config's; qwen1.5-110b's "
                         "80 layers of bf16 weights do not fit one card)")
    ap.add_argument("--num-partitions", type=int, default=None,
                    help="MoE pipeline chunks n for prefill, fixed "
                         "(default: resolved per prefill bucket)")
    ap.add_argument("--hw", default="auto",
                    choices=["auto"] + sorted(HW_SPECS),
                    help="hardware spec for the MPipeMoE resolver "
                         "(auto = gpu-h100 with CUDA, else cpu-host)")
    ap.add_argument("--measure", default="auto",
                    choices=["auto", "wallclock", "simulate"],
                    help="bucket (n, strategy) resolution measure "
                         "(auto = wallclock on CUDA)")
    ap.add_argument("--preempt", default="auto",
                    choices=["auto", "recompute", "offload", "never"],
                    help="overload policy: on-demand pages with "
                         "preemption (auto picks offload or recompute per "
                         "victim by cost), or 'never' for full-budget "
                         "admission")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="KV pool size in pages (0 = worst case; smaller "
                         "values exercise preemption)")
    ap.add_argument("--prefix-cache", default="off", choices=["on", "off"],
                    help="cross-request prefix cache: 'on' publishes the "
                         "full KV pages of finished prefixes in a "
                         "refcounted trie, so later requests that share "
                         "a prompt prefix skip its prefill (copy-on-write "
                         "where they part, LRU eviction under pressure)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", default=None,
                    help="prompt length: engine N or LO:HI (default "
                         "16:64); fixed-batch loop N (default 16)")
    ap.add_argument("--gen", default=None,
                    help="new tokens per request: engine N or LO:HI "
                         "(default 16:32); fixed-batch loop the largest "
                         "budget N (default 32)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the prompts")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--rate", type=float, default=None,
                    help="replay a Poisson trace of --requests requests "
                         "at this arrival rate (req/s) instead of the "
                         "seeded batch")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="with --rate: arrival time multiplier (0 = all "
                         "at once)")
    ap.add_argument("--eos", type=int, default=-1,
                    help="EOS token id for early exit (-1 = disabled)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k filter (0 = disabled)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus (top-p) filter (1 = disabled)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="per-request sampling seed")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="serve live Prometheus /metrics (and /healthz) "
                         "on this port for the duration of the run (0 = "
                         "pick a free port, printed at startup; -1 = "
                         "disabled)")
    ap.add_argument("--trace-out", default="",
                    help="record spans and write a Perfetto-loadable "
                         "Chrome trace-event JSON here at shutdown ('' = "
                         "tracing off)")
    ap.add_argument("--http-port", type=int, default=-1,
                    help="serve the HTTP/SSE ingress on this port instead "
                         "of a batch or a replay: POST /generate streams "
                         "one SSE event per generated token, client "
                         "disconnects cancel their request (0 = pick a "
                         "free port, printed at startup; -1 = disabled)")
    ap.add_argument("--devices", type=int, default=0,
                    help="engine: serve over the N ranks of "
                         "torch.distributed.run, a dp x ep mesh (0 = one "
                         "device)")
    ap.add_argument("--kv-sharding", default="replicated",
                    choices=["replicated", "dp"],
                    help="engine: the KV pools over the ranks: "
                         "'replicated' (every rank holds the whole pool) "
                         "or 'dp' (pages sharded over the data axis: "
                         "per-rank KV drops dp-fold, per-shard free lists, "
                         "sticky least-loaded placement); 'dp' needs "
                         "--devices > 1")
    ap.add_argument("--shed-policy", default="reject",
                    choices=["reject", "degrade"],
                    help="ingress: behaviour past --admission-queue: "
                         "'reject' answers 429 with Retry-After, "
                         "'degrade' admits with max_new_tokens clamped")
    ap.add_argument("--admission-queue", type=int, default=8,
                    help="ingress: bound on requests accepted but not "
                         "yet finished before load shedding starts")
    return ap


def _print_stats(s: Dict, engine) -> None:
    print(f"served {s['requests_done']} requests "
          f"({s['requests_cancelled']} cancelled: "
          f"{s['cancelled_by_stage']}), "
          f"{s['tokens_generated']} tokens in {s['engine_steps']} steps")
    if s["preempt_recompute"] or s["preempt_offload"]:
        print(f"preemptions: {s['preempt_recompute']} recompute, "
              f"{s['preempt_offload']} offload, {s['resumes']} resumes, "
              f"swap {s['swap_out_bytes'] / 2**20:.2f}MiB out / "
              f"{s['swap_in_bytes'] / 2**20:.2f}MiB in")
    if s["prefix_cache"] == "on":
        print(f"prefix cache: {s['prefix_hits']} hits / "
              f"{s['prefix_misses']} misses "
              f"({100 * s['prefix_hit_rate']:.0f}%), "
              f"{s['prefix_hit_tokens']} prompt tokens skipped, "
              f"{s['prefix_cow_copies']} CoW copies, "
              f"{s['prefix_evicted_pages']} pages evicted")
    for bucket, (n, strat) in sorted(engine.adaptive.resolutions.items()):
        print(f"  bucket {bucket:4d} -> n={n} strategy={strat}")


def _print_replay(s: Dict, dt: float) -> None:
    """The JAX launcher's replay summary lines."""
    print(f"engine: {s['requests_done']} requests, "
          f"{s['tokens_generated']} tokens in {dt:.2f}s "
          f"({s['requests_done'] / dt:.2f} req/s, "
          f"{s['tokens_generated'] / dt:.1f} tok/s)")
    print(f"latency p50={s['p50_latency_s'] * 1e3:.0f}ms "
          f"p99={s['p99_latency_s'] * 1e3:.0f}ms | "
          f"TTFT p50={s['p50_ttft_s'] * 1e3:.0f}ms | "
          f"ITL p50={s['p50_itl_s'] * 1e3:.1f}ms "
          f"p99={s['p99_itl_s'] * 1e3:.1f}ms")
    print(f"KV pool {s['cache_bytes'] / 2**20:.2f}MiB, "
          f"peak used {s['peak_kv_used_bytes'] / 2**20:.2f}MiB | "
          f"{s['engine_steps']} steps, "
          f"{s['prefill_builds']} prefill builds")


def _ingress(engine, args, stop: Optional[threading.Event],
             on_ingress: Optional[Callable]) -> None:
    """Serve HTTP/SSE clients until ^C (or ``stop`` is set)."""
    import time

    from repro_torch.serve import IngressOptions, IngressServer
    ingress = IngressServer(engine, options=IngressOptions(
        port=args.http_port, shed_policy=args.shed_policy,
        admission_queue=args.admission_queue)).start()
    print(f"ingress: {ingress.url} - POST /generate streams SSE "
          f"(shed={args.shed_policy}, "
          f"admission_queue={args.admission_queue}); ^C to stop",
          flush=True)
    try:
        if on_ingress is not None:
            on_ingress(ingress)
        while stop is None or not stop.is_set():
            time.sleep(0.1)
    except KeyboardInterrupt:
        print("draining...")
    finally:
        ingress.stop()


def main(argv: Optional[Sequence[str]] = None, *,
         stop: Optional[threading.Event] = None,
         on_ingress: Optional[Callable] = None, params=None) -> Dict:
    """Runs the launcher; returns ``stats()`` (with ``arch``, and
    ``wall_s`` for a replay), or the fixed-batch loop's numbers. With
    ``--http-port``, ``stop`` (an event) ends the serving loop as ^C
    does, and ``on_ingress(server)`` runs once it listens. ``params``
    (the config's weights in its compute dtype) are served in place of
    weights drawn from ``--seed``."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.devices > 1:
        if not args.engine:
            ap.error("--devices requires --engine (the fixed-batch loop "
                     "runs on one device)")
        if args.http_port >= 0:
            ap.error("--http-port serves one device: the ingress over ranks "
                     "is ROADMAP.md's Queue 1 item 3d")
    elif args.kv_sharding == "dp":
        ap.error("--kv-sharding dp shards the KV pools over the ranks' data "
                 "axis; it requires --devices > 1")
    if not args.engine:
        # the JAX launcher's rules: the engine's flags need --engine
        for flag, given in (
                ("--metrics-port / --trace-out",
                 args.metrics_port >= 0 or args.trace_out),
                ("--prefix-cache", args.prefix_cache != "off"),
                ("--http-port", args.http_port >= 0),
                ("--rate", args.rate is not None)):
            if given:
                ap.error(f"{flag}: a flag of the continuous-batching "
                         f"engine; add --engine")
        args.prompt_len = args.prompt_len or "16"
        args.gen = args.gen or "32"
        for flag, text in (("--prompt-len", args.prompt_len),
                           ("--gen", args.gen)):
            if ":" in text:
                ap.error(f"the fixed-batch loop takes one {flag} N, "
                         f"got {text}")
    args.prompt_len = args.prompt_len or "16:64"
    args.gen = args.gen or "16:32"
    if args.http_port < 0 and (args.shed_policy != "reject"
                               or args.admission_queue != 8):
        ap.error("--shed-policy / --admission-queue configure the HTTP "
                 "ingress; add --http-port")
    if args.http_port >= 0 and args.rate is not None:
        ap.error("--http-port serves live clients; --rate replays a "
                 "trace: pick one")
    cfg = configure(args)
    if args.devices <= 1:
        return _main(args, cfg, stop, on_ingress, params)
    import torch

    from repro_torch.distributed import ep_split, init_distributed
    ctx = init_distributed(*ep_split(args.devices, cfg.moe.num_experts
                                     if cfg.moe else 0), device=args.device)
    args.device = str(ctx.device)
    try:
        # every rank serves; rank 0 prints
        with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(
                sys.stdout if ctx.rank == 0 else quiet):
            return _main(args, cfg, stop, on_ingress, params)
    finally:
        torch.distributed.destroy_process_group()


def _main(args, cfg: ArchConfig, stop, on_ingress, params) -> Dict:
    from repro_torch.obs import MetricsServer, Recorder, Tracer
    from repro_torch.serve import (Engine, EngineOptions, SamplingParams,
                                   run_poisson)

    hw = resolve_hw(args.hw)
    print(f"hw spec: {hw.name}", flush=True)
    if not args.engine:
        s = legacy_loop(args, cfg, hw, params)
        print(json.dumps(s, sort_keys=True))
        return s
    obs = Recorder(tracer=Tracer()) if args.trace_out else Recorder()
    opts = EngineOptions(
        device=args.device, hw=hw, measure=args.measure,
        preempt=args.preempt, num_pages=args.num_pages,
        prefix_cache=args.prefix_cache,
        adaptive=args.num_partitions is None, obs=obs,
        devices=args.devices, kv_sharding=args.kv_sharding,
        decode_graph=args.devices <= 1,
        **({} if args.batch is None else {"max_slots": args.batch}))
    sampling = None
    if args.temperature > 0:
        sampling = SamplingParams(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p,
                                  seed=args.sample_seed)
    eos = args.eos if args.eos >= 0 else None
    server = None

    def on_engine(engine) -> None:
        # after warmup: the exporter thread starts once the decode step
        # is captured; scrape-time refresh through the engine's gauges
        nonlocal server
        print(f"state cache: {engine.cache_kind}", flush=True)
        if args.metrics_port >= 0:
            server = MetricsServer(obs.registry, port=args.metrics_port,
                                   refresh=engine._refresh_gauges).start()
            print(f"metrics: {server.url}/metrics", flush=True)

    dt = None
    try:
        if args.rate is not None:
            engine, dt = run_poisson(
                cfg, opts, requests=args.requests, rate=args.rate,
                prompt_max=_range(args.prompt_len)[1],
                gen_max=_range(args.gen)[1], seed=args.seed, eos_id=eos,
                time_scale=args.time_scale, sampling=sampling,
                on_engine=on_engine, weights_seed=args.seed,
                params=params)
        else:
            engine = Engine(cfg, params, options=opts, seed=args.seed)
            print(f"warmup: {engine.warmup()} programs built", flush=True)
            on_engine(engine)
            if args.http_port >= 0:
                _ingress(engine, args, stop, on_ingress)
            else:
                for prompt, gen in synthetic_requests(
                        args.requests, cfg.vocab_size,
                        _range(args.prompt_len), _range(args.gen),
                        args.seed):
                    engine.submit(prompt, max_new_tokens=gen, eos_id=eos,
                                  sampling=sampling)
                engine.run_until_idle()
    finally:
        if server is not None:
            server.stop()
    if args.trace_out:
        obs.tracer.write(args.trace_out)
        print(f"trace: {args.trace_out} (load in https://ui.perfetto.dev)")
    s = engine.stats()
    if s["devices"] > 1:
        import torch.distributed
        kvs = (f"DP-sharded KV x{s['kv_shards']}" if s["kv_shards"] > 1
               else "replicated KV")
        print(f"mesh: {s['devices']} devices = dp {s['dp_size']} x ep "
              f"{s['ep_size']} (EP-sharded prefill, {kvs}; "
              f"{s['per_device_cache_bytes'] / 2**20:.2f}MiB KV pool per "
              f"device; {torch.distributed.get_backend()}, decode step "
              f"eager)")
    if dt is not None:
        _print_replay(s, dt)
        s["wall_s"] = dt
    _print_stats(s, engine)
    s["arch"] = cfg.name
    print(json.dumps(s, sort_keys=True))
    return s


if __name__ == "__main__":
    main()
