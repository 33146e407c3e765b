"""Serving launcher of the port: the continuous-batching engine on
seeded synthetic prompts.

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
fixes n. It runs on the card; ``--device cpu``
runs it on the CPU. ``--engine`` is accepted so the JAX launcher's
command line runs unchanged; the engine is the only serving mode
ported. The Poisson trace replay, the HTTP ingress and ``/metrics`` of
the JAX launcher come with ROADMAP.md's later slices.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--engine", action="store_true",
                    help="the continuous-batching engine (the only mode "
                         "ported; accepted as the JAX launcher takes it)")
    ap.add_argument("--arch", default="moe-gpt3-s")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's tiny same-family reduction")
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
    ap.add_argument("--prompt-len", default="16:64",
                    help="prompt length, N or LO:HI")
    ap.add_argument("--gen", default="16:32",
                    help="new tokens per request, N or LO:HI")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the prompts")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    from repro_torch.serve import Engine, EngineOptions

    cfg = configure(args)
    hw = resolve_hw(args.hw)
    print(f"hw spec: {hw.name}", flush=True)
    engine = Engine(cfg, options=EngineOptions(
        device=args.device, hw=hw, measure=args.measure,
        preempt=args.preempt, num_pages=args.num_pages,
        prefix_cache=args.prefix_cache,
        adaptive=args.num_partitions is None), seed=args.seed)
    print(f"warmup: {engine.warmup()} programs built", flush=True)
    for prompt, gen in synthetic_requests(
            args.requests, cfg.vocab_size, _range(args.prompt_len),
            _range(args.gen), args.seed):
        engine.submit(prompt, max_new_tokens=gen)
    engine.run_until_idle()
    s = engine.stats()
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
    s["arch"] = cfg.name
    print(json.dumps(s, sort_keys=True))
    return s


if __name__ == "__main__":
    main()
