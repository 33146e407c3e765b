"""Training launcher of the port: AdamW steps of a model on seeded
synthetic tokens.

    PYTHONPATH=src python -m repro_torch.launch.train --arch moe-gpt3-s \\
        --full --steps 10 --batch 8 --seq 1024

It runs on the card; ``--device cpu`` runs it on the CPU. The flags are
the subset of the JAX launcher's that this slice supports (with
``--device`` as the serving launcher has it); ``--reduced`` (the
default, as in the JAX launcher) takes the config's tiny CPU-sized
version and ``--full`` the published widths. MoE configs train with the
fixed ``(n, strategy)`` the config holds — ``num_partitions`` 0 runs as
n = 4 and ``"adaptive"`` as ``none`` — printed at start; the offline
resolver and the online controller of the JAX launcher come with
ROADMAP.md's 'Adaptive (n, strategy)' slice.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import List, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.data import SyntheticTokens
from repro_torch.runtime import TrainOptions, train


def configure(args) -> ArchConfig:
    """The config with the MoE placeholders made concrete."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.moe is None:
        return cfg
    s = cfg.moe.memory_reuse_strategy
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_partitions=cfg.moe.num_partitions or 4,
        memory_reuse_strategy="none" if s == "adaptive" else s))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="moe-gpt3-s")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Runs the launcher; returns the history of metric dicts."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = configure(args)
    if cfg.moe is not None:
        print(f"MPipeMoE: n={cfg.moe.num_partitions} "
              f"strategy={cfg.moe.memory_reuse_strategy}", flush=True)
    ds = SyntheticTokens(cfg, batch=args.batch, seq=args.seq, seed=0)
    opts = TrainOptions(lr=args.lr, warmup=min(20, args.steps // 5),
                        total_steps=args.steps)

    def heartbeat(step, metrics):
        if step % 10 == 0:
            print(f"step {step:5d} loss={metrics['loss']:.4f} "
                  f"t={metrics['step_time_s'] * 1e3:.0f}ms", flush=True)

    _, hist = train(cfg, steps=args.steps, batch_source=ds, opts=opts,
                    heartbeat=heartbeat, adaptive=False, device=args.device)
    print(f"final loss {hist[-1]['loss']:.4f} at step {hist[-1]['step']}")
    return hist


if __name__ == "__main__":
    main()
