"""Training launcher of the port: optimizer steps of a model on seeded
synthetic tokens (AdamW, 8-bit AdamW or Adafactor, as ``cfg.optimizer``
says).

    PYTHONPATH=src python -m repro_torch.launch.train --arch moe-gpt3-s \\
        --full --steps 10 --batch 8 --seq 1024

It runs on the card; ``--device cpu`` runs it on the CPU. The flags are
the subset of the JAX launcher's that the port supports (with
``--device`` as the serving launcher has it); ``--reduced`` (the
default, as in the JAX launcher) takes the config's tiny CPU-sized
version and ``--full`` the published widths. As in the JAX launcher, an
MoE config's ``(n, strategy)`` placeholders are resolved once, offline,
for ``--batch`` x ``--seq`` tokens on the ``--hw`` spec (Algorithm 1
with the pipeline simulator, Eq. 10) and printed at start; with
``--adaptive [--retune-every K]`` the online controller resolves them
while training instead, and the final ``n``/``strategy`` are printed at
the end. ``--metrics-port`` serves live Prometheus ``/metrics`` (the
``repro_train_step``, ``repro_train_loss`` and
``repro_train_step_seconds`` families and the controller's resolver
families) and ``--trace-out`` writes the resolver's retune spans as a
Perfetto-loadable trace at exit, as in the JAX launcher.
``--ckpt-dir DIR`` checkpoints the run there every ``--ckpt-every``
steps and at the end, and a run started over the same directory resumes
from its latest checkpoint (``''``, the default, turns it off).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import List, Optional, Sequence

from repro_torch.ckpt import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.selector import resolve
from repro_torch.core.types import HW_SPECS, resolve_hw
from repro_torch.data import SyntheticTokens
from repro_torch.runtime import AdaptiveOptions, TrainOptions, train


def configure(args) -> ArchConfig:
    """The config, its MoE placeholders resolved offline for one device
    (``--adaptive``: set to the placeholders for the online
    controller)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.moe is None:
        return cfg
    if args.adaptive:
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_partitions=0, memory_reuse_strategy="adaptive"))
    return resolve(cfg, local_tokens=args.batch * args.seq, ep_size=1,
                   hw=resolve_hw(args.hw), dp=1)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="moe-gpt3-s")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    ap.add_argument("--hw", default="auto",
                    choices=["auto"] + sorted(HW_SPECS),
                    help="hardware spec for the MPipeMoE resolver "
                         "(auto = gpu-h100 with CUDA, else cpu-host)")
    ap.add_argument("--adaptive", action="store_true",
                    help="online (n, strategy) controller instead of a "
                         "one-shot offline resolve")
    ap.add_argument("--retune-every", type=int, default=0,
                    help="with --adaptive: also re-resolve every K steps "
                         "(0 = only on batch-shape change)")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="serve live Prometheus /metrics (controller "
                         "retunes + training heartbeat gauges) on this "
                         "port (0 = free port; -1 = disabled)")
    ap.add_argument("--trace-out", default="",
                    help="write resolver retune spans as a "
                         "Perfetto-loadable trace here at exit "
                         "('' = off)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Runs the launcher; returns the history of metric dicts."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = configure(args)
    # one telemetry surface for training: resolver retune spans and
    # counters land in the registry the heartbeat gauges use
    from repro_torch.obs import MetricsServer, Recorder, Tracer
    obs = Recorder(tracer=Tracer()) if args.trace_out else Recorder()
    server = None
    if args.metrics_port >= 0:
        server = MetricsServer(obs.registry,
                               port=args.metrics_port).start()
        print(f"metrics: {server.url}/metrics", flush=True)
    adaptive = False
    if cfg.moe is not None and args.adaptive:
        adaptive = AdaptiveOptions(retune_every=args.retune_every,
                                   hw=resolve_hw(args.hw), obs=obs)
        print("MPipeMoE: online adaptive (n, strategy) "
              f"(retune_every={args.retune_every})", flush=True)
    elif cfg.moe is not None:
        print(f"MPipeMoE: n={cfg.moe.num_partitions} "
              f"strategy={cfg.moe.memory_reuse_strategy}", flush=True)
    ds = SyntheticTokens(cfg, batch=args.batch, seq=args.seq, seed=0)
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    opts = TrainOptions(lr=args.lr, warmup=min(20, args.steps // 5),
                        total_steps=args.steps)

    g_step = obs.registry.gauge("repro_train_step", "last training step")
    g_loss = obs.registry.gauge("repro_train_loss", "last training loss")
    h_step = obs.registry.histogram("repro_train_step_seconds",
                                    "training step wall time")

    def heartbeat(step, metrics):
        g_step.set(step)
        g_loss.set(float(metrics["loss"]))
        h_step.observe(float(metrics["step_time_s"]))
        if step % 10 == 0:
            extra = (f" n={metrics['n']} strat={metrics['strategy']}"
                     if "n" in metrics else "")
            print(f"step {step:5d} loss={metrics['loss']:.4f} "
                  f"t={metrics['step_time_s'] * 1e3:.0f}ms{extra}",
                  flush=True)

    try:
        _, hist = train(cfg, steps=args.steps, batch_source=ds, opts=opts,
                        checkpointer=ck, ckpt_every=args.ckpt_every,
                        heartbeat=heartbeat, adaptive=adaptive,
                        device=args.device)
    finally:
        if server is not None:
            server.stop()
        if args.trace_out:
            obs.tracer.write(args.trace_out)
            print(f"trace: {args.trace_out}")
    print(f"final loss {hist[-1]['loss']:.4f} at step {hist[-1]['step']}")
    if "n" in hist[-1]:                   # controller engaged (MoE arch)
        print(f"adaptive: n={hist[-1]['n']} "
              f"strategy={hist[-1]['strategy']}")
    return hist


if __name__ == "__main__":
    main()
