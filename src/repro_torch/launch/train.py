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
``--compress-grads`` turns on int8 gradient compression.

Over ranks, under ``torch.distributed.run`` (one process a rank; NCCL on
the card, gloo with ``--device cpu``), ``--mesh-data`` x
``--mesh-model`` is the ``(dp, ep)`` mesh, JAX's rank layout; the world
size must equal it. ``--batch`` is the global batch, split over dp:

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --mesh-data 2 --mesh-model 2 \
        --device cpu --steps 3

The offline resolve takes ``ep_size`` and ``dp`` from the mesh; rank 0
prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import List, Optional, Sequence

import torch.distributed

from repro_torch.ckpt import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.selector import resolve
from repro_torch.core.types import HW_SPECS, resolve_hw
from repro_torch.data import SyntheticTokens
from repro_torch.distributed import init_distributed
from repro_torch.runtime import AdaptiveOptions, TrainOptions, train


def configure(args) -> ArchConfig:
    """The config, its MoE placeholders resolved offline for the mesh
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
    return resolve(cfg, local_tokens=args.batch * args.seq,
                   ep_size=args.mesh_model, hw=resolve_hw(args.hw),
                   dp=args.mesh_data)


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
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="data-parallel ranks (under "
                         "torch.distributed.run)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="expert-parallel ranks (under "
                         "torch.distributed.run)")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradient compression with error feedback")
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
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.seq % args.mesh_model:
        ap.error(f"--seq {args.seq} must split over --mesh-model "
                 f"{args.mesh_model} (the MoE splits the sequence over the "
                 f"expert-parallel ranks)")
    logging.basicConfig(level=logging.INFO)
    dist = None
    if args.mesh_data * args.mesh_model > 1 or "RANK" in os.environ:
        dist = init_distributed(args.mesh_data, args.mesh_model,
                                device=args.device)
        args.device = str(dist.device)
    try:
        return _run(args, dist)
    finally:
        if dist is not None:
            torch.distributed.destroy_process_group()


def _run(args, dist) -> List[dict]:
    lead = dist is None or dist.rank == 0
    say = print if lead else (lambda *a, **k: None)
    if dist is not None:
        say(f"mesh: data={dist.dp_size} model={dist.ep_size} backend="
            f"{torch.distributed.get_backend()} world={dist.world_size}",
            flush=True)
    cfg = configure(args)
    # one telemetry surface for training: resolver retune spans and
    # counters land in the registry the heartbeat gauges use
    from repro_torch.obs import MetricsServer, Recorder, Tracer
    obs = Recorder(tracer=Tracer()) if args.trace_out else Recorder()
    server = None
    if args.metrics_port >= 0:
        server = MetricsServer(obs.registry,
                               port=args.metrics_port).start()
        say(f"metrics: {server.url}/metrics", flush=True)
    adaptive = False
    if cfg.moe is not None and args.adaptive:
        adaptive = AdaptiveOptions(retune_every=args.retune_every,
                                   hw=resolve_hw(args.hw), obs=obs)
        say("MPipeMoE: online adaptive (n, strategy) "
            f"(retune_every={args.retune_every})", flush=True)
    elif cfg.moe is not None:
        say(f"MPipeMoE: n={cfg.moe.num_partitions} "
            f"strategy={cfg.moe.memory_reuse_strategy}", flush=True)
    ds = SyntheticTokens(cfg, batch=args.batch, seq=args.seq, seed=0)
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    opts = TrainOptions(lr=args.lr, warmup=min(20, args.steps // 5),
                        total_steps=args.steps,
                        compress_grads=args.compress_grads)

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
            say(f"step {step:5d} loss={metrics['loss']:.4f} "
                f"t={metrics['step_time_s'] * 1e3:.0f}ms{extra}",
                flush=True)

    try:
        _, hist = train(cfg, steps=args.steps, batch_source=ds, opts=opts,
                        checkpointer=ck, ckpt_every=args.ckpt_every,
                        heartbeat=heartbeat, adaptive=adaptive,
                        device=args.device, dist=dist)
    finally:
        if server is not None:
            server.stop()
        if args.trace_out and lead:
            obs.tracer.write(args.trace_out)
            say(f"trace: {args.trace_out}")
    say(f"final loss {hist[-1]['loss']:.4f} at step {hist[-1]['step']}")
    if "n" in hist[-1]:                   # controller engaged (MoE arch)
        say(f"adaptive: n={hist[-1]['n']} "
            f"strategy={hist[-1]['strategy']}")
    return hist


if __name__ == "__main__":
    main()
