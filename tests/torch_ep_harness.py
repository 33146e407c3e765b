"""Ranks of the port over ``torch.distributed`` (gloo, CPU) for the
expert-parallel tests, and the JAX references those tests hold them to.

``run_ranks(fn, mesh, *args)`` spawns ``dp * ep`` processes, each of
which starts a gloo group over ``tcp://localhost``, builds its
``DistContext`` (``make_context``) and returns ``fn(ctx, *args)``; the
parent gets every rank's result in rank order. Every wait is bounded: the
group's store, the result queue and the joins. The rank functions live
here, in a module that imports no JAX, so that a spawned rank starts
with torch alone.

``jax_reference(script, tmp, inputs, devices)`` runs a JAX script on
virtual CPU devices in a subprocess (``mesh_harness``), handing it
``inputs`` and taking back its arrays through ``.npz`` files in
``tmp``; ``start_jax_reference`` starts it without waiting, so the
port's ranks run beside it.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC_PATH = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        "src"))
TIMEOUT = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, mesh, port, fn, args, queue):
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=mesh[0] * mesh[1],
            timeout=datetime.timedelta(seconds=TIMEOUT))
        from repro_torch.distributed import make_context
        ctx = make_context(mesh[0], mesh[1], "cpu")
        out = fn(ctx, *args)
        queue.put((rank, "ok", out))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:                          # reported to the parent
        queue.put((rank, "error", traceback.format_exc()))
        raise


def run_ranks(fn, mesh, *args, timeout: float = TIMEOUT) -> list:
    """``fn(ctx, *args)`` on each rank of a ``(dp, ep)`` mesh -> the
    results in rank order; raises with the first rank's traceback."""
    world = mesh[0] * mesh[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, mesh, port, fn, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results = [None] * world
    try:
        for _ in range(world):
            rank, status, out = queue.get(timeout=timeout)
            if status != "ok":
                raise AssertionError(f"rank {rank} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    assert not any(p.is_alive() for p in procs)
    return results


def start_jax_reference(script: str, tmp, inputs: dict, devices: int):
    """Start ``script`` (reads ``sys.argv[1]/in.npz``, writes
    ``out.npz`` there) on ``devices`` virtual CPU devices."""
    np.savez(os.path.join(tmp, "in.npz"), **inputs)
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{devices}",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC_PATH + (
                   os.pathsep + os.environ["PYTHONPATH"]
                   if os.environ.get("PYTHONPATH") else ""))
    return subprocess.Popen([sys.executable, "-c", script, str(tmp)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_jax_reference(proc, tmp, timeout: float = TIMEOUT) -> dict:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"JAX reference failed:\n{err[-3000:]}"
    with np.load(os.path.join(tmp, "out.npz")) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# Rank bodies
# ---------------------------------------------------------------------------

def _numpy(tree):
    from repro_torch.models.module import leaves
    return [x.detach().cpu().numpy() for x in leaves(tree)]


def train_rank(ctx, params_np, tokens, labels, cfgs, lr):
    """One AdamW step at state step 1 per config: the loss, the grad
    norm, the whole (gathered) gradient and the whole parameters after
    the step, as numpy leaves; under ep > 1 whether a batch one token
    short of a sequence that splits over the EP group raises."""
    from repro_torch.convert import from_jax, gather_params
    from repro_torch.models.module import unflatten
    from repro_torch.runtime.train_loop import (TrainOptions, _rows,
                                                _step_parts, init_state)
    out = {}
    rows = _rows({"tokens": tokens, "labels": labels}, ctx)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in rows.items()}
    for name, cfg in cfgs.items():
        opts = TrainOptions(lr=lr, warmup=1, total_steps=10)
        state = init_state(cfg, opts, params=from_jax(params_np,
                                                      device="cpu"),
                           dist=ctx)
        state["step"] = 1
        grads_of, update = _step_parts(cfg, opts, ctx)
        grads, metrics = grads_of(state["params"], batch)
        whole_g = _numpy(gather_params(unflatten(state["params"], grads),
                                       cfg, ctx))
        state, m = update(state, grads, metrics)
        out[name] = {"loss": m["loss"], "grad_norm": m["grad_norm"],
                     "grads": whole_g,
                     "params": _numpy(gather_params(state["params"], cfg,
                                                    ctx))}
    if ctx.ep_size > 1:                 # a sequence that does not split
        try:
            grads_of(state["params"], {k: v[:, :-1] for k, v in
                                       batch.items()})
            out["odd_seq_raises"] = False
        except NotImplementedError:
            out["odd_seq_raises"] = True
    return out


def decode_rank(ctx, params_np, cfg, prompts, max_len, steps):
    """``lm.prefill`` then ``steps`` greedy ``lm.decode_step``s over this
    rank's dp rows of ``prompts``: each step's logits and tokens."""
    from repro_torch.convert import shard_params
    from repro_torch.models import lm
    from repro_torch.runtime.train_loop import _rows
    params = shard_params(params_np, cfg, ctx, mode="prefill")
    rows = torch.from_numpy(_rows({"t": prompts}, ctx)["t"])
    with torch.no_grad():
        logits, cache = lm.prefill(params, rows, cfg, max_len,
                                   dtype=torch.float32, dist=ctx)
        out = {"prefill": logits.numpy(), "steps": [], "tokens": []}
        last = logits[:, -1]
        for _ in range(steps):
            tok = last.argmax(-1, keepdim=True).int()
            out["tokens"].append(tok.numpy())
            last, cache = lm.decode_step(params, cache, tok, cfg, dist=ctx)
            out["steps"].append(last.numpy())
    return out


def compress_rank(ctx, whole, error, steps):
    """``compress_with_feedback`` over a ZeRO-3 split of ``whole`` (its
    last dim over the dp group, the row maxima over the group), ``steps``
    times with the error carried; the gathered grads and errors."""
    from repro_torch.distributed.collectives import gather_dim
    from repro_torch.distributed.compression import compress_with_feedback
    n = whole.shape[-1] // ctx.dp_size
    cols = slice(ctx.dp_rank * n, (ctx.dp_rank + 1) * n)
    g = {"w": torch.from_numpy(whole[..., cols].copy())}
    e = {"w": torch.from_numpy(error[..., cols].copy())}
    out = []
    for _ in range(steps):
        c, e = compress_with_feedback(g, e,
                                      amax_group=lambda p: ctx.dp_group)
        out.append((gather_dim(c["w"], ctx.dp_group, c["w"].dim() - 1),
                    gather_dim(e["w"], ctx.dp_group, e["w"].dim() - 1)))
        g = c
    return [(a.numpy(), b.numpy()) for a, b in out]


def _events(fn):
    """``fn()`` with the MoE's All-to-Alls and expert FFNs logged in
    issue order: ``D`` a dispatch, ``C`` a combine, ``F`` an FFN."""
    from repro_torch.distributed import collectives
    from repro_torch.moe import experts
    log, a2a, ffn = [], collectives.all_to_all, experts.apply_grouped

    def logged_a2a(x, *a, **k):
        log.append("D" if x.dim() == 3 else "C")
        return a2a(x, *a, **k)

    def logged_ffn(*a, **k):
        log.append("F")
        return ffn(*a, **k)
    collectives.all_to_all, experts.apply_grouped = logged_a2a, logged_ffn
    try:
        out = fn()
    finally:
        collectives.all_to_all, experts.apply_grouped = a2a, ffn
    return out, log


def schedule_rank(ctx, cfgs, tokens, labels, timings):
    """The overlapped and serial schedules side by side on one rank:
    per config, loss and reduced gradients (flat), the gathered
    gradients, and the forward's collective order; the rank's place in
    the mesh; the controller's resolution under rank-dependent timings."""
    import dataclasses
    from repro_torch.convert import gather_params, shard_tree
    from repro_torch.models import lm
    from repro_torch.models.module import leaves, unflatten
    from repro_torch.runtime.train_loop import (AdaptiveController,
                                                AdaptiveOptions,
                                                TrainOptions, _rows,
                                                _step_parts)
    rows = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            _rows({"tokens": tokens, "labels": labels}, ctx).items()}
    out = {"layout": {
        "rank": ctx.rank, "dp_rank": ctx.dp_rank, "ep_rank": ctx.ep_rank,
        "ep_group": dist.get_process_group_ranks(ctx.ep_group),
        "dp_group": dist.get_process_group_ranks(ctx.dp_group)}}
    for name, cfg in cfgs.items():
        full = lm.init(cfg, 0, device="cpu")
        params = shard_tree(full, cfg, ctx)
        served = shard_tree(full, cfg, ctx, mode="prefill")
        for p in leaves(params):
            p.requires_grad_(True)
        for unroll in (True, False):
            c = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, pipeline_unroll=unroll))
            grads_of, _ = _step_parts(c, TrainOptions(), ctx)
            grads, m = grads_of(params, rows)
            c4 = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, num_partitions=4))
            with torch.no_grad():
                (logits, _, _), log = _events(lambda: lm.forward(
                    served, rows["tokens"], c4, mode="prefill", dist=ctx))
            out[(name, unroll)] = {
                "loss": float(m["loss"]),
                "grads": [g.numpy() for g in grads],
                "whole": _numpy(gather_params(unflatten(params, grads),
                                              cfg, ctx)),
                "logits": logits.numpy(), "events": log}
    cfg = next(iter(cfgs.values()))
    mine = timings[ctx.rank]
    ctl = AdaptiveController(
        cfg, TrainOptions(), AdaptiveOptions(
            measure_fn=lambda b, n, s: mine[n], candidates=sorted(mine)),
        device="cpu", dist=ctx)
    _, info = ctl.step_fn(None, rows, 0)
    out["resolved"] = (info["n"], info["strategy"])
    out["raises"] = _unported(ctx, cfg)
    return out


def _unported(ctx, cfg) -> dict:
    """Which of slice 3b's entries raise ``NotImplementedError`` here."""
    import dataclasses
    from repro_torch.runtime.train_loop import TrainOptions, init_state, train
    entries = {
        "checkpointer": lambda: train(cfg, steps=1, batch_source=None,
                                      checkpointer=object(), dist=ctx),
        **{opt: lambda o=opt: init_state(
            dataclasses.replace(cfg, optimizer=o), TrainOptions(),
            dist=ctx) for opt in ("adamw8bit", "adafactor")}}
    out = {}
    for name, fn in entries.items():
        try:
            fn()
            out[name] = False
        except NotImplementedError:
            out[name] = True
    return out


def serve_engine(cfg, params, prompts, max_new, *, cancel_at=None,
                 repeat=0, rank_measure=False, **over):
    """The port's ``Engine`` over ``prompts`` (then the first ``repeat``
    again, for prefix hits) on the CPU, run to idle. ``cancel_at``:
    ``(rid, tokens)`` cancels request ``rid`` once it holds ``tokens``
    tokens, and ``(rid, tokens, rank)`` asks for it on that rank alone.
    ``rank_measure``: the adaptive prefill's candidate times differ by
    rank (rank 0 favours few chunks, the others many; the world's
    maximum favours 4). Returns each finished request's tokens by rid,
    the cancelled rids, whether every shard drained, and ``stats()``."""
    from repro_torch.serve import Engine, EngineOptions
    kw = dict(page_size=4, max_slots=3, max_seq_len=64, chunk=16,
              min_bucket=8, device="cpu", decode_graph=False,
              adaptive=False)
    if rank_measure:
        first = not dist.is_initialized() or dist.get_rank() == 0
        kw.update(adaptive=True, measure_fn=lambda b, n, strategy: (
            1.0 + n if first else 12.0 / n))
    kw.update(over)
    eng = Engine(cfg, params, options=EngineOptions(**kw))
    reqs = [eng.submit(p, max_new_tokens=m)
            for p, m in list(zip(prompts, max_new))
            + list(zip(prompts, max_new))[:repeat]]
    while eng.has_work:
        eng.step()
        if cancel_at is not None:
            rid, tokens, *rank = cancel_at
            if len(reqs[rid].output) >= tokens and (
                    not rank or dist.get_rank() == rank[0]):
                eng.cancel(reqs[rid])
                cancel_at = None
    kv = eng.kv
    return {"outs": {r.rid: list(r.output) for r in eng.done},
            "cancelled": sorted(r.rid for r in eng.cancelled),
            "drained": all(kv.free_pages_of(s) == kv.shard_capacity_pages
                           for s in range(kv.n_shards))
            and not kv.offloaded_count,
            "stats": eng.stats()}


def engine_rank(ctx, params_np, cfgs, prompts, max_new, cases):
    """``serve_engine`` over this rank's ``Engine`` of ``devices`` = the
    world for each ``(name, cfg key, options)`` of ``cases``, and which
    misuses raise: ``devices`` other than the world, and a captured
    decode step under the group."""
    from repro_torch.convert import from_jax
    from repro_torch.serve import Engine, EngineOptions
    params = {k: from_jax(v, device="cpu") for k, v in params_np.items()}
    world = ctx.world_size
    out = {}
    for name, key, over in cases:
        out[name] = serve_engine(cfgs[key], params[key], prompts, max_new,
                                 devices=world, **over)
    key = next(iter(cfgs))
    for name, over, err in (
            ("devices_not_world", dict(devices=world + 1, decode_graph=False),
             ValueError),
            ("decode_graph", dict(devices=world), NotImplementedError)):
        try:
            Engine(cfgs[key], params[key], options=EngineOptions(
                device="cpu", adaptive=False, max_slots=2, max_seq_len=32,
                **over))
            out[name] = "no error"
        except err as e:
            out[name] = str(e)
    return out
