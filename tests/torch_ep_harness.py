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
    issue order: ``D`` a dispatch (or its gradient), ``C`` a combine (or
    its gradient), ``F`` an FFN."""
    out, log = _logged(fn)
    return out, [e[0] for e in log if e[0] in "DCF"]


def _logged(fn):
    """``fn()`` and its event log: an All-to-All ``("D" | "C", id)`` when
    issued (``D``: a ``[E, cap, M]`` buffer, ``C``: ``[ep, e_local, cap,
    M]``) and ``("W", id)`` when waited on (at once for a synchronous
    one), an expert FFN's forward ``("F",)`` and backward ``("B",)``."""
    import itertools

    from repro_torch.kernels.grouped_ffn import ops
    log, count = [], itertools.count()
    a2a, ref = dist.all_to_all_single, ops.grouped_ffn_ref

    class Work:
        def __init__(self, work, i):
            self.work, self.i = work, i

        def wait(self, *a, **k):
            out = self.work.wait(*a, **k)
            log.append(("W", self.i))
            return out

    def logged_a2a(out, x, *a, async_op=False, **k):
        i = next(count)
        log.append(("D" if x.dim() == 3 else "C", i))
        work = a2a(out, x, *a, async_op=async_op, **k)
        if not async_op:
            log.append(("W", i))
            return work
        return Work(work, i)

    def logged_ref(*a, round_hidden=True, **k):
        log.append(("F",) if round_hidden else ("B",))
        return ref(*a, round_hidden=round_hidden, **k)
    dist.all_to_all_single, ops.grouped_ffn_ref = logged_a2a, logged_ref
    try:
        out = fn()
    finally:
        dist.all_to_all_single, ops.grouped_ffn_ref = a2a, ref
    return out, log


def spans(log) -> list:
    """Per All-to-All of ``_logged``'s log: the expert FFN events (``F``
    or ``B``) between its issue and its wait."""
    start, out = {}, []
    for i, e in enumerate(log):
        if e[0] in "DC":
            start[e[1]] = i
        elif e[0] == "W":
            out.append([x[0] for x in log[start.pop(e[1]) + 1:i]
                        if x[0] in "FB"])
    return out


def schedule_rank(ctx, cfgs, tokens, labels, timings):
    """The overlapped and serial schedules side by side on one rank:
    per config, loss and reduced gradients (flat), the gathered
    gradients, the forward's collective order and the backward's event
    log (``_logged``; n = 4); the rank's place in the mesh; the
    controller's resolution under rank-dependent timings."""
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
            loss, _ = lm.loss_fn(params, rows, c4, ctx)
            _, bwd = _logged(lambda: torch.autograd.grad(
                loss, leaves(params), allow_unused=True))
            out[(name, unroll)] = {
                "loss": float(m["loss"]),
                "grads": [g.numpy() for g in grads],
                "whole": _numpy(gather_params(unflatten(params, grads),
                                              cfg, ctx)),
                "logits": logits.numpy(), "events": log, "backward": bwd}
    cfg = next(iter(cfgs.values()))
    mine = timings[ctx.rank]
    ctl = AdaptiveController(
        cfg, TrainOptions(), AdaptiveOptions(
            measure_fn=lambda b, n, s: mine[n], candidates=sorted(mine)),
        device="cpu", dist=ctx)
    _, info = ctl.step_fn(None, rows, 0)
    out["resolved"] = (info["n"], info["strategy"])
    return out


# ---------------------------------------------------------------------------
# Train states over ranks: the 8-bit AdamW and Adafactor on shards,
# checkpoints (tests/test_torch_ep_state.py)
# ---------------------------------------------------------------------------

def flat_state(state) -> dict:
    """A state as ``{"key/path": numpy or int}`` (the checkpoint's
    keys), copied."""
    from repro_torch.ckpt.checkpoint import _items
    return {k: v.detach().cpu().numpy().copy()
            if isinstance(v, torch.Tensor) else v for k, v in _items(state)}


def state_bytes(state) -> int:
    """Bytes of a state's optimizer tensors."""
    from repro_torch.ckpt.checkpoint import _items
    return sum(v.numel() * v.element_size() for _, v in _items(state["opt"])
               if isinstance(v, torch.Tensor))


def optim_steps(ctx, cfg, params_np, batch, lr, steps=2):
    """``steps`` train steps from the JAX weights at state step 1 (the
    first's learning-rate scale is the JAX reference's): each step's
    gathered gradients and gathered state (flat), and this rank's
    optimizer state bytes."""
    from repro_torch.convert import from_jax, gather_params, gather_state
    from repro_torch.models.module import unflatten
    from repro_torch.runtime.train_loop import (TrainOptions, _step_parts,
                                                init_state)
    opts = TrainOptions(lr=lr, warmup=1, total_steps=10)
    state = init_state(cfg, opts, params=from_jax(params_np, device="cpu"),
                       dist=ctx)
    state["step"] = 1
    grads_of, update = _step_parts(cfg, opts, ctx)
    out = {"grads": [], "states": [], "opt_bytes": state_bytes(state)}
    for _ in range(steps):
        grads, metrics = grads_of(state["params"], batch)
        out["grads"].append(_numpy(gather_params(
            unflatten(state["params"], grads), cfg, ctx)))
        state, _ = update(state, grads, metrics)
        out["states"].append(flat_state(gather_state(state, cfg, ctx)))
    return out


def _train(ctx, cfg, params_np, steps, **kw):
    from repro_torch.convert import from_jax
    from repro_torch.data import SyntheticTokens
    from repro_torch.runtime import TrainOptions, init_state, train
    opts = TrainOptions(lr=1e-3, warmup=2, total_steps=4)
    state = init_state(cfg, opts, params=from_jax(params_np, device="cpu"),
                       dist=ctx)
    return train(cfg, steps=steps, opts=opts, adaptive=False, state=state,
                 batch_source=SyntheticTokens(cfg, 4, 32, seed=5), dist=ctx,
                 **kw)


def _fails_once(module, rank, call):
    """``module.update`` that raises, after its work, on ``rank`` alone at
    its ``call``-th call."""
    update, calls = module.update, []

    def flaky(*a, **k):
        out = update(*a, **k)
        calls.append(1)
        if dist.get_rank() == rank and len(calls) == call:
            raise RuntimeError("update failed on one rank")
        return out
    module.update = flaky
    return update, calls


def await_file(path: str, timeout: float = TIMEOUT) -> None:
    """Waits (bounded) for ``path``, which another process writes."""
    import time
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)


def manifest(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:010d}", "manifest.json")


def ckpt_rank(ctx, cfgs, params_np, tmp, one_device):
    """Per optimizer at this mesh: 4 steps uninterrupted; 2 steps saved
    (``ckpt_every=2``) and a new run over the same directory to 4; a new
    run from a copy of the step-2 checkpoint whose update fails once, on
    rank 1 alone, at step 3; the gathered final states (flat), the runs'
    steps, the save's blocking seconds and bytes; and whether restoring
    ``one_device``'s one-device checkpoints (path, step; awaited) gives
    ``shard_state`` of them."""
    import shutil

    from repro_torch.ckpt import Checkpointer
    from repro_torch.convert import gather_state, shard_state
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime import TrainOptions, init_state
    from repro_torch.runtime.train_loop import state_layout
    out = {}
    for name, cfg in cfgs.items():
        ref, _ = _train(ctx, cfg, params_np, 4)
        d = os.path.join(tmp, f"{name}_resume")
        ck = Checkpointer(d)
        _train(ctx, cfg, params_np, 2, checkpointer=ck, ckpt_every=2)
        save = {"copy_s": ck.last_copy_s, "bytes": ck.last_bytes,
                "write_s": ck.last_write_s}
        fail = os.path.join(tmp, f"{name}_fail")
        if ctx.rank == 0:
            shutil.copytree(d, fail)
        dist.barrier()
        got, hist = _train(ctx, cfg, params_np, 4, ckpt_every=2,
                           checkpointer=Checkpointer(d))
        mod = get_optimizer(cfg.optimizer)[0]
        update, calls = _fails_once(mod, rank=1, call=2)
        try:
            failed, fhist = _train(ctx, cfg, params_np, 4, ckpt_every=2,
                                   checkpointer=Checkpointer(fail))
        finally:
            mod.update = update
        path, step = one_device[name]
        await_file(manifest(path, step))
        mine = Checkpointer(path).restore(
            step, like=init_state(cfg, TrainOptions(), device="cpu",
                                  dist=ctx),
            shardings=state_layout(cfg, ctx))
        whole = Checkpointer(path).restore(step, like=init_state(
            cfg, TrainOptions(), device="cpu"))
        want = flat_state(shard_state(whole, cfg, ctx))
        out[name] = {
            "ref": flat_state(gather_state(ref, cfg, ctx)),
            "resumed": flat_state(gather_state(got, cfg, ctx)),
            "resumed_steps": [h["step"] for h in hist],
            "failed": flat_state(gather_state(failed, cfg, ctx)),
            "failed_steps": [h["step"] for h in fhist],
            "update_calls": len(calls), "save": save,
            "one_device_restored": _flat_equal(flat_state(mine), want)}
    return out


def _flat_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) for k in a)


def restore_rank(ctx, ckpts):
    """Each of ``ckpts`` (name -> (config, dir, step); awaited) restored
    into this mesh's fresh state: the gathered state (flat)."""
    from repro_torch.ckpt import Checkpointer
    from repro_torch.convert import gather_state
    from repro_torch.runtime import TrainOptions, init_state
    from repro_torch.runtime.train_loop import state_layout
    out = {}
    for name, (cfg, path, step) in ckpts.items():
        await_file(manifest(path, step))
        state = init_state(cfg, TrainOptions(), device="cpu", dist=ctx)
        state = Checkpointer(path).restore(step, like=state,
                                           shardings=state_layout(cfg, ctx))
        out[name] = flat_state(gather_state(state, cfg, ctx))
    return out


def state_rank(ctx, cfgs, params_np, tokens, labels, lr, tmp, one_device,
               ckpts):
    """The optimizers' steps (``optim_steps``) for each config, then at
    mesh (2, 2) ``ckpt_rank``'s runs, elsewhere ``restore_rank`` of
    ``ckpts``."""
    from repro_torch.runtime.train_loop import _rows
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             _rows({"tokens": tokens, "labels": labels}, ctx).items()}
    out = {"steps": {name: optim_steps(ctx, cfg, params_np, batch, lr)
                     for name, cfg in cfgs.items()}}
    if one_device is not None:
        out["ckpt"] = ckpt_rank(ctx, cfgs, params_np, tmp, one_device)
    if ckpts is not None:
        out["restored"] = restore_rank(ctx, ckpts)
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
