#!/usr/bin/env python3
"""Training over ranks, finished, on the card: ``chip_smoke.py``'s phase
20, and runnable alone.

    python3 tools/ep_state_phase.py [optim,trace]
    python3 tools/ep_state_phase.py --rehearse     # CPU, reduced configs

One H100 cannot host two NCCL ranks, so the ranks are gloo processes
sharing ``cuda:0``, as phase 18's are; gloo stages every collective
through host memory, so no time here is a multi-card number or the
paper's speed-up. The two parts run side by side, four ranks and two:

* ``optim`` (4 ranks, mesh (2, 2): ZeRO-3 expert shards, 3072 and 768
  divide dp 2): full-width moe-gpt3-s (d 768, 64 experts, H 3072) at 2
  layers (one MoE layer, for ``chip_smoke.py``'s time limit), fp32,
  capacity factor 8.0 (no route drops), a global batch of 4 x 256
  tokens, n = 2, NONE; 2 steps of ``adamw8bit`` and of ``adafactor``
  against the port's one-device optimizer on the card fed
  the ranks' gathered gradients from the same state: the gathered state
  and parameters bit-equal (``adamw8bit``, its ``Q8`` scales included)
  or within rtol 1e-6 of each leaf's largest magnitude (``adafactor``);
  each rank's optimizer state bytes, from its tensors, equal to the
  reckoning from the parameter shapes (``reckoned_rank_bytes``) to the
  byte; the expert FFN's inputs (``ffn_cases``) and the router and FFN
  launched once a call (``ep-optim`` lines). The ``adafactor`` run also
  checkpoints after its first step under a temporary directory: a fresh
  (2, 2) state restored from it and stepped again equals the run's
  second step on every rank bit for bit; each rank's blocking save ms,
  its file's bytes and the writer's seconds; rank 0 restores the
  checkpoint onto one device, bit-equal to the gathered state, and its
  seconds (``ep-ckpt``);
* ``trace`` (2 ranks, mesh (1, 2)): one bf16 MoE layer, 2 x 1024 tokens
  a rank, n = 4, under NONE and S4, the overlapped schedule
  (``pipeline_unroll=True``) and the serial one in turns: rank 0's
  profile of the backward pass, each All-to-All's flight (its issue to
  the end of gloo's work) against each other chunk's expert FFN call's
  device span (``_FfnClock``), and for each ordered chunk pair the time
  an All-to-All of the first spans an FFN of the second; the backward's
  ms and its peak memory above its start, the overlapped one's within
  one chunk's stage buffers (``T_DI``, the FFN input and output) of the
  serial one's (``ep-trace-bwd``). Through gloo's host staging, and
  beside the four other ranks, the ms is not the paper's speed-up.

Every check outside its bound ends the run non-zero. ``ep_state_phase``
returns the checked runs' kernel launches, summed over ranks, for
``chip_smoke.py``'s kernels line. Prints the card's name and power limit
first; needs one CUDA card unless ``--rehearse``.
"""
import collections
import dataclasses
import datetime
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from ep_phase import _ShapeLog, _check_calls, _free_port, _sync  # noqa

PARTS = ("optim", "trace")
OPTIMIZERS = ("adamw8bit", "adafactor")
TIMEOUT = 600.0
STATE_MESH, TRACE_MESH = (2, 2), (1, 2)
BATCH = {False: (4, 256), True: (4, 32)}             # keyed by rehearse
TRACE_TOKENS = {False: (2, 2048), True: (2, 64)}     # a rank's x [B, S]
TRACE_N = 4
ADAFACTOR_RTOL = 1e-6
CKPT_OPTIMIZER = "adafactor"       # the run that also checkpoints


def log(msg: str) -> None:
    print(msg, flush=True)


def config(rehearse: bool, optimizer: str = "adamw8bit"):
    from repro_torch.configs import get_config
    cfg = get_config("moe-gpt3-s")
    cfg = cfg.reduced() if rehearse else dataclasses.replace(cfg,
                                                             num_layers=2)
    return dataclasses.replace(
        cfg, compute_dtype="float32", param_dtype="float32",
        optimizer=optimizer, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0, num_partitions=2,
            memory_reuse_strategy="none"))


def trace_config(rehearse: bool, strategy: str, unroll: bool):
    from repro_torch.configs import get_config
    cfg = get_config("moe-gpt3-s")
    if rehearse:
        cfg = cfg.reduced()
    return dataclasses.replace(
        cfg, compute_dtype="float32" if rehearse else "bfloat16",
        moe=dataclasses.replace(cfg.moe, num_partitions=TRACE_N,
                                memory_reuse_strategy=strategy,
                                pipeline_unroll=unroll))


def _moe_layers(cfg) -> int:
    return cfg.num_periods * sum(r["moe"] for r in cfg.layer_roles())


def _ffn_input(cfg, chunk_tokens: int, ep: int) -> tuple:
    from repro_torch.core.pipeline_moe import capacity_for
    m = cfg.moe
    cap = capacity_for(chunk_tokens, m.top_k, m.capacity_factor,
                       m.num_experts)
    return (m.num_experts // ep, ep * cap, cfg.d_model)


def ffn_cases(rehearse: bool = False) -> dict:
    """What this phase gives the expert FFN on each rank: case -> (input
    shape, H, gated, activation, calls a step or a backward). The
    training chunk at (2, 2): a rank's dp rows, its half of the sequence,
    one of n chunks, ``[32, 2·cap, 768]``, fp32 (NONE: one call a chunk
    and MoE layer); the trace's chunk at (1, 2) in bf16 (S4 recomputes
    it)."""
    cfg = config(rehearse)
    b, s = BATCH[rehearse]
    dp, ep = STATE_MESH
    n = cfg.moe.num_partitions
    t = trace_config(rehearse, "s4", True)
    tb, ts = TRACE_TOKENS[rehearse]
    return {
        "ep_state_train": (_ffn_input(cfg, b // dp * s // ep // n, ep),
                           cfg.moe.d_expert, cfg.gated_ffn, cfg.ffn_act,
                           _moe_layers(cfg) * n),
        "ep_state_trace": (_ffn_input(t, tb * ts // TRACE_MESH[1] // TRACE_N,
                                      TRACE_MESH[1]),
                           t.moe.d_expert, t.gated_ffn, t.ffn_act, TRACE_N)}


def reckoned_rank_bytes(cfg, mesh) -> int:
    """A rank's optimizer state bytes, reckoned from the parameter shapes
    of the JAX tree (period leaves stacked), as phase 15's
    ``reckoned_state_bytes`` for one device, with each expert leaf's
    parts (``convert.leaf_cut``) divided: its experts over ep and, a
    ZeRO-3 shard, its columns over dp; an 8-bit row scale and Adafactor's
    ``vr`` span the columns, so only the experts are divided there."""
    from repro_torch.models import lm
    from repro_torch.optim.groups import groups
    dp, ep = mesh
    z3 = dp > 1 and ep > 1 and cfg.moe.d_expert % dp == 0 \
        and cfg.d_model % dp == 0
    total = 0
    for g in groups(lm.specs_tree(cfg)):
        shape = tuple(g.leaves[0].shape)
        if g.stacked:
            shape = (len(g.leaves),) + shape
        expert = "experts" in g.path
        rows = math.prod(shape[:-1]) // (ep if expert else 1)
        cols = shape[-1] // (dp if expert and z3 else 1)
        n = rows * cols
        if len(shape) < 2:
            total += 8 * n if cfg.optimizer != "adafactor" else 4 * n
        elif cfg.optimizer == "adamw8bit":
            total += 2 * (n + 4 * rows)
        else:
            vc = math.prod(shape[:-2]) // (ep if expert else 1) * cols
            total += 4 * (rows + vc)
    return total


def _opt_bytes(state) -> int:
    from repro_torch.ckpt.checkpoint import _items
    return sum(v.numel() * v.element_size() for _, v in _items(state["opt"])
               if hasattr(v, "numel"))


def _flat(state) -> dict:
    from repro_torch.ckpt.checkpoint import _items
    return dict(_items(state))


def _compare(torch, got: dict, want: dict, exact: bool) -> dict:
    """Leaves that differ (bit for bit, or past rtol of each leaf's
    largest magnitude) and the worst relative difference."""
    if got.keys() != want.keys():
        raise AssertionError(f"state keys differ: {sorted(got.keys() ^ want.keys())[:5]}")
    bad, worst = [], 0.0
    for k, w in want.items():
        g = got[k]
        if not isinstance(w, torch.Tensor):
            if g != w:
                bad.append(k)
            continue
        g, w = g.detach(), w.detach()
        if exact:
            if not torch.equal(g, w):
                bad.append(k)
            continue
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = float((g.double() - w.double()).abs().max()) if w.numel() else 0
        rel = err / scale if scale else err
        worst = max(worst, rel)
        if rel > ADAFACTOR_RTOL:
            bad.append(k)
    return {"leaves": len(want), "differ": bad[:5], "n_differ": len(bad),
            "worst_rel": worst}


def _batch(torch, cfg, rehearse, ctx):
    import numpy as np
    from repro_torch.runtime.train_loop import _rows
    b, s = BATCH[rehearse]
    rng = np.random.default_rng(0)
    whole = {k: rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int64)
             for k in ("tokens", "labels")}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(ctx.device)
            for k, v in _rows(whole, ctx).items()}


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def optim_check(torch, ctx, rehearse: bool, where: str) -> dict:
    """2 steps of each optimizer from the same init and batch, against
    the one-device optimizer fed the gathered gradients (rank 0). The
    ``adafactor`` run also checkpoints under ``where`` after its first
    step (``ckpt``): a fresh (2, 2) state restored from it and stepped
    again must equal the run's second step bit for bit, and rank 0
    restores it onto one device against the gathered step-1 state."""
    import torch.distributed as dist
    from repro_torch.ckpt import Checkpointer
    from repro_torch.convert import gather_params, gather_state
    from repro_torch.kernels import build
    from repro_torch.models.module import leaves, unflatten
    from repro_torch.optim import get_optimizer, lr_schedule
    from repro_torch.runtime.train_loop import (TrainOptions, _step_parts,
                                                init_state, state_layout)
    out = {}
    for name in OPTIMIZERS:
        cfg = config(rehearse, name)
        opts = TrainOptions(lr=1e-3, warmup=1, total_steps=10)
        batch = _batch(torch, cfg, rehearse, ctx)
        state = init_state(cfg, opts, seed=0, dist=ctx)
        state["step"] = 1
        grads_of, update = _step_parts(cfg, opts, ctx)
        ck = Checkpointer(where) if name == CKPT_OPTIMIZER else None
        layout = state_layout(cfg, ctx)
        whole_grads, calls = [], 0
        _sync(torch, ctx.device)
        build.reset_launches()
        t0 = time.perf_counter()
        with _ShapeLog() as shapes:
            for step in range(2):
                grads, metrics = grads_of(state["params"], batch)
                calls += 1
                g = leaves(gather_params(unflatten(state["params"], grads),
                                         cfg, ctx))
                whole_grads.append(g if ctx.rank == 0 else None)
                state, _ = update(state, grads, metrics)
                del grads, g
                if ck is not None and step == 0:
                    ck.save(state["step"], state, block=True,
                            shardings=layout)
                    saved = {k: v.clone() if hasattr(v, "clone") else v
                             for k, v in _flat(gather_state(
                                 state, cfg, ctx)).items()}
            if ck is not None:      # a new state from the checkpoint
                resumed = ck.restore(2, like=init_state(
                    cfg, opts, seed=1, dist=ctx), shardings=layout)
                g2, m2 = grads_of(resumed["params"], batch)
                calls += 1
                resumed, _ = update(resumed, g2, m2)
                del g2
        _sync(torch, ctx.device)
        row = {"optimizer": name, "ep_ms": (time.perf_counter() - t0) * 1e3,
               "launches": dict(build.LAUNCHES),
               "ffn_shapes": dict(shapes.shapes), "calls": calls,
               "state_bytes": _opt_bytes(state),
               "reckoned_bytes": reckoned_rank_bytes(cfg, STATE_MESH)}
        if ck is not None:
            shard = os.path.join(where, "step_0000000002",
                                 f"shard_{ctx.rank}.npz")
            row["ckpt"] = {
                "save_blocking_ms": ck.last_copy_s * 1e3,
                "save_bytes": ck.last_bytes,
                "file_bytes": os.path.getsize(shard),
                "writer_s": ck.last_write_s,
                # each rank's own part, bit for bit (no gather needed)
                "resume_vs_uninterrupted": _compare(
                    torch, _flat(resumed), _flat(state), exact=True)}
            del resumed
        got = _flat(gather_state(state, cfg, ctx))
        del state
        if ctx.rank == 0:
            ref = init_state(cfg, opts, seed=0, device=ctx.device)
            ref["step"] = 1
            opt_mod, ocfg = get_optimizer(name, opts.lr)
            for g in whole_grads:
                params = ref["params"]
                ref["opt"] = opt_mod.update(
                    unflatten(params, g), ref["opt"], params, ocfg,
                    lr_scale=lr_schedule(ref["step"], warmup=1, total=10))
                ref["step"] += 1
            _sync(torch, ctx.device)
            row["vs_one_rank"] = _compare(torch, got, _flat(ref),
                                          exact=name == "adamw8bit")
            row["whole_state_bytes"] = _opt_bytes(ref)
            del ref
            if ck is not None:
                t0 = time.perf_counter()
                one = ck.restore(2, like=init_state(cfg, opts, seed=1,
                                                    device=ctx.device))
                _sync(torch, ctx.device)
                row["ckpt"]["restore_one_rank_s"] = time.perf_counter() - t0
                row["ckpt"]["restore_one_rank"] = _compare(
                    torch, _flat(one), saved, exact=True)
                del one
        if ck is not None:
            del saved
        del got, whole_grads
        dist.barrier()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        out[name] = row
    return out


def backward_verdict(ev, issued: list, ffn: list) -> dict:
    """One backward pass's All-to-Alls against its expert FFN calls. From
    profiler events ``(name, start_us, end_us, device_type, thread)``: an
    All-to-All is in flight from its issue (c10d's ``alltoall_base_``) to
    the end of its work on gloo's worker thread (the k-th such event is
    the k-th issued: gloo runs them in order). ``ffn``: ``(chunk, pass,
    host enqueue, device start, device end)`` a call (``_FfnClock``), on
    the profiler's clock. A call counts for an All-to-All if the host
    enqueued it after the issue (so it did not produce the All-to-All's
    input), it belongs to another chunk, and its device span meets the
    flight. ``issued``: ``(chunk, unit)`` of each collective in issue
    order under the overlapped schedule; empty for the serial one, whose
    chunks the verdict does not know."""
    cpu = [e for e in ev if "CUDA" not in e[3]]
    issues = sorted((e for e in cpu if e[0] == "c10d::alltoall_base_"),
                    key=lambda e: e[1])
    main = issues[0][4] if issues else None
    work = sorted((e for e in cpu if e[0] == "gloo:all_to_all"
                   and e[4] != main), key=lambda e: e[1])
    clock = "gloo worker" if len(work) == len(issues) else "issue call"
    ends = ([max(i[2], w[2]) for i, w in zip(issues, work)]
            if clock == "gloo worker" else [i[2] for i in issues])
    rows, pairs = [], collections.defaultdict(float)
    for i, issue in enumerate(issues):
        k = issued[i][0] if issued and i < len(issued) else None
        t0, t1 = issue[1], ends[i]
        over = [(f[0], f[1], min(t1, f[4]) - max(t0, f[3])) for f in ffn
                if f[2] > t0 and (k is None or f[0] != k)]
        over = [o for o in over if o[2] > 0]
        rows.append({"a2a": i, "chunk": k,
                     "issued_by": issued[i][1] if issued else None,
                     "us": round(t1 - t0, 1),
                     "spans_ffn": [[o[0], o[1], round(o[2], 1)]
                                   for o in over]})
        for o in over:
            pairs[f"{k}->{o[0]}"] += o[2]
    return {"a2a_issued": len(issues), "a2a_clock": clock,
            "ffn_calls": len(ffn), "a2a": rows,
            "pairs_us": {k: round(v, 1) for k, v in pairs.items()},
            "overlapped": sum(1 for r in rows if r["spans_ffn"])}


class _FfnClock:
    """While on, each expert FFN call's (chunk, pass, host time, device
    start, device end): CUDA events around the call on the card (host
    times on the CPU), and under the overlapped schedule the chunk of
    the ``Rf`` / ``Fb`` unit that makes it. ``align()`` (inside the
    profile, before the pass) ties the two clocks to the profiler's:
    ``spans(events)`` reads its range and returns the calls in profiler
    microseconds."""

    def __init__(self, torch):
        from repro_torch.core import pipeline_moe
        from repro_torch.kernels.grouped_ffn import ops
        self.torch, self.ops, self.pm = torch, ops, pipeline_moe
        self.cuda = torch.cuda.is_available()
        self.calls, self.chunk, self.on = [], None, False

    def _timed(self, fn, tag):
        torch = self.torch

        def run(ctx, *a):
            if not self.on:
                return fn(ctx, *a)
            host = time.perf_counter()
            if self.cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(ctx, *a)
                e1.record()
            else:
                out = fn(ctx, *a)
                e0, e1 = host, time.perf_counter()
            self.calls.append((self.chunk, tag, host, e0, e1))
            return out
        return staticmethod(run)

    def _unit(self, fn):
        def run(layer, k):
            self.chunk = k
            try:
                return fn(layer, k)
            finally:
                self.chunk = None
        return run

    def __enter__(self):
        g, o = self.ops._GroupedFFN, self.pm._Overlap
        self.saved = (g.forward, g.backward, o._Rf, o._Fb)
        g.forward = self._timed(g.forward, "F")
        g.backward = self._timed(g.backward, "B")
        o._Rf, o._Fb = self._unit(o._Rf), self._unit(o._Fb)
        return self

    def __exit__(self, *exc):
        g, o = self.ops._GroupedFFN, self.pm._Overlap
        g.forward, g.backward = (staticmethod(self.saved[0]),
                                 staticmethod(self.saved[1]))
        o._Rf, o._Fb = self.saved[2], self.saved[3]
        return False

    def align(self):
        from torch.profiler import record_function
        torch = self.torch
        if self.cuda:
            torch.cuda.synchronize()
        with record_function("ep_state_align"):
            if self.cuda:
                self.e0 = torch.cuda.Event(enable_timing=True)
                self.e0.record()
                torch.cuda.synchronize()
            self.t0 = time.perf_counter()

    def spans(self, ev) -> list:
        anchor = next(e[2] for e in ev if e[0] == "ep_state_align"
                      and "CUDA" not in e[3])
        host = lambda t: anchor + (t - self.t0) * 1e6  # noqa: E731
        out = []
        for chunk, tag, t, a, b in self.calls:
            if self.cuda:
                a = anchor + self.e0.elapsed_time(a) * 1e3
                b = anchor + self.e0.elapsed_time(b) * 1e3
            else:
                a, b = host(a), host(b)
            out.append((chunk, tag, host(t), a, b))
        return out


def trace_check(torch, ctx, rehearse: bool) -> dict:
    """Rank 0's profile of one MoE layer's backward pass under each
    strategy and schedule (both ranks run it; rank 0 records)."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.convert import shard_tree
    from repro_torch.core.pipeline_moe import backward_order
    from repro_torch.core.types import Strategy
    from repro_torch.kernels import build
    from repro_torch.models.module import build as build_tree
    from repro_torch.models.module import leaves
    from repro_torch.moe import layer as moe_layer
    dev = ctx.device
    b, s = TRACE_TOKENS[rehearse]
    out = {"runs": []}
    launches = collections.Counter()
    for strategy in ("none", "s4"):
        for unroll in (True, False):
            cfg = trace_config(rehearse, strategy, unroll)
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            params = build_tree(moe_layer.specs(cfg), gen, dev)
            params = shard_tree({"moe": params}, cfg, ctx)["moe"]
            for p in leaves(params):
                p.requires_grad_(True)
            dt = torch.float32 if rehearse else torch.bfloat16
            x = torch.randn((b, s, cfg.d_model), generator=gen,
                            device=dev).to(dt).requires_grad_(True)

            def forward():
                y, aux = moe_layer.apply(params, x, cfg=cfg, mode="train",
                                         dist=ctx)
                return (y.float() ** 2).mean() + aux["aux_loss"] \
                    + aux["z_loss"]

            torch.autograd.grad(forward(), [x] + leaves(params))  # warm-up
            _sync(torch, dev)
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            build.reset_launches()
            with _ShapeLog() as shapes, _FfnClock(torch) as clock:
                loss = forward()
                _sync(torch, dev)
                base = (torch.cuda.memory_allocated()
                        if dev.type == "cuda" else 0)
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                with profile(activities=acts) as prof:
                    dist.barrier()
                    clock.align()
                    clock.on = True
                    t0 = time.perf_counter()
                    grads = torch.autograd.grad(loss, [x] + leaves(params))
                    _sync(torch, dev)
                    ms = (time.perf_counter() - t0) * 1e3
                    clock.on = False
            launches.update(build.LAUNCHES)
            peak = (torch.cuda.max_memory_allocated() - base
                    if dev.type == "cuda" else None)
            del grads, loss
            row = {"strategy": strategy, "unroll": unroll,
                   "backward_ms": ms, "peak_above_start": peak,
                   "ffn_shapes": dict(shapes.shapes),
                   "launches": dict(build.LAUNCHES)}
            if ctx.rank == 0:
                st = Strategy(strategy)
                issuers = {"Cb", "RcCb", "Fb", "Rd", "Rf"}
                if "t_di" in st.offloads:
                    issuers.discard("Rd")
                issued = ([(k, u) for u, k in backward_order(TRACE_N, st)
                           if u in issuers] if unroll else [])
                ev = [(e.name, e.time_range.start, e.time_range.end,
                       str(e.device_type), e.thread)
                      for e in prof.events()]
                row["verdict"] = backward_verdict(ev, issued,
                                                  clock.spans(ev))
            out["runs"].append(row)
            del params, x
            dist.barrier()
    out["launches"] = dict(launches)
    return out


def _rank_main(rank, mesh, port, parts, rehearse, where, queue):
    try:
        import torch
        import torch.distributed as dist
        from repro_torch.distributed import make_context
        torch.set_num_threads(2)
        if rehearse:
            dev = torch.device("cpu")
        else:
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            dev = torch.device("cuda", 0)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=mesh[0] * mesh[1],
            timeout=datetime.timedelta(seconds=TIMEOUT))
        ctx = make_context(*mesh, dev)
        out = {}
        for part, fn in (("optim", lambda t, c, r: optim_check(t, c, r,
                                                               where)),
                         ("trace", trace_check)):
            if part in parts:
                t0 = time.perf_counter()
                out[part] = fn(torch, ctx, rehearse)
                out[part + "_s"] = time.perf_counter() - t0
        queue.put((rank, "ok", out))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:                           # reported to the parent
        queue.put((rank, "error", traceback.format_exc()))
        raise


def run_ranks(mesh, parts, rehearse: bool, where: str = "") -> list:
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, mesh, port, parts, rehearse, where, queue))
             for r in range(mesh[0] * mesh[1])]
    for p in procs:
        p.start()
    results = [None] * len(procs)
    try:
        for _ in procs:
            rank, status, out = queue.get(timeout=TIMEOUT)
            if status != "ok":
                raise AssertionError(f"ep-state rank {rank} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return results


def _check_state(row: dict, tag: str) -> None:
    if row["state_bytes"] != row["reckoned_bytes"]:
        raise AssertionError(f"{tag}: a rank's state {row['state_bytes']} B "
                             f"against the reckoned {row['reckoned_bytes']}")


def stage_bytes(rehearse: bool) -> int:
    """One trace chunk's stage buffers: ``T_DI``, the FFN input and its
    output, each ``[e_local, ep·cap, M]`` in the compute dtype."""
    (e, c, m), *_ = ffn_cases(rehearse)["ep_state_trace"]
    return 3 * e * c * m * (4 if rehearse else 2)


def _optim_lines(ranks, rehearse: bool, launches) -> None:
    shape, _, _, _, calls = ffn_cases(rehearse)["ep_state_train"]
    for name in OPTIMIZERS:
        row = dict(ranks[0]["optim"][name], ranks=[
            {k: r["optim"][name][k] for k in
             ("state_bytes", "reckoned_bytes", "ep_ms")} for r in ranks])
        ck = row.pop("ckpt", None)
        log("ep-optim " + json.dumps(row))
        if row["vs_one_rank"]["n_differ"]:
            raise AssertionError(f"ep-optim {name}: {row['vs_one_rank']}")
        for r in ranks:
            _check_state(r["optim"][name], f"ep-optim {name}")
            _check_calls(f"ep-optim {name}", r["optim"][name],
                         {shape: r["optim"][name]["calls"] * calls},
                         rehearse)
            launches.update(r["optim"][name]["launches"])
        if ck is None:
            continue
        ck["ranks"] = [{k: r["optim"][name]["ckpt"][k] for k in (
            "save_blocking_ms", "save_bytes", "file_bytes", "writer_s")}
            for r in ranks]
        log("ep-ckpt " + json.dumps(dict(ck, optimizer=name)))
        if (any(r["optim"][name]["ckpt"]["resume_vs_uninterrupted"][
                "n_differ"] for r in ranks)
                or ck["restore_one_rank"]["n_differ"]):
            raise AssertionError("ep-ckpt: not bit-equal")


def _trace_lines(ranks, rehearse: bool, launches) -> None:
    shape, *_ = ffn_cases(rehearse)["ep_state_trace"]
    runs = ranks[0]["trace"]["runs"]
    for row, other in zip(runs, ranks[1]["trace"]["runs"]):
        log("ep-trace-bwd " + json.dumps(dict(
            row, rank1_backward_ms=other["backward_ms"])))
        want = {shape: TRACE_N * (2 if row["strategy"] == "s4" else 1)}
        for r in (row, other):
            _check_calls("ep-trace-bwd", r, want, rehearse)
    for r in ranks:
        launches.update(r["trace"]["launches"])
    summary = {}
    for strategy in ("none", "s4"):
        o, s = [r for r in runs if r["strategy"] == strategy]
        over = o["verdict"]["overlapped"]
        extra = (None if o["peak_above_start"] is None else
                 o["peak_above_start"] - s["peak_above_start"])
        summary[strategy] = {
            "a2a_spanning_another_chunks_ffn": over,
            "serial_a2a_spanning_an_ffn": s["verdict"]["overlapped"],
            "backward_ms": [o["backward_ms"], s["backward_ms"]],
            "peak_extra_bytes": extra,
            "stage_bytes": stage_bytes(rehearse)}
        # on the CPU (a rehearsal) the FFN takes microseconds and the
        # overlap is left to chance: the card's verdict counts
        if (not rehearse and over < 1) or (
                extra is not None and extra > stage_bytes(rehearse)):
            raise AssertionError(f"ep-trace-bwd {strategy}: "
                                 f"{summary[strategy]}")
    log("ep-trace-bwd-summary " + json.dumps(summary))


def ep_state_phase(parts=PARTS, rehearse: bool = False
                   ) -> collections.Counter:
    """Runs the named parts (the trace's two ranks beside the optimizer
    runs' four), logs their lines, raises on a failed check; returns the
    checked runs' kernel launches, summed over ranks."""
    from concurrent.futures import ThreadPoolExecutor
    launches = collections.Counter()
    where = tempfile.mkdtemp(prefix="ep_state_ckpt_")
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(2) as pool:
            optim = (pool.submit(run_ranks, STATE_MESH, ["optim"], rehearse,
                                 where) if "optim" in parts else None)
            trace = (pool.submit(run_ranks, TRACE_MESH, ["trace"], rehearse)
                     if "trace" in parts else None)
            optim = optim.result() if optim else None
            trace = trace.result() if trace else None
    finally:
        shutil.rmtree(where, ignore_errors=True)
    log(f"ep-state-ranks {time.perf_counter() - t0:.1f} s")
    if optim:
        _optim_lines(optim, rehearse, launches)
    if trace:
        _trace_lines(trace, rehearse, launches)
    log("ep-state-seconds " + json.dumps(
        {k: round(v, 1) for r in (optim or [])[:1] + (trace or [])[:1]
         for k, v in r.items() if k.endswith("_s")}))
    return launches


def main(argv) -> int:
    rehearse = "--rehearse" in argv
    argv = [a for a in argv if a != "--rehearse"]
    parts = argv[0].split(",") if argv else list(PARTS)
    if any(p not in PARTS for p in parts):
        print(f"ep_state_phase: parts are {','.join(PARTS)}",
              file=sys.stderr)
        return 2
    import torch
    if not rehearse:
        if not torch.cuda.is_available():
            print("ep_state_phase: no CUDA device", file=sys.stderr)
            return 2
        from repro_torch.kernels import build
        log(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip())
        t0 = time.perf_counter()
        log(f"build {build.build()} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    launches = ep_state_phase(parts, rehearse)
    log(f"launches {dict(launches)} ({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
