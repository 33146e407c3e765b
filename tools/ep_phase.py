#!/usr/bin/env python3
"""Expert parallelism on the card: ``chip_smoke.py``'s phase 18, and
runnable alone.

    python3 tools/ep_phase.py [probe,train,decode,launcher,trace]
    python3 tools/ep_phase.py --rehearse     # CPU, reduced configs

One H100 cannot host two NCCL ranks (NCCL refuses two ranks of one
device), so the expert-parallel paths run as two gloo processes that
share ``cuda:0`` (mesh (1, 2)); gloo stages every collective through
host memory. The parts:

* ``probe``: which of ``all_to_all_single``, ``all_gather_into_tensor``,
  ``reduce_scatter_tensor`` and ``all_reduce`` gloo runs on CUDA tensors
  between the two processes (an ``ep-probe`` line);
* ``train``: full-width moe-gpt3-s (d 768, 64 experts, 32 a rank, H
  3072) at 4 layers in fp32, capacity factor 8.0 (no route drops), n =
  2, 2 x 256 tokens, under NONE and S4: each rank's loss and gathered
  gradients against a one-rank run of the same batch on the card
  (``ep-train`` lines). The
  Switch aux loss is off (weight 0) here: under expert parallelism it is
  the mean of the ranks' own ``E·Σ f·p`` (as in the JAX package), not
  the one-rank value; the CPU tests hold it to JAX. Tolerances: the loss
  within 1e-5 relative, each gradient leaf within 1e-4 of its largest
  magnitude;
* ``decode``: DeepSeek-V2-Lite at full width, 2 layers, fp32, capacity
  factor 8.0, through ``lm.prefill`` (the sharded layout) and 4 greedy
  ``lm.decode_step``s (the replicated one) with ``dist``, against the
  one-rank run: greedy tokens equal, logits within 1e-4 of their largest
  magnitude; the expert FFN's launches by input shape (``ep-decode``);
* ``launcher``: ``python -m torch.distributed.run --nproc-per-node 1 -m
  repro_torch.launch.train --mesh-model 1`` for 2 steps on NCCL, saving
  a checkpoint each step under a temporary directory (``ep-launcher``);
* ``trace``: a ``torch.profiler`` trace of rank 0's MoE forward (one
  moe-gpt3-s layer, bf16, 2 x 1024 tokens a rank, n = 4, the overlapped
  schedule): whether chunk i+1's dispatch All-to-All overlaps chunk i's
  ``grouped_ffn`` kernels in time (``ep-trace``). It checks the
  schedule only: through gloo's host staging it shows neither the
  paper's speed nor its μ.

Every check outside its tolerance ends the run non-zero. Each rank's
train and decode paths must give the expert FFN exactly the inputs of
``ffn_cases`` (shape and calls: one a chunk and MoE layer, twice under
S4's recompute) and, on the card, launch the router and expert-FFN
kernels once a call each (``build.LAUNCHES``, reset just before each
path and read just after); those launches are returned to the caller.
Prints the card's name and power limit first; needs one CUDA card
unless ``--rehearse``.
"""
import collections
import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PARTS = ("probe", "train", "decode", "launcher", "trace")
MESH = (1, 2)
TIMEOUT = 600.0
# the global batches: training (B, S); decode (B, prompt length, steps)
TRAIN_BS = {False: (2, 256), True: (4, 32)}          # keyed by rehearse
DECODE_BSN = {False: (4, 64, 4), True: (2, 16, 4)}


def log(msg: str) -> None:
    print(msg, flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# rank bodies (two gloo processes on one device)
# ---------------------------------------------------------------------------

def probe(torch, dist, dev) -> dict:
    x = torch.arange(4, dtype=torch.float32, device=dev) + dist.get_rank()
    ops = {
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            x.new_empty(8), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            x.new_empty(2), x),
        "all_reduce": lambda: dist.all_reduce(x.clone()),
    }
    out = {}
    for name, fn in ops.items():
        try:
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out[name] = "ok"
        except RuntimeError as e:       # gloo's "not supported" errors
            out[name] = f"{type(e).__name__}: {str(e)[:200]}"
    return out


def _leaf_errors(torch, got, want) -> float:
    """The largest, over leaves, of max|got - want| / max|want|."""
    worst = 0.0
    for a, b in zip(got, want):
        scale = float(b.abs().max()) or 1.0
        err = float((a.float() - b.float()).abs().max())
        worst = max(worst, err / scale)
    return worst


def train_config(rehearse: bool, strategy: str):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("moe-gpt3-s")
    cfg = cfg.reduced() if rehearse else dataclasses.replace(cfg,
                                                             num_layers=4)
    return dataclasses.replace(
        cfg, compute_dtype="float32", param_dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=8.0,
                                num_partitions=2, aux_loss_weight=0.0,
                                memory_reuse_strategy=strategy))


def train_check(torch, ctx, rehearse: bool) -> dict:
    import numpy as np
    import torch.distributed as dist
    from repro_torch.convert import gather_params, shard_tree
    from repro_torch.kernels import build
    from repro_torch.models import lm
    from repro_torch.models.module import leaves, unflatten
    from repro_torch.runtime.train_loop import TrainOptions, _step_parts
    dev = ctx.device
    b, s = TRAIN_BS[rehearse]
    out = {}
    for strategy in ("none", "s4"):
        cfg = train_config(rehearse, strategy)
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, s), dtype=np.int64)).to(dev)
            for k in ("tokens", "labels")}
        full = lm.init(cfg, 0, device=dev)
        params = shard_tree(full, cfg, ctx)
        for p in leaves(params):
            p.requires_grad_(True)
        if ctx.rank != 0:
            del full
        grads_of, _ = _step_parts(cfg, TrainOptions(), ctx)
        grads_of(params, batch)                          # warm-up
        _sync(torch, dev)
        build.reset_launches()
        t0 = time.perf_counter()
        with _ShapeLog() as shapes:
            grads, metrics = grads_of(params, batch)
            _sync(torch, dev)
        ep_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(build.LAUNCHES)
        whole = leaves(gather_params(unflatten(params, grads), cfg, ctx))
        del grads, params
        row = {"strategy": strategy, "loss": float(metrics["loss"]),
               "ep_ms": ep_ms, "launches": launches,
               "ffn_shapes": dict(shapes.shapes)}
        if ctx.rank == 0:
            flat = [p.requires_grad_(True) for p in leaves(full)]
            loss, m = lm.loss_fn(full, batch, cfg)
            ref = torch.autograd.grad(loss, flat, allow_unused=True)
            ref = [torch.zeros_like(p) if g is None else g
                   for p, g in zip(flat, ref)]
            row.update(ref_loss=float(m["loss"]),
                       loss_rel_err=abs(row["loss"] - float(m["loss"]))
                       / abs(float(m["loss"])),
                       grad_rel_err=_leaf_errors(torch, whole, ref),
                       leaves=len(ref))
            del ref, loss, m, flat, full
        del whole
        dist.barrier()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out[strategy] = row
    return out


def _moe_layers(cfg) -> int:
    return cfg.num_periods * sum(r["moe"] for r in cfg.layer_roles())


def _ffn_input(cfg, chunk_tokens: int, sources: int, cf: float) -> tuple:
    """The expert FFN's input on one rank: ``[E / ep, sources·cap, M]``."""
    from repro_torch.core.pipeline_moe import capacity_for
    m = cfg.moe
    cap = capacity_for(chunk_tokens, m.top_k, cf, m.num_experts)
    return (m.num_experts // MESH[1], sources * cap, cfg.d_model)


def ffn_cases(rehearse: bool = False) -> dict:
    """What the EP paths give the expert FFN on each rank: case ->
    (input shape, H, gated, activation, calls a path), the calls per
    strategy for training (S4 recomputes every chunk). Training's chunk
    after the dispatch All-to-All: ``[32, 2·cap, 768]``; DeepSeek's
    prefill chunk ``[32, 2·cap, 2048]`` and its replicated decode
    ``[32, cap, 2048]`` (capacity factor at least 2 there)."""
    ep = MESH[1]
    t = train_config(rehearse, "none")
    b, s = TRAIN_BS[rehearse]
    n = t.moe.num_partitions
    tl = _moe_layers(t) * n
    d = decode_config(rehearse)
    db, ds, steps = DECODE_BSN[rehearse]
    dn = d.moe.num_partitions
    act = (t.ffn_act, d.ffn_act)
    return {
        "ep_train": (_ffn_input(t, b * s // ep // n, ep,
                                t.moe.capacity_factor),
                     t.moe.d_expert, t.gated_ffn, act[0],
                     {"none": tl, "s4": 2 * tl}),
        "ep_prefill": (_ffn_input(d, db * ds // ep // dn, ep,
                                  d.moe.capacity_factor),
                       d.moe.d_expert, d.gated_ffn, act[1],
                       _moe_layers(d) * dn),
        "ep_decode": (_ffn_input(d, db, 1, max(d.moe.capacity_factor, 2.0)),
                      d.moe.d_expert, d.gated_ffn, act[1],
                      _moe_layers(d) * steps)}


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def decode_config(rehearse: bool):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v2-lite-16b")
    cfg = cfg.reduced() if rehearse else dataclasses.replace(cfg,
                                                             num_layers=2)
    return dataclasses.replace(
        cfg, compute_dtype="float32", param_dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=8.0,
                                num_partitions=2))


class _ShapeLog:
    """Counts ``moe.experts.apply_grouped``'s input shapes while on."""

    def __init__(self):
        from repro_torch.moe import experts
        self.mod, self.fn = experts, experts.apply_grouped
        self.shapes = collections.Counter()

    def __enter__(self):
        def logged(params, x, cfg):
            self.shapes[str(list(x.shape))] += 1
            return self.fn(params, x, cfg)
        self.mod.apply_grouped = logged
        return self

    def __exit__(self, *exc):
        self.mod.apply_grouped = self.fn
        return False


def _greedy(torch, lm, params, prompts, cfg, steps, dist=None):
    logits, cache = lm.prefill(params, prompts, cfg, prompts.shape[1] + steps,
                               dtype=torch.float32, dist=dist)
    outs, toks = [logits], []
    last = logits[:, -1]
    for _ in range(steps):
        tok = last.argmax(-1, keepdim=True).int()
        toks.append(tok)
        last, cache = lm.decode_step(params, cache, tok, cfg, dist=dist)
        outs.append(last)
    return outs, torch.cat(toks, dim=1)


def decode_check(torch, ctx, rehearse: bool) -> dict:
    with torch.no_grad():
        return _decode_check(torch, ctx, rehearse)


def _decode_check(torch, ctx, rehearse: bool) -> dict:
    import numpy as np
    import torch.distributed as dist
    from repro_torch.convert import shard_tree
    from repro_torch.kernels import build
    from repro_torch.models import lm
    dev = ctx.device
    cfg = decode_config(rehearse)
    b, s, steps = DECODE_BSN[rehearse]
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s), dtype=np.int64)).to(dev).int()
    full = lm.init(cfg, 0, device=dev)
    params = shard_tree(full, cfg, ctx, mode="prefill")
    if ctx.rank != 0:
        del full
    build.reset_launches()
    t0 = time.perf_counter()
    with _ShapeLog() as shapes:
        outs, toks = _greedy(torch, lm, params, prompts, cfg, steps, ctx)
    _sync(torch, dev)
    row = {"ep_ms": (time.perf_counter() - t0) * 1e3,
           "launches": dict(build.LAUNCHES),
           "ffn_shapes": dict(shapes.shapes), "tokens": toks.tolist()}
    del params
    if ctx.rank == 0:
        ref, ref_toks = _greedy(torch, lm, full, prompts, cfg, steps)
        row.update(tokens_equal=bool(torch.equal(toks, ref_toks)),
                   logits_rel_err=max(
                       float((a - r).abs().max()) / float(r.abs().max())
                       for a, r in zip(outs, ref)))
        del ref, full
    dist.barrier()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


def trace_check(torch, ctx, rehearse: bool) -> dict:
    """Rank 0's profile of one MoE layer's forward under the overlapped
    schedule: the All-to-All events and the ``grouped_ffn`` kernels in
    time, and whether each chunk i+1's dispatch overlaps chunk i's FFN."""
    import dataclasses

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_tree
    from repro_torch.models.module import build as build_tree
    from repro_torch.moe import layer as moe_layer
    dev = ctx.device
    cfg = get_config("moe-gpt3-s")
    if rehearse:
        cfg = cfg.reduced()
    n = 4
    cfg = dataclasses.replace(cfg, compute_dtype="float32" if rehearse
                              else "bfloat16", moe=dataclasses.replace(
                                  cfg.moe, num_partitions=n,
                                  pipeline_unroll=True))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = build_tree(moe_layer.specs(cfg), gen, dev)
    params = shard_tree({"moe": params}, cfg, ctx,
                        mode="prefill")["moe"]
    dt = torch.float32 if rehearse else torch.bfloat16
    b, s = (2, 32) if rehearse else (2, 2048)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev).to(dt)

    def fwd():
        with torch.no_grad():
            moe_layer.apply(params, x, cfg=cfg, mode="prefill", dist=ctx)
        _sync(torch, dev)

    for _ in range(2):
        fwd()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        dist.barrier()               # both ranks' profilers are running
        fwd()
    if ctx.rank != 0:
        return {}
    ev = [(e.name, e.time_range.start, e.time_range.end,
           str(e.device_type), e.thread) for e in prof.events()]
    out = overlap_verdict(ev, n)
    t0 = min(e[1] for e in ev)
    out["raw"] = [[e[0][:48], e[4], round(e[1] - t0), round(e[2] - t0)]
                  for e in sorted(ev, key=lambda e: e[1])
                  if "all_to_all" in e[0].lower()
                  or "alltoall" in e[0].lower()
                  or ("grouped_ffn" in e[0] and "CUDA" in e[3])]
    return out


def overlap_verdict(ev, n: int) -> dict:
    """From profiler events ``(name, start_us, end_us, device_type,
    thread)``: for each All-to-All event family (by name, on the issuing
    thread or on gloo's worker threads) with 2n events, in issue order
    ``D0 D1 C0 D2 C1 ... C(n-1)``, the time chunk i+1's dispatch shares
    with chunk i's ``grouped_ffn`` kernels on the card. The issuing
    thread is the one that runs c10d's ``alltoall_base_`` (or the port's
    ``_AllToAll``)."""
    main = next((e[4] for e in ev
                 if e[0] in ("_AllToAll", "c10d::alltoall_base_")), None)
    a2a = collections.defaultdict(list)
    for name, t0, t1, kind, thread in ev:
        low = name.lower()
        if "all_to_all" in low or "alltoall" in low:
            where = "issuing" if thread == main else "workers"
            a2a[f"{name}@{where}"].append((t0, t1))
    ffn = sorted((t0, t1) for name, t0, t1, kind, _ in ev
                 if "grouped_ffn" in name and "CUDA" in kind
                 and "active" not in name)
    per = len(ffn) // n
    chunks = [(ffn[i * per][0], ffn[(i + 1) * per - 1][1])
              for i in range(n)] if per else []
    order = [0, 1] + [3 + 2 * i for i in range(n - 2)]
    verdicts = {}
    for name, spans in a2a.items():
        if len(spans) != 2 * n or not chunks:
            continue
        spans.sort()
        ov = [max(0.0, min(spans[order[i + 1]][1], chunks[i][1])
                  - max(spans[order[i + 1]][0], chunks[i][0]))
              for i in range(n - 1)]
        verdicts[name] = {
            "dispatch_us": [list(spans[order[i]]) for i in range(n)],
            "ffn_us": [list(c) for c in chunks], "overlap_us": ov,
            "overlaps": all(o > 0 for o in ov)}
    return {"a2a_events": {k: len(v) for k, v in a2a.items()},
            "ffn_kernels": len(ffn), "families": verdicts,
            "overlaps": any(v["overlaps"] for v in verdicts.values())}


def _rank_main(rank, port, parts, rehearse, queue):
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
            world_size=MESH[0] * MESH[1],
            timeout=datetime.timedelta(seconds=TIMEOUT))
        ctx = make_context(*MESH, dev)
        out = {}
        if "probe" in parts:
            out["probe"] = probe(torch, dist, dev)
        for part, fn in (("train", train_check), ("decode", decode_check),
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


def run_ranks(parts, rehearse: bool) -> list:
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, port, parts, rehearse, queue))
             for r in range(MESH[0] * MESH[1])]
    for p in procs:
        p.start()
    results = [None] * len(procs)
    try:
        for _ in procs:
            rank, status, out = queue.get(timeout=TIMEOUT)
            if status != "ok":
                raise AssertionError(f"ep rank {rank} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return results


def launcher_check(rehearse: bool) -> dict:
    """The train launcher under ``torch.distributed.run`` (one rank, NCCL
    on the card), saving a checkpoint every step under a temporary
    directory (its start-up is the cost; the saves come with it)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""), OMP_NUM_THREADS="1")
    where = tempfile.mkdtemp(prefix="ep_launcher_ckpt_")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           "1", "--master-port", str(_free_port()), "-m",
           "repro_torch.launch.train", "--mesh-model", "1", "--steps", "2",
           "--ckpt-dir", where, "--ckpt-every", "1"]
    if rehearse:
        cmd += ["--device", "cpu"]
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=300)
        saved = sorted(os.listdir(where))
    finally:
        shutil.rmtree(where, ignore_errors=True)
    if out.returncode != 0 or "final loss" not in out.stdout:
        raise AssertionError(f"launcher exited {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    backend = "gloo" if rehearse else "nccl"
    if f"backend={backend}" not in out.stdout:
        raise AssertionError(f"launcher ran without {backend}:\n"
                             f"{out.stdout[-2000:]}")
    if saved != ["step_0000000001", "step_0000000002"]:
        raise AssertionError(f"launcher saved {saved}")
    return {"backend": backend, "s": time.perf_counter() - t0,
            "saved": saved,
            "lines": [ln for ln in out.stdout.splitlines()
                      if ln.startswith(("mesh:", "final loss", "MPipeMoE"))]}


TRAIN_RTOL, GRAD_RTOL, LOGITS_RTOL = 1e-5, 1e-4, 1e-4


def _check_calls(what: str, row: dict, want: dict, rehearse: bool) -> None:
    """One rank's path gave the expert FFN exactly ``want`` (input shape
    -> calls: one a chunk and MoE layer, and again in each recompute),
    and on the card launched the router and the expert-FFN kernel once a
    call each."""
    shapes = {str(list(k)): v for k, v in want.items()}
    if row["ffn_shapes"] != shapes:
        raise AssertionError(f"{what}: expert FFN inputs "
                             f"{row['ffn_shapes']}, expected {shapes}")
    calls = sum(want.values())
    got = {k: row["launches"].get(k, 0)
           for k in ("topk_router", "grouped_ffn")}
    if not rehearse and got != {"topk_router": calls, "grouped_ffn": calls}:
        raise AssertionError(f"{what}: launched {got}, expected {calls} "
                             f"of each")


def ep_phase(parts=PARTS, rehearse: bool = False) -> collections.Counter:
    """Runs the named parts, logs their lines, raises on a failed check;
    returns the EP paths' kernel launches, summed over ranks."""
    launches = collections.Counter()
    cases = ffn_cases(rehearse)
    rank_parts = [p for p in parts if p != "launcher"]
    if rank_parts:
        t0 = time.perf_counter()
        ranks = run_ranks(rank_parts, rehearse)
        log(f"ep-ranks {len(ranks)} processes, {time.perf_counter() - t0:.1f}"
            f" s")
        if "probe" in parts:
            log("ep-probe " + json.dumps(ranks[0]["probe"]))
            missing = [k for k, v in ranks[0]["probe"].items() if v != "ok"]
            if missing:
                log(f"ep-probe: gloo lacks {missing} on this device")
        if "train" in parts:
            for strategy, row in ranks[0]["train"].items():
                for r in ranks:
                    launches.update(r["train"][strategy]["launches"])
                row = dict(row, losses=[r["train"][strategy]["loss"]
                                        for r in ranks])
                log("ep-train " + json.dumps(row))
                if not (row["loss_rel_err"] <= TRAIN_RTOL
                        and row["grad_rel_err"] <= GRAD_RTOL
                        and len(set(row["losses"])) == 1):
                    raise AssertionError(f"ep-train {strategy} outside its "
                                         f"tolerance")
                shape, *_, calls = cases["ep_train"]
                for r in ranks:
                    _check_calls("ep-train " + strategy, r["train"][strategy],
                                 {shape: calls[strategy]}, rehearse)
        if "decode" in parts:
            row = dict(ranks[0]["decode"], rank1_tokens_equal=(
                ranks[1]["decode"]["tokens"] == ranks[0]["decode"]["tokens"]))
            for r in ranks:
                launches.update(r["decode"]["launches"])
            log("ep-decode " + json.dumps(row))
            if not (row["tokens_equal"] and row["rank1_tokens_equal"]
                    and row["logits_rel_err"] <= LOGITS_RTOL):
                raise AssertionError("ep-decode outside its tolerance")
            want = {cases[k][0]: cases[k][-1]
                    for k in ("ep_prefill", "ep_decode")}
            for r in ranks:
                _check_calls("ep-decode", r["decode"], want, rehearse)
        if "trace" in parts:
            log("ep-trace " + json.dumps(ranks[0]["trace"]))
        log("ep-seconds " + json.dumps({k: round(v, 1) for k, v in
                                        ranks[0].items() if k.endswith("_s")}))
    if "launcher" in parts:
        log("ep-launcher " + json.dumps(launcher_check(rehearse)))
    return launches


def main(argv) -> int:
    rehearse = "--rehearse" in argv
    argv = [a for a in argv if a != "--rehearse"]
    parts = argv[0].split(",") if argv else list(PARTS)
    if any(p not in PARTS for p in parts):
        print(f"ep_phase: parts are {','.join(PARTS)}", file=sys.stderr)
        return 2
    import torch
    if not rehearse:
        if not torch.cuda.is_available():
            print("ep_phase: no CUDA device", file=sys.stderr)
            return 2
        from repro_torch.kernels import build
        log(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip())
        t0 = time.perf_counter()
        log(f"build {build.build()} ({time.perf_counter() - t0:.1f} s)")
    log(f"launches {dict(ep_phase(parts, rehearse))}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
