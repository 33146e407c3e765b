#!/usr/bin/env python3
"""The serving engine over ranks on the card: ``chip_smoke.py``'s phase
19, and runnable alone.

    python3 tools/serve_ranks_phase.py [replicated,exact,bytes]
    python3 tools/serve_ranks_phase.py --rehearse     # CPU, reduced configs

One H100 cannot host two NCCL ranks, so the ranks are gloo processes
sharing ``cuda:0``, as phase 18's are; gloo stages every collective
through host memory, so no time here is a multi-card number or the
paper's speed. Each rank runs ``Engine(options=EngineOptions(devices=N,
kv_sharding=...))`` with the decode step eager (the captured step over
ranks is ROADMAP.md's Queue 1 item 3d). Two spawns: 2 ranks (mesh (1, 2),
``ep_split(2, 64)``) and 3 ranks (mesh (3, 1), ``ep_split(3, 64)``). The
parts:

* ``replicated`` (2 ranks): full-width, full-depth moe-gpt3-s in bf16,
  ``kv_sharding="replicated"``, 8 seeded requests: every request
  completes with the same tokens on both ranks (and no rank's own
  samples differed from the agreed ones), each rank's memory after
  init, the eager decode step's p50, and the kernels' launches: the
  paged decode once a decode step and attention layer, the router and
  the expert FFN once a call, the FFN's decode calls at the replicated
  decode's shape ``[32, 8, 768]`` (``ffn_cases``) once a decode step
  and MoE layer (``serve-ranks`` line);
* ``exact``: full width, 2 layers, fp32, capacity factor 8.0, 8
  requests; the greedy tokens of every rank equal the one-device
  captured engine's and ``dense_greedy_reference``'s for moe-gpt3-s at
  mesh (1, 2) ``"replicated"``, moe-gpt3-s at (3, 1) ``"dp"`` (plain, a
  recompute storm and an offload storm, every shard's free list drained
  after each) and DeepSeek-V2-Lite at (3, 1) ``"dp"`` (the MLA kernel
  over local latent pools; plain and an offload storm)
  (``serve-ranks-exact`` lines);
* ``bytes`` (3 ranks): each rank's KV pools of full-depth moe-gpt3-s
  (bf16, 9 slots of 512 tokens) under ``"dp"`` and ``"replicated"``,
  from ``torch.cuda.memory_allocated`` and the cache's
  ``per_device_cache_bytes``: under ``"dp"`` a third of the pages plus
  the rank's sink page, and ``memory_allocated`` grows by the pools
  plus less than ``STEP_INPUTS`` of decode-step inputs
  (``serve-ranks-bytes``).

Every check outside its bound ends the run non-zero. ``serve_ranks``
returns the ranks' kernel launches in the checked runs, summed, for
``chip_smoke.py``'s kernels line. Prints the card's name and power limit
first; needs one CUDA card unless ``--rehearse``.
"""
import collections
import dataclasses
import datetime
import json
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

PARTS = ("replicated", "exact", "bytes")
TIMEOUT = 600.0
GPT, DEEPSEEK = "moe-gpt3-s", "deepseek-v2-lite-16b"
REQUESTS = 8
STEP_INPUTS = 1 << 16      # bytes a cache allocates beside its pools
ENGINE = dict(page_size=16, max_slots=8, max_seq_len=512, chunk=64,
              adaptive=False, decode_graph=False)


def log(msg: str) -> None:
    print(msg, flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def config(arch: str, rehearse: bool, *, exact: bool):
    """Full width: full depth in bf16 (``replicated``, ``bytes``), or 2
    layers in fp32 at capacity factor 8.0 (``exact``); n = 4."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if rehearse:
        cfg = cfg.reduced()
    elif exact:
        cfg = dataclasses.replace(cfg, num_layers=2)
    moe = dataclasses.replace(cfg.moe, num_partitions=4)
    if exact:
        moe = dataclasses.replace(moe, capacity_factor=8.0)
    return dataclasses.replace(
        cfg, moe=moe, compute_dtype="float32" if exact or rehearse
        else "bfloat16")


def requests(cfg, rehearse: bool):
    from repro_torch.launch.serve import synthetic_requests
    prompt, gen = ((4, 24), (4, 8)) if rehearse else ((16, 160), (8, 24))
    return synthetic_requests(REQUESTS, cfg.vocab_size, prompt, gen, seed=3)


def engine_opts(rehearse: bool, **over):
    kw = dict(ENGINE, **over)
    if rehearse:
        kw.update(page_size=4, max_seq_len=64, chunk=16, device="cpu")
    return kw


def ffn_cases(rehearse: bool = False) -> dict:
    """What the replicated decode of ``replicated`` gives the expert FFN
    on each rank of mesh (1, 2): ``[E / 2, cap, M]``, cap =
    ``capacity_for(8, 1, 2.0, 64)`` = 8 (case -> (shape, H, gated,
    activation))."""
    from repro_torch.core.pipeline_moe import capacity_for
    cfg = config(GPT, rehearse, exact=False)
    m = cfg.moe
    cap = capacity_for(ENGINE["max_slots"], m.top_k,
                       max(m.capacity_factor, 2.0), m.num_experts)
    return {"ep_serve_decode": ((m.num_experts // 2, cap, cfg.d_model),
                                m.d_expert, cfg.gated_ffn, cfg.ffn_act)}


def _moe_layers(cfg) -> int:
    return cfg.num_periods * sum(r["moe"] for r in cfg.layer_roles())


def serve(cfg, reqs, **opts):
    """An engine over ``reqs`` (8 seeded requests), run to idle, after
    ``warmup()``. Returns the engine and the tokens by request."""
    from repro_torch.serve import Engine, EngineOptions
    eng = Engine(cfg, options=EngineOptions(**opts))
    eng.warmup()
    handles = [eng.submit(p, max_new_tokens=g) for p, g in reqs]
    eng.run_until_idle()
    if not all(h.state.value == "done" for h in handles):
        raise AssertionError("a request did not finish")
    return eng, [list(h.output) for h in handles]


def _drained(eng) -> bool:
    kv = eng.kv
    return all(kv.free_pages_of(s) == kv.shard_capacity_pages
               for s in range(kv.n_shards)) and not kv.offloaded_count


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def replicated_check(torch, ctx, rehearse: bool) -> dict:
    from ep_phase import _ShapeLog
    from repro_torch.kernels import build
    cfg = config(GPT, rehearse, exact=False)
    dev = ctx.device
    reqs = requests(cfg, rehearse)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    from repro_torch.serve import Engine, EngineOptions
    eng = Engine(cfg, options=EngineOptions(**engine_opts(
        rehearse, devices=ctx.world_size, kv_sharding="replicated")))
    init_bytes = (torch.cuda.memory_allocated() if dev.type == "cuda"
                  else 0)
    eng.warmup()
    handles = [eng.submit(p, max_new_tokens=g) for p, g in reqs]
    build.reset_launches()
    t0 = time.perf_counter()
    with _ShapeLog() as shapes:
        eng.run_until_idle()
    wall = time.perf_counter() - t0
    s = eng.stats()
    row = {"rank": ctx.rank, "done": s["requests_done"],
           "tokens": [list(h.output) for h in handles],
           "token_disagreements": s["token_disagreements"],
           "init_bytes": init_bytes,
           "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                    if dev.type == "cuda" else 0),
           "p50_decode_step_ms": s["p50_decode_step_s"] * 1e3,
           "decode_steps": s["decode_steps"],
           "prefill_steps": s["prefill_steps"],
           "decode_tok_per_s": s["decode_tok_per_s"], "wall_s": wall,
           "per_device_cache_bytes": s["per_device_cache_bytes"],
           "launches": dict(build.LAUNCHES),
           "ffn_shapes": dict(shapes.shapes),
           "attn_layers": cfg.num_layers, "moe_layers": _moe_layers(cfg)}
    del eng
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


def exact_runs(torch, ctx, rehearse: bool) -> dict:
    """The ``exact`` cases of this mesh: (arch, layout, storm) -> tokens,
    whether every shard drained, and the run's kernel launches with the
    decode steps and attention layers they should match."""
    from repro_torch.kernels import build
    out = {}
    cases = ([(GPT, "replicated", None)] if ctx.dp_size == 1 else
             [(GPT, "dp", None), (GPT, "dp", "recompute"),
              (GPT, "dp", "offload"), (DEEPSEEK, "dp", None),
              (DEEPSEEK, "dp", "offload")])
    for arch, layout, storm in cases:
        cfg = config(arch, rehearse, exact=True)
        over = dict(devices=ctx.world_size, kv_sharding=layout)
        if storm:
            over.update(preempt=storm, storm_every=5)
        build.reset_launches()
        eng, toks = serve(cfg, requests(cfg, rehearse),
                          **engine_opts(rehearse, **over))
        s = eng.stats()
        out[f"{arch}/{layout}/{storm or 'plain'}"] = {
            "tokens": toks, "drained": _drained(eng),
            "preempts": s["preempt_recompute"] + s["preempt_offload"],
            "kv_shards": s["kv_shards"],
            "token_disagreements": s["token_disagreements"],
            "launches": dict(build.LAUNCHES),
            "decode_attn_calls": (s["decode_steps"] + 1) * cfg.num_layers}
        del eng
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def bytes_check(torch, ctx, rehearse: bool) -> dict:
    """This rank's pools under each layout: ``memory_allocated`` around
    the cache's construction, its ``per_device_cache_bytes``, its pages."""
    from repro_torch.serve.paged_kv import PagedKVCache
    cfg = config(GPT, rehearse, exact=False)
    o = engine_opts(rehearse)
    out = {}
    for layout in ("replicated", "dp"):
        cuda = ctx.device.type == "cuda"
        before = torch.cuda.memory_allocated() if cuda else 0
        kv = PagedKVCache(cfg, num_pages=0, page_size=o["page_size"],
                          max_slots=9,
                          max_pages_per_seq=-(-o["max_seq_len"]
                                              // o["page_size"]),
                          dtype=getattr(torch, cfg.compute_dtype),
                          device=ctx.device, dist=ctx, kv_sharding=layout)
        if cuda:
            torch.cuda.synchronize()
        out[layout] = {
            "allocated": (torch.cuda.memory_allocated() - before if cuda
                          else None),
            "per_device_cache_bytes": kv.per_device_cache_bytes,
            "page_bytes": kv.page_bytes, "num_pages": kv.num_pages,
            "local_pages": (kv.num_pages if kv.local_shard is None
                            else kv.pages_per_shard)}
        del kv
        if cuda:
            torch.cuda.empty_cache()
    return out


def _rank_main(rank, world, port, parts, rehearse, queue):
    try:
        import torch
        import torch.distributed as dist
        from repro_torch.distributed import make_serving_context
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
            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT))
        # the context the engines build over this world: ep_split(N, 64)
        ctx = make_serving_context(world, num_experts=64, device=dev)
        out = {}
        with torch.no_grad():
            for part, fn in (("replicated", replicated_check),
                             ("exact", exact_runs), ("bytes", bytes_check)):
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


def run_ranks(world: int, parts, rehearse: bool) -> list:
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, parts, rehearse, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results = [None] * world
    try:
        for _ in procs:
            rank, status, out = queue.get(timeout=TIMEOUT)
            if status != "ok":
                raise AssertionError(f"serve rank {rank} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return results


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def references(rehearse: bool) -> dict:
    """One device, this process: the captured engine's tokens (eager on
    the CPU) and ``dense_greedy_reference``'s, for each ``exact`` arch."""
    import torch

    from repro_torch.models import lm
    from repro_torch.serve import dense_greedy_reference
    out = {}
    for arch in (GPT, DEEPSEEK):
        cfg = config(arch, rehearse, exact=True)
        reqs = requests(cfg, rehearse)
        _, toks = serve(cfg, reqs, **engine_opts(
            rehearse, decode_graph=not rehearse))
        dev = "cpu" if rehearse else "cuda"
        params = lm.init_compute(cfg, 0, device=dev)
        oracle = [dense_greedy_reference(params, cfg, p, g)
                  for p, g in reqs]
        out[arch] = {"engine": toks, "oracle": oracle}
        del params
        if not rehearse:
            torch.cuda.empty_cache()
    return out


def _check_launches(row: dict, rehearse: bool) -> dict:
    """The replicated run's launches against its calls: the paged decode
    once a decode step and attention layer, the router and the expert
    FFN once a call, the FFN's decode calls at ``ffn_cases``' shape once
    a decode step and MoE layer."""
    shape = str(list(ffn_cases(rehearse)["ep_serve_decode"][0]))
    calls = sum(row["ffn_shapes"].values())
    want = {"decode_ffn_calls": row["decode_steps"] * row["moe_layers"]}
    got = {"decode_ffn_calls": row["ffn_shapes"].get(shape, 0)}
    if not rehearse:
        want.update(paged_decode_attention=row["decode_steps"]
                    * row["attn_layers"], topk_router=calls,
                    grouped_ffn=calls)
        got.update({k: row["launches"].get(k, 0) for k in
                    ("paged_decode_attention", "topk_router",
                     "grouped_ffn")})
    if got != want:
        raise AssertionError(f"serve-ranks rank {row['rank']}: launches "
                             f"{got}, expected {want}")
    return got


def serve_ranks(parts=PARTS, rehearse: bool = False) -> collections.Counter:
    """Runs the named parts, logs their lines, raises on a failed check;
    returns the ranks' launches in the checked runs, summed."""
    launches = collections.Counter()
    refs = references(rehearse) if "exact" in parts else None
    two = [p for p in parts if p in ("replicated", "exact")]
    three = [p for p in parts if p in ("exact", "bytes")]
    for world, mine in ((2, two), (3, three)):
        if not mine:
            continue
        t0 = time.perf_counter()
        ranks = run_ranks(world, mine, rehearse)
        log(f"serve-ranks-spawn {world} ranks {mine}: "
            f"{time.perf_counter() - t0:.1f} s " + json.dumps(
                {k: round(v, 1) for k, v in ranks[0].items()
                 if k.endswith("_s")}))
        if "replicated" in mine:
            rows = [r["replicated"] for r in ranks]
            for row in rows:
                launches.update(row["launches"])
                row["checked_launches"] = _check_launches(row, rehearse)
            same = all(r["tokens"] == rows[0]["tokens"] for r in rows)
            log("serve-ranks " + json.dumps(dict(
                {k: v for k, v in rows[0].items()
                 if k not in ("tokens", "launches")},
                ranks_tokens_equal=same,
                init_bytes=[r["init_bytes"] for r in rows],
                p50_decode_step_ms=[r["p50_decode_step_ms"] for r in rows],
                token_disagreements=[r["token_disagreements"]
                                     for r in rows])))
            if not (same and all(r["done"] == REQUESTS for r in rows)):
                raise AssertionError("serve-ranks: ranks disagree or a "
                                     "request did not finish")
        if "exact" in mine:
            for case, row in ranks[0]["exact"].items():
                arch = case.split("/")[0]
                ref = refs[arch]
                res = dict(case=case, mesh=[3, 1] if world == 3 else [1, 2],
                           ranks_equal=all(r["exact"][case]["tokens"]
                                           == row["tokens"] for r in ranks),
                           engine_equal=row["tokens"] == ref["engine"],
                           oracle_equal=row["tokens"] == ref["oracle"],
                           drained=all(r["exact"][case]["drained"]
                                       for r in ranks),
                           preempts=row["preempts"],
                           kv_shards=row["kv_shards"],
                           token_disagreements=[
                               r["exact"][case]["token_disagreements"]
                               for r in ranks],
                           tokens=sum(len(t) for t in row["tokens"]),
                           launches=row["launches"])
                log("serve-ranks-exact " + json.dumps(res))
                storm = not case.endswith("plain")
                # the decode kernel read each rank's own pools: once an
                # attention layer of every decode step and of warmup's
                kernel = ("paged_mla_decode" if arch == DEEPSEEK
                          else "paged_decode_attention")
                for r in ranks:
                    launches.update(r["exact"][case]["launches"])
                if not (res["ranks_equal"] and res["engine_equal"]
                        and res["oracle_equal"] and res["drained"]
                        and (res["preempts"] > 0 or not storm)
                        and (rehearse or all(
                            r["exact"][case]["launches"].get(kernel)
                            == r["exact"][case]["decode_attn_calls"]
                            for r in ranks))):
                    raise AssertionError(f"serve-ranks-exact {case} failed")
        if "bytes" in mine:
            rows = [r["bytes"] for r in ranks]
            for rank, row in enumerate(rows):
                rep, dp = row["replicated"], row["dp"]
                page = dp["page_bytes"]
                want = (rep["per_device_cache_bytes"] - page) // 3 + page
                res = dict(rank=rank, replicated=rep, dp=dp,
                           dp_expected=want,
                           ratio=dp["per_device_cache_bytes"]
                           / rep["per_device_cache_bytes"])
                log("serve-ranks-bytes " + json.dumps(res))
                ok = dp["per_device_cache_bytes"] == want
                if not rehearse:      # + the decode step's small inputs
                    ok &= all(0 <= r["allocated"]
                              - r["per_device_cache_bytes"] < STEP_INPUTS
                              for r in (rep, dp))
                if not ok:
                    raise AssertionError(f"serve-ranks-bytes rank {rank}")
    return launches


def main(argv) -> int:
    rehearse = "--rehearse" in argv
    argv = [a for a in argv if a != "--rehearse"]
    parts = argv[0].split(",") if argv else list(PARTS)
    if any(p not in PARTS for p in parts):
        print(f"serve_ranks_phase: parts are {','.join(PARTS)}",
              file=sys.stderr)
        return 2
    import torch
    if not rehearse:
        if not torch.cuda.is_available():
            print("serve_ranks_phase: no CUDA device", file=sys.stderr)
            return 2
        from repro_torch.kernels import build
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip())
        t0 = time.perf_counter()
        log(f"build {build.build()} ({time.perf_counter() - t0:.1f} s)")
    with torch.no_grad():
        log(f"launches {dict(serve_ranks(parts, rehearse))}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
