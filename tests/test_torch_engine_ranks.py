"""The serving ``Engine`` over ``torch.distributed`` ranks (gloo, CPU):
``EngineOptions(devices=N, kv_sharding=...)`` against the JAX package's
``dense_greedy_reference`` and the port's one-device engine.

Reduced moe-gpt3-s in fp32 at capacity factor 8.0 (no route drops) with
the prompts of ``tests/test_serving_sharded.py`` (lens 13, 29, 7, 21, 5;
Philox key 7; ``page_size=4``, ``chunk=16``, 3 slots), at two meshes:

* (1, 2) from ``devices=2`` (``ep_split(2, 4)``): expert parallelism
  only, so ``"dp"`` degenerates to the replicated layout (one shard,
  run once);
* (2, 2) from ``devices=4`` with the config's ``num_experts=2``
  (``ep_split(4, 2)``): each rank holds one expert, and under ``"dp"``
  its pools hold only its dp shard's pages and it decodes only that
  shard's two slots.

Both layouts run under recompute and under offload preemption (a pool
of 10 pages a shard and a preemption every 4 steps) and with the prefix
cache on (the first two prompts again, for hits, under a storm, with
the adaptive prefill timing its candidates differently on each rank:
every rank must resolve the same ``n``, the world's slowest). Reduced
DeepSeek-V2-Lite (MLA over local latent pools, a shared expert,
``num_experts=2``) runs at (2, 2) under ``"dp"`` in the same spawn, under
both preemption modes. Every
rank's greedy tokens must equal the oracle's and the one-device
engine's, every shard's free list ends drained, and the host state (the
stats) is the same on every rank. A cancel asked for on rank 0 ends the
request on every rank; one asked for on another rank alone changes
nothing. The misuses raise: ``"dp"`` without a group (``ValueError``),
``devices`` other than the world size (``ValueError``) and
``decode_graph=True`` under a group (``NotImplementedError``).

Both meshes' ranks run side by side, beside a JAX subprocess a config
that computes the oracle's tokens.
"""
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro_torch import convert
from repro_torch.configs import get_config
from torch_dense_harness import np_params
from torch_ep_harness import (engine_rank, finish_jax_reference, run_ranks,
                              serve_engine, start_jax_reference)

LENS, MAX_NEW = (13, 29, 7, 21, 5), (6, 4, 8, 5, 7)
ARCHS = {"gpt_e4": ("moe-gpt3-s", 0), "gpt_e2": ("moe-gpt3-s", 2),
         "ds_e2": ("deepseek-v2-lite-16b", 2)}
LAYOUTS = ("replicated", "dp")
# name -> options; pages are a shard's (times the shard count). The
# recompute run cancels request 1 on rank 0 once it holds 2 tokens; the
# offload run asks for request 3's cancel on rank 1 alone (ignored)
VARIANTS = {
    "recompute": dict(num_pages=10, preempt="recompute", storm_every=4,
                      cancel_at=(1, 2)),
    "offload": dict(num_pages=10, preempt="offload", storm_every=4,
                    cancel_at=(3, 2, 1)),
    "prefix": dict(prefix_cache="on", preempt="recompute", storm_every=3,
                   repeat=2, rank_measure=True),
}
MESHES = {(1, 2): ("gpt_e4",), (2, 2): ("gpt_e2", "ds_e2")}


def _cfg(get, key):
    arch, experts = ARCHS[key]
    cfg = get(arch).reduced()
    moe = dataclasses.replace(cfg.moe, capacity_factor=8.0)
    if experts:
        moe = dataclasses.replace(moe, num_experts=experts,
                                  top_k=min(moe.top_k, experts))
    return dataclasses.replace(cfg, compute_dtype="float32", moe=moe)


def _cases(mesh):
    """(name, cfg key, options) of one mesh's spawn."""
    dp = mesh[0]
    out = []
    for key in MESHES[mesh]:
        for layout in LAYOUTS:
            if key == "ds_e2" and layout != "dp":
                continue
            shards = dp if layout == "dp" else 1
            for variant, over in VARIANTS.items():
                if key == "ds_e2" and variant == "prefix":
                    continue
                if dp == 1 and layout == "dp" and variant != "recompute":
                    continue              # the replicated layout again
                over = dict(over, kv_sharding=layout)
                if "num_pages" in over:
                    over["num_pages"] *= shards
                out.append((f"{key}-{layout}-{variant}", key, over))
    return out


_JAX = r"""
import json, os, sys
os.environ["XLA_FLAGS"] += " --xla_backend_optimization_level=0"
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import lm, module
from repro.serve import dense_greedy_reference

# the oracle itself, over the model's steps jitted (each prompt shape
# compiles once; op by op the oracle takes minutes on a CPU)
lm.prefill = jax.jit(lm.prefill, static_argnames=("cfg", "max_len",
                                                  "dtype"))
lm.decode_step = jax.jit(lm.decode_step, static_argnames=("cfg",))
tmp = sys.argv[1]
data = np.load(tmp + "/in.npz")
spec = json.loads(str(data["spec"]))
out = {}
for key in KEYS:
    import dataclasses
    cfg_kw, n_leaves = spec["cfgs"][key]
    base = get_config(cfg_kw["arch"]).reduced()
    moe = dataclasses.replace(base.moe, **cfg_kw["moe"])
    cfg = dataclasses.replace(base, compute_dtype="float32", moe=moe)
    tdef = jax.tree_util.tree_structure(jax.tree_util.tree_map(
        lambda s: 0, lm.specs_tree(cfg), is_leaf=module.is_spec))
    params = jax.tree_util.tree_unflatten(
        tdef, [jnp.asarray(data[f"{key}_p{i}"]) for i in range(n_leaves)])
    for i, n in enumerate(spec["max_new"]):
        out[f"{key}_{i}"] = np.asarray(dense_greedy_reference(
            params, cfg, data[f"prompt{i}"], n), np.int64)
np.savez(tmp + "/out.npz", **out)
"""

_RESULTS = {}


def _run(tmp_path_factory):
    if _RESULTS:
        return _RESULTS
    rng = np.random.Generator(np.random.Philox(key=7))
    cfgs = {k: _cfg(get_config, k) for k in ARCHS}
    prompts = [rng.integers(0, cfgs["gpt_e4"].vocab_size, size=n,
                            dtype=np.int32) for n in LENS]
    params = {k: np_params(_cfg(jax_config, k), 0) for k in ARCHS}
    leaves = {k: jax.tree_util.tree_leaves(p) for k, p in params.items()}
    spec = {"max_new": list(MAX_NEW), "cfgs": {
        k: ({"arch": ARCHS[k][0], "moe": {
            "capacity_factor": 8.0, "num_experts": cfgs[k].moe.num_experts,
            "top_k": cfgs[k].moe.top_k}}, len(leaves[k])) for k in ARCHS}}
    inputs = {"spec": json.dumps(spec),
              **{f"prompt{i}": p for i, p in enumerate(prompts)},
              **{f"{k}_p{i}": x for k, ls in leaves.items()
                 for i, x in enumerate(ls)}}
    procs = {}             # one JAX subprocess a config, side by side
    for key in ARCHS:
        tmp = tmp_path_factory.mktemp("engine_ranks")
        procs[key] = tmp, start_jax_reference(
            f"KEYS = {[key]!r}\n" + _JAX, tmp, inputs, devices=1)
    with ThreadPoolExecutor(len(MESHES)) as pool:
        runs = {mesh: pool.submit(run_ranks, engine_rank, mesh, params,
                                  cfgs, prompts, MAX_NEW, _cases(mesh))
                for mesh in MESHES}
        # the one-device engine, in this process meanwhile
        torch_params = {k: convert.from_jax(p, device="cpu")
                        for k, p in params.items()}
        one = {}
        for mesh in MESHES:
            for name, key, over in _cases(mesh):
                over = {k: v for k, v in over.items()
                        if k != "kv_sharding"}
                if name.endswith("offload"):      # rank 1's cancel: ignored
                    del over["cancel_at"]
                one[name] = serve_engine(cfgs[key], torch_params[key],
                                         prompts, MAX_NEW, **over)
        for mesh, run in runs.items():
            _RESULTS[mesh] = run.result()
    _RESULTS["one"] = one
    _RESULTS["oracle"] = {}
    for key, (tmp, proc) in procs.items():
        oracle = finish_jax_reference(proc, tmp)
        _RESULTS["oracle"][key] = [oracle[f"{key}_{i}"].tolist()
                                   for i in range(len(LENS))]
    return _RESULTS


def _all_cases():
    return [(mesh, name, key) for mesh in MESHES
            for name, key, _ in _cases(mesh)]


@pytest.mark.parametrize("mesh,name,key", _all_cases(),
                         ids=[f"{m[0]}x{m[1]}-{n}" for m, n, _ in
                              _all_cases()])
def test_engine_over_ranks_matches_oracle(mesh, name, key,
                                          tmp_path_factory):
    res = _run(tmp_path_factory)
    oracle = res["oracle"][key]
    one = res["one"][name]
    ranks = res[mesh]
    for rank, out in enumerate(ranks):
        got = out[name]
        assert got["outs"] == one["outs"], (rank, got["outs"], one["outs"])
        assert got["cancelled"] == one["cancelled"]
        for rid, toks in got["outs"].items():
            assert toks == oracle[rid % len(LENS)], (rank, rid)
        assert got["drained"]
    # host state is the same on every rank
    keys = ("resolutions", "requests_done", "requests_cancelled",
            "preempt_recompute",
            "preempt_offload", "resumes", "swap_out_bytes", "prefix_hits",
            "prefix_cow_copies", "engine_steps", "peak_kv_used_bytes",
            "free_units_by_shard", "kv_shards", "per_device_cache_bytes",
            "per_device_peak_kv_used_bytes")
    first = {k: ranks[0][name]["stats"][k] for k in keys}
    for out in ranks[1:]:
        assert {k: out[name]["stats"][k] for k in keys} == first
    # each rank's own samples already agreed, before the exchange
    assert all(out[name]["stats"]["token_disagreements"] == 0
               for out in ranks)
    s = ranks[0][name]["stats"]
    dp, ep = mesh
    layout = "dp" if "-dp-" in name else "replicated"
    shards = dp if layout == "dp" else 1
    assert (s["devices"], s["dp_size"], s["ep_size"], s["kv_sharding"],
            s["kv_shards"], s["decode_graph"]) == (dp * ep, dp, ep, layout,
                                                   shards, False)
    assert s["per_device_cache_bytes"] * shards == s["cache_bytes"]
    if name.endswith(("recompute", "offload")):
        mode = name.rsplit("-", 1)[1]
        assert s[f"preempt_{mode}"] > 0
    if name.endswith("offload"):
        assert s["swap_in_bytes"] == s["swap_out_bytes"] > 0
    if name.endswith("prefix"):
        assert s["prefix_hits"] > 0
        # rank 0 alone would take n = 1, the others the most chunks
        assert {n for n, _ in s["resolutions"].values()} == {4}
    assert ranks[0][name]["cancelled"] == (
        [1] if name.endswith("recompute") else [])


@pytest.mark.parametrize("mesh", list(MESHES),
                         ids=[f"{m[0]}x{m[1]}" for m in MESHES])
def test_misuse_over_ranks_raises(mesh, tmp_path_factory):
    for out in _run(tmp_path_factory)[mesh]:
        assert "world size" in out["devices_not_world"]
        assert "item 3d" in out["decode_graph"]


def test_dp_sharding_without_a_group_raises():
    from repro_torch.serve import Engine, EngineOptions
    with pytest.raises(ValueError, match="kv_sharding='dp'"):
        Engine(_cfg(get_config, "gpt_e4"), options=EngineOptions(
            device="cpu", kv_sharding="dp", max_slots=2, max_seq_len=32))


@pytest.mark.parametrize("argv", [
    ["--devices", "2"],                                  # needs --engine
    ["--engine", "--kv-sharding", "dp"],                 # needs --devices
    ["--engine", "--devices", "2", "--http-port", "0"],  # item 3d
], ids=["devices_without_engine", "dp_without_devices", "http_over_ranks"])
def test_serve_launcher_rank_flag_rules(argv, capsys):
    """The JAX launcher's rules for ``--devices`` and ``--kv-sharding``;
    the ingress over ranks is refused, naming its ROADMAP.md item."""
    from repro_torch.launch import serve as launcher
    with pytest.raises(SystemExit):
        launcher.main(["--reduced", "--device", "cpu"] + argv)
    err = capsys.readouterr().err
    assert ("3d" in err) == ("--http-port" in argv)
