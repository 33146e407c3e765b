"""The dense serving path over ranks: the port's ``lm.prefill`` (the
sharded layout: each rank's slice of the sequence through the dispatch
and combine All-to-Alls) and ``lm.decode_step`` (the replicated layout:
every rank routes its replica's tokens, runs its own experts, and an
``all_reduce`` sums them) with ``dist``, against the JAX package's
``shard_map`` path on a mesh of the same shape. Reduced
DeepSeek-V2-Lite (MLA, top-2 of 4 experts, a shared expert) in fp32 at
meshes (1, 2) and (2, 2), two prompts of 16 tokens, 4 greedy steps. At
mesh (2, 1) (dp only) JAX's layer runs the MoE over the global batch,
and so does the port: prefill's chunks are the ranks' rows, and each
decode step's one chunk is the whole batch, gathered on every rank.

Each rank holds its dp rows; its logits are held to JAX's rows within
1e-4, and its greedy tokens must equal JAX's. The capacity factor is
the config's (1.25): prefill capacity comes from each rank's 8 tokens
(a route may drop, as in JAX), decode's from ``max(cf, 2)``.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro_torch.configs import get_config
from torch_dense_harness import np_params
from torch_ep_harness import (decode_rank, finish_jax_reference, run_ranks,
                              start_jax_reference)

MESHES = ((1, 2), (2, 2), (2, 1))
PROMPT_LEN, MAX_LEN, STEPS = 16, 24, 4
LOGITS_TOL = 1e-4

_JAX = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import lm, module
from repro.distributed.context import DistContext
from repro.compat import make_mesh, set_mesh

tmp = sys.argv[1]
data = np.load(tmp + "/in.npz")
cfg = get_config("deepseek-v2-lite-16b").reduced()
tdef = jax.tree_util.tree_structure(jax.tree_util.tree_map(
    lambda s: 0, lm.specs_tree(cfg), is_leaf=module.is_spec))
params = jax.tree_util.tree_unflatten(
    tdef, [jnp.asarray(data[f"p{i}"]) for i in range(tdef.num_leaves)])
prompts = jnp.asarray(data["prompts"])
max_len, steps = int(data["max_len"]), int(data["steps"])
out = {}
for shape in MESHES:
    mesh = make_mesh(shape, ("data", "model"))
    dist = DistContext(mesh=mesh, dp_axes=("data",), ep_axis="model",
                       tp_axis="model")
    tag = f"{shape[0]}x{shape[1]}"
    with set_mesh(mesh):
        logits, cache = jax.jit(lambda p, b: lm.prefill(
            p, b, cfg, max_len, dist=dist, dtype=jnp.float32))(
                params, {"tokens": prompts})
        out[tag + "_prefill"] = np.asarray(logits)
        step = jax.jit(lambda p, c, t: lm.decode_step(p, c, t, cfg,
                                                      dist=dist))
        last = logits[:, -1]
        for i in range(steps):
            tok = jnp.argmax(last, -1)[:, None].astype(jnp.int32)
            out[f"{tag}_tok{i}"] = np.asarray(tok)
            last, cache = step(params, cache, tok)
            out[f"{tag}_step{i}"] = np.asarray(last)
np.savez(tmp + "/out.npz", **out)
"""

_RESULTS = {}


def _run(tmp_path_factory):
    if _RESULTS:
        return _RESULTS
    params = np_params(jax_config("deepseek-v2-lite-16b").reduced(), 0)
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, PROMPT_LEN), dtype=np.int32)
    inputs = dict(prompts=prompts, max_len=MAX_LEN, steps=STEPS,
                  **{f"p{i}": x for i, x in
                     enumerate(jax.tree_util.tree_leaves(params))})
    procs = {}                  # one JAX subprocess a mesh, side by side
    for mesh in MESHES:
        tmp = tmp_path_factory.mktemp("ep_decode")
        procs[mesh] = tmp, start_jax_reference(
            f"MESHES = {(mesh,)!r}\n" + _JAX, tmp, inputs,
            devices=mesh[0] * mesh[1])
    with ThreadPoolExecutor(len(MESHES)) as pool:   # the meshes' ranks too
        runs = {mesh: pool.submit(run_ranks, decode_rank, mesh, params, cfg,
                                  prompts, MAX_LEN, STEPS)
                for mesh in MESHES}
        for mesh, run in runs.items():
            _RESULTS[mesh] = run.result()
    _RESULTS["jax"] = {}
    for tmp, proc in procs.values():
        _RESULTS["jax"].update(finish_jax_reference(proc, tmp))
    return _RESULTS


def _rows(ref, mesh, rank):
    dp, ep = mesh
    n = ref.shape[0] // dp
    d = rank // ep
    return ref[d * n:(d + 1) * n]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_prefill_matches_jax(mesh, tmp_path_factory):
    res = _run(tmp_path_factory)
    ref = res["jax"][f"{mesh[0]}x{mesh[1]}_prefill"]
    for rank, out in enumerate(res[mesh]):
        np.testing.assert_allclose(out["prefill"], _rows(ref, mesh, rank),
                                   rtol=0, atol=LOGITS_TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_replicated_decode_matches_jax(mesh, tmp_path_factory):
    res = _run(tmp_path_factory)
    tag = f"{mesh[0]}x{mesh[1]}"
    for rank, out in enumerate(res[mesh]):
        for i in range(STEPS):
            np.testing.assert_array_equal(
                out["tokens"][i], _rows(res["jax"][f"{tag}_tok{i}"], mesh,
                                        rank))
            np.testing.assert_allclose(
                out["steps"][i], _rows(res["jax"][f"{tag}_step{i}"], mesh,
                                       rank), rtol=0, atol=LOGITS_TOL)
