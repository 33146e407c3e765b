"""Expert and data parallelism in training: the port's ranks (gloo on
the CPU, ``tests/torch_ep_harness.py``) against the JAX package on a
mesh of the same shape (virtual CPU devices), reduced moe-gpt3-s in
fp32:

* mesh (2, 2), n = 2 chunks, NONE and S4: the JAX ``shard_map`` path.
  The mesh makes every part of the slice run: the sequence split over
  the EP group, the dispatch and combine All-to-Alls, ZeRO-3 expert
  shards (d_expert 32 and d_model 64 divide dp 2), the aux losses'
  ``pmean``, a batch with masked labels (the loss divides by the whole
  batch's count), and each leaf's gradient reduction. Capacity comes
  from each rank's chunk (16 tokens, capacity 8 an expert, top-1 over 4
  experts), so route drops happen and must be JAX's.
* mesh (2, 1), dp only: the JAX layer's plain branch, whose chunks,
  capacities and Switch aux loss are the global batch's. At n = 2 under
  NONE each global chunk is one rank's rows; at n = 1 under S4 every
  rank gathers the whole batch (one 128-token chunk, capacity 32).
* a sequence that does not split over the EP group is refused in
  training, by the JAX layer's ``shard_map`` and by the port.

Tolerances: the loss within 1e-5; every gradient leaf, gathered, within
rtol 1e-4 (atol 1e-6), so a missing factor of ep or dp in any reduction
fails; the parameters after one AdamW step within 1e-5, at the
launcher's learning rate 1e-3. Adam's first step is ``lr·g / (|g| +
eps)``, which amplifies the summation noise of a gradient near ``eps``
(1e-8): leaves where both packages' gradients are ~1e-8 differ by 1-2%
(far inside the gradient tolerance, and as much as the JAX package's
own NONE and S4 gradients differ from each other there), which moves
such a parameter by up to ~5e-3·lr. At mesh (2, 1) JAX sums the global
batch's gradient in one program and the port adds two ranks' halves, so
such an element's gradient differs by an fp32 step of its leaf's scale
(~2e-9 where the leaf's largest is 0.02): there each parameter is held
within 1e-5 plus what that element's own gradient difference can move
Adam's first step, ``lr·|δg| / eps`` (the step's derivative in g is at
most 1 / eps). The JAX side runs in a subprocess beside the port's
ranks (~25 s: a subprocess a mesh, side by side).
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro.models import module as jmodule
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.models.module import leaves
from torch_dense_harness import np_params
from torch_ep_harness import (finish_jax_reference, run_ranks,
                              start_jax_reference, train_rank)

# name: (mesh, n, strategy); "none" and "s4" keep their first names
CASES = {"none": ((2, 2), 2, "none"), "s4": ((2, 2), 2, "s4"),
         "dp_none": ((2, 1), 2, "none"), "dp_n1_s4": ((2, 1), 1, "s4")}
LR = 1e-3
ADAM_EPS = 1e-8                           # AdamWConfig's and JAX's eps

_JAX = r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import lm, module
from repro.distributed.context import DistContext
from repro.compat import make_mesh, set_mesh
from repro.optim import get_optimizer, lr_schedule

tmp = sys.argv[1]
data = np.load(tmp + "/in.npz")
base = get_config("moe-gpt3-s").reduced()
tdef = jax.tree_util.tree_structure(jax.tree_util.tree_map(
    lambda s: 0, lm.specs_tree(base), is_leaf=module.is_spec))
params = jax.tree_util.tree_unflatten(
    tdef, [jnp.asarray(data[f"p{i}"]) for i in range(tdef.num_leaves)])
batch = {"tokens": jnp.asarray(data["tokens"]),
         "labels": jnp.asarray(data["labels"])}
opt_mod, ocfg = get_optimizer(base.optimizer, float(data["lr"]))
step = jax.jit(lambda g, p: opt_mod.update(
    g, opt_mod.init(p, ocfg), p, ocfg,
    lr_scale=lr_schedule(jnp.ones((), jnp.int32), warmup=1, total=10))[0])
out = {}
for name, shape, n, strat in CASES:
    mesh = make_mesh(shape, ("data", "model"))
    dist = DistContext(mesh=mesh, dp_axes=("data",), ep_axis="model",
                       tp_axis="model")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, num_partitions=n, memory_reuse_strategy=strat))
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: lm.loss_fn(p, b, cfg, dist=dist), has_aux=True))
    with set_mesh(mesh):
        (loss, _), g = grad(params, batch)
        if name == "none":                  # S 31 does not split over ep 2
            try:
                grad(params, {k: v[:, :31] for k, v in batch.items()})
                out["odd_refused"] = False
            except ValueError:
                out["odd_refused"] = True
    out[name + "_loss"] = np.asarray(loss)
    out[name + "_gnorm"] = np.sqrt(sum(
        float(jnp.sum(x * x)) for x in jax.tree_util.tree_leaves(g)))
    for i, x in enumerate(jax.tree_util.tree_leaves(g)):
        out[f"{name}_g{i}"] = np.asarray(x)
    for i, x in enumerate(jax.tree_util.tree_leaves(step(g, params))):
        out[f"{name}_q{i}"] = np.asarray(x)
np.savez(tmp + "/out.npz", **out)
"""

_RESULTS = {}


def _cfg(n, strategy):
    c = get_config("moe-gpt3-s").reduced()
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, num_partitions=n, memory_reuse_strategy=strategy))


def _run(tmp_path_factory):
    if _RESULTS:
        return _RESULTS
    jcfg = jax_config("moe-gpt3-s").reduced()
    params = np_params(jcfg, 0)
    flat, tdef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (4, 32), dtype=np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (4, 32), dtype=np.int32)
    labels[1, :7] = -1                  # masked: the count must be global
    inputs = dict(tokens=tokens, labels=labels, lr=np.float64(LR),
                  **{f"p{i}": x for i, x in enumerate(flat)})
    meshes = sorted({mesh for mesh, _, _ in CASES.values()})
    procs = {}                  # one JAX subprocess a mesh, side by side
    for mesh in meshes:
        tmp = tmp_path_factory.mktemp("ep_train")
        cases = [(k, m, n, s) for k, (m, n, s) in CASES.items() if m == mesh]
        procs[mesh] = tmp, start_jax_reference(
            f"CASES = {cases!r}\n" + _JAX, tmp, inputs,
            devices=mesh[0] * mesh[1])
    with ThreadPoolExecutor(len(meshes)) as pool:   # the meshes' ranks too
        runs = [pool.submit(run_ranks, train_rank, mesh, params, tokens,
                            labels, {k: _cfg(n, s) for k, (m, n, s) in
                                     CASES.items() if m == mesh}, LR)
                for mesh in meshes]
        ranks = {}
        for run in runs:
            for rank in run.result():
                for k, v in rank.items():
                    ranks.setdefault(k, []).append(v)
    ref = {}
    for tmp, proc in procs.values():
        ref.update(finish_jax_reference(proc, tmp))

    def port_leaves(prefix):
        tree = jax.tree_util.tree_unflatten(
            tdef, [ref[f"{prefix}{i}"] for i in range(len(flat))])
        return [x.numpy() for x in leaves(from_jax(tree, device="cpu"))]

    for k in CASES:
        _RESULTS[k] = {"ranks": ranks[k],
                       "loss": float(ref[k + "_loss"]),
                       "gnorm": float(ref[k + "_gnorm"]),
                       "grads": port_leaves(k + "_g"),
                       "params": port_leaves(k + "_q")}
    _RESULTS["odd"] = (bool(ref["odd_refused"]), ranks["odd_seq_raises"])
    return _RESULTS


@pytest.mark.parametrize("case", CASES)
def test_loss_matches_jax_shard_map(case, tmp_path_factory):
    res = _run(tmp_path_factory)[case]
    for r in res["ranks"]:
        np.testing.assert_allclose(r["loss"], res["loss"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], res["gnorm"],
                                   rtol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_every_gradient_leaf_matches_jax(case, tmp_path_factory):
    res = _run(tmp_path_factory)[case]
    assert len(res["ranks"][0]["grads"]) == len(res["grads"])
    for r in res["ranks"]:
        for a, b in zip(res["grads"], r["grads"]):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_params_after_one_adamw_step_match_jax(case, tmp_path_factory):
    res = _run(tmp_path_factory)[case]
    global_sum = CASES[case][0][1] == 1            # mesh (dp, 1)
    for r in res["ranks"]:
        for a, b, ga, gb in zip(res["params"], r["params"], res["grads"],
                                r["grads"]):
            tol = 1e-5 + (LR * np.abs(gb - ga) / ADAM_EPS if global_sum
                          else 0.0)
            assert np.all(np.abs(b - a) <= tol), np.max(np.abs(b - a) - tol)


def test_ranks_hold_one_model(tmp_path_factory):
    """Every rank's gathered parameters after the step are bit-equal:
    the replicated leaves stay replicas."""
    for k in CASES:
        first = _run(tmp_path_factory)[k]["ranks"][0]["params"]
        for r in _run(tmp_path_factory)[k]["ranks"][1:]:
            for a, b in zip(first, r["params"]):
                np.testing.assert_array_equal(a, b)


def test_unsplit_sequence_is_refused_in_training(tmp_path_factory):
    """S = 31 at ep = 2: the JAX layer's shard_map refuses the replicated
    output (a ValueError at trace time); the port's layer raises rather
    than count each token's expert gradient twice."""
    jax_refused, port_raised = _run(tmp_path_factory)["odd"]
    assert jax_refused
    assert port_raised and all(port_raised)
