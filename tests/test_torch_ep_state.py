"""Train states over ranks: the 8-bit AdamW and Adafactor on ZeRO-3 and
expert shards, and elastic checkpoints under ``dist``, on gloo ranks
(``tests/torch_ep_harness.py``) at reduced moe-gpt3-s (fp32, n = 2,
NONE; at mesh (2, 2) the expert leaves are ZeRO-3 shards: d_expert 32
and d_model 64 divide dp 2):

* one step of ``adamw8bit`` and of ``adafactor`` at (2, 2) from the same
  weights: the gathered expert leaves within ``test_torch_ep_train.py``'s
  AdamW tolerance of the JAX optimizer's, run eagerly on one device on
  the JAX ``shard_map`` gradients (a JAX subprocess on four virtual CPU
  devices beside the ranks), and the 8-bit moments' int8 payloads and
  row scales against the JAX optimizer's (a row's scale spans both dp
  ranks' columns);
* two steps of each at (2, 2), and of Adafactor at (1, 2) (expert
  parallel only): the gathered state and parameters against the port's
  one-device optimizer fed the ranks' own gathered gradients, bit-equal
  for ``adamw8bit`` (its ``Q8`` scales included) and within rtol 1e-6
  of each leaf's largest magnitude for ``adafactor`` (its split means
  and its RMS sum add in another order); every rank's gathered state the
  same; each rank's optimizer state bytes a quarter of the expert
  leaves' (a half of their row scales and ``vr``, which span the split
  columns) plus the replicated rest;
* checkpoints at (2, 2) per optimizer: saved at step 2 and resumed to 4,
  bit-equal to the uninterrupted run; the step-4 checkpoint restored at
  (1, 2) and on one device, bit-equal to the saved state; a one-device
  checkpoint restored at (2, 2), bit-equal to ``shard_state`` of it; a
  run resumed from a copy of the step-2 checkpoint whose update fails
  once, on rank 1 alone, at step 3 (after the update's collectives):
  every rank rolls back to step 2 and the run ends bit-equal to the
  uninterrupted one.

The two meshes' spawns and the JAX subprocess run side by side; a rank
awaits, bounded, the checkpoints another process writes.
"""
import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro_torch.ckpt import Checkpointer
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.data import SyntheticTokens
from repro_torch.models.module import leaves, unflatten
from repro_torch.optim import get_optimizer, lr_schedule
from repro_torch.runtime import TrainOptions, init_state, train
from torch_dense_harness import np_params
from torch_ep_harness import (finish_jax_reference, flat_state, run_ranks,
                              start_jax_reference, state_rank)

OPTIMIZERS = ("adamw8bit", "adafactor")
LR = 1e-3

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
cfg = dataclasses.replace(base, moe=dataclasses.replace(
    base.moe, num_partitions=2, memory_reuse_strategy="none"))
tdef = jax.tree_util.tree_structure(jax.tree_util.tree_map(
    lambda s: 0, lm.specs_tree(base), is_leaf=module.is_spec))
flat = [data[f"p{i}"] for i in range(tdef.num_leaves)]
params = jax.tree_util.tree_unflatten(tdef, [jnp.asarray(x) for x in flat])
batch = {"tokens": jnp.asarray(data["tokens"]),
         "labels": jnp.asarray(data["labels"])}
mesh = make_mesh((2, 2), ("data", "model"))
dist = DistContext(mesh=mesh, dp_axes=("data",), ep_axis="model",
                   tp_axis="model")
grad = jax.jit(jax.grad(lambda p, b: lm.loss_fn(p, b, cfg, dist=dist),
                        has_aux=True))
with set_mesh(mesh):
    g = grad(params, batch)[0]
g = [jnp.asarray(np.asarray(x)) for x in jax.tree_util.tree_leaves(g)]
g = jax.tree_util.tree_unflatten(tdef, g)
scale = lr_schedule(jnp.ones((), jnp.int32), warmup=1, total=10)
g = jax.tree_util.tree_leaves(g)
out = {f"g{i}": np.asarray(x) for i, x in enumerate(g)}
paths = [jax.tree_util.keystr(k) for k, _ in
         jax.tree_util.tree_flatten_with_path(params)[0]]
experts = [i for i, k in enumerate(paths) if "'experts'" in k]
for name in ("adamw8bit", "adafactor"):      # eagerly, on one device
    opt_mod, ocfg = get_optimizer(name, float(data["lr"]))
    p = {i: jnp.asarray(flat[i]) for i in experts}
    new_p, st = opt_mod.update({i: g[i] for i in experts},
                               opt_mod.init(p, ocfg), p, ocfg, lr_scale=scale)
    for i, x in enumerate(flat):
        out[f"{name}_q{i}"] = np.asarray(new_p[i]) if i in experts else x
    if name == "adamw8bit":
        for i in experts:
            for m in ("m", "v"):
                out[f"{m}_q{i}"] = np.asarray(st[m][i].q)
                out[f"{m}_scale{i}"] = np.asarray(st[m][i].scale)
np.savez(tmp + "/out.npz", **out)
"""

_RESULTS = {}


def _cfg(optimizer):
    c = get_config("moe-gpt3-s").reduced()
    return dataclasses.replace(c, optimizer=optimizer, moe=dataclasses.replace(
        c.moe, num_partitions=2, memory_reuse_strategy="none"))


def _one_device_ckpts(params_np, where: dict) -> None:
    """A one-device state per optimizer after one step, saved at step 1
    under ``where[name]`` (the ranks await it)."""
    for name, (path, _) in where.items():
        cfg = _cfg(name)
        opts = TrainOptions(lr=LR, warmup=1, total_steps=4)
        state = init_state(cfg, opts, device="cpu",
                           params=from_jax(params_np, device="cpu"))
        train(cfg, steps=1, opts=opts, adaptive=False, state=state,
              batch_source=SyntheticTokens(cfg, 4, 32, seed=7),
              checkpointer=Checkpointer(path), ckpt_every=1)


def _run(tmp_path_factory):
    if _RESULTS:
        return _RESULTS
    params = np_params(jax_config("moe-gpt3-s").reduced(), 0)
    flat, tdef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(3)
    cfg = _cfg("adamw8bit")
    tokens = rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int32)
    tmp = tmp_path_factory.mktemp("ep_state")
    proc = start_jax_reference(_JAX, tmp, dict(
        tokens=tokens, labels=labels, lr=np.float64(LR),
        **{f"p{i}": x for i, x in enumerate(flat)}), devices=4)
    cfgs = {name: _cfg(name) for name in OPTIMIZERS}
    one_device = {name: (str(tmp / f"one_device_{name}"), 1)
                  for name in OPTIMIZERS}
    ckpts = {name: (cfgs[name], str(tmp / f"{name}_resume"), 4)
             for name in OPTIMIZERS}
    # both meshes and the one-device checkpoints side by side: each rank
    # awaits (bounded) the checkpoints it restores
    with ThreadPoolExecutor(2) as pool:
        meshes = pool.submit(run_ranks, state_rank, (2, 2), cfgs, params,
                             tokens, labels, LR, str(tmp), one_device, None)
        ep_only = pool.submit(run_ranks, state_rank, (1, 2),
                              {"adafactor": cfgs["adafactor"]}, params,
                              tokens, labels, LR, str(tmp), None, ckpts)
        _one_device_ckpts(params, one_device)
        ranks, ep_only = meshes.result(), ep_only.result()
    ref = finish_jax_reference(proc, tmp)

    def port_leaves(prefix):      # the expert leaves alone for the moments
        tree = jax.tree_util.tree_unflatten(tdef, [
            ref.get(f"{prefix}{i}", x) for i, x in enumerate(flat)])
        return [x.numpy() for x in leaves(from_jax(tree, device="cpu"))]

    _RESULTS.update(params=params, ranks=ranks, ep_only=ep_only, cfgs=cfgs,
                    ckpts=ckpts, jax_grads=port_leaves("g"),
                    jax={name: port_leaves(f"{name}_q")
                         for name in OPTIMIZERS},
                    jax_q8={k: port_leaves(k) for k in
                            ("m_q", "m_scale", "v_q", "v_scale")})
    return _RESULTS


def _params(flat: dict) -> list:
    return [v for k, v in flat.items() if k.startswith("params/")]


def _one_device(cfg, params_np, grads: list) -> list:
    """The port's one-device optimizer fed ``grads`` (one gathered
    gradient list a step) from the same state as the ranks: the state
    after each step (flat)."""
    opts = TrainOptions(lr=LR, warmup=1, total_steps=10)
    state = init_state(cfg, opts, device="cpu",
                       params=from_jax(params_np, device="cpu"))
    state["step"] = 1
    opt_mod, ocfg = get_optimizer(cfg.optimizer, LR)
    out = []
    for g in grads:
        params = state["params"]
        tree = unflatten(params, [torch.from_numpy(x) for x in g])
        state["opt"] = opt_mod.update(
            tree, state["opt"], params, ocfg,
            lr_scale=lr_schedule(state["step"], warmup=1, total=10))
        state["step"] += 1
        out.append(flat_state(state))
    return out


def _assert_states(got: dict, want: dict, exact: bool):
    assert got.keys() == want.keys()
    for k in want:
        if exact:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            w = np.asarray(want[k], dtype=np.float64)
            tol = 1e-6 * (float(np.abs(w).max()) if w.size else 0.0)
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=tol,
                                       err_msg=k)


def _expert_keys(run) -> list:
    """The parameter keys of a rank's gathered state, in ``leaves``
    order, and whether each is an expert leaf."""
    return [(k, "/moe/experts/" in k) for k in run["states"][0]
            if k.startswith("params/")]


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_one_step_on_zero3_shards_matches_jax(optimizer, tmp_path_factory):
    """The expert leaves (the ZeRO-3 shards, where the sharded reductions
    act) within 1e-5, as ``test_torch_ep_train.py`` holds the fp32 AdamW
    at this mesh. The JAX optimizer runs on those leaves alone (its
    update is per leaf; eagerly over the whole tree its op-by-op
    compiles take ~25 s); the replicated leaves take the one-device
    update, which ``test_torch_optim.py`` and
    ``test_torch_optim_adafactor.py`` hold to JAX, and the two-step test
    below holds every leaf to it."""
    res = _run(tmp_path_factory)
    for r in res["ranks"]:
        run = r["steps"][optimizer]
        held = 0
        for (k, expert), a, b in zip(_expert_keys(run), res["jax"][optimizer],
                                     _params(run["states"][0])):
            if expert:
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-5,
                                           err_msg=k)
                held += 1
        assert held == 4                  # w_up and w_down, 2 MoE layers


def test_one_step_8bit_moments_on_zero3_shards_match_jax(tmp_path_factory):
    """The 8-bit moments of the expert leaves after one step at (2, 2)
    against the JAX optimizer's. A row's scale is its whole row's amax
    over 127, the row spanning both dp ranks' columns (the ``all_reduce``
    MAX): within what the two runs' gradients move that amax. Each int8
    payload within one rounding step of the JAX one plus what the
    gradients and the two scales move ``x / scale``; a rank that scaled
    its columns by their own amax would be off by up to 127. From zero
    moments the first step's are ``m = (1 - b1)·g`` and ``v = (1 -
    b2)·g²`` (fp32: a relative slack of 1e-6)."""
    res = _run(tmp_path_factory)
    jq = res["jax_q8"]
    for r in res["ranks"]:
        run = r["steps"]["adamw8bit"]
        state = run["states"][0]
        held = 0
        for i, ((k, expert), gj, gp) in enumerate(zip(
                _expert_keys(run), res["jax_grads"], run["grads"][0])):
            if not expert:
                continue
            rest = k[len("params/"):]
            gj, gp = gj.astype(np.float64), gp.astype(np.float64)
            for m, x_j, x_p in (("m", 0.1 * gj, 0.1 * gp),
                                ("v", 1e-3 * gj * gj, 1e-3 * gp * gp)):
                s_j = jq[f"{m}_scale"][i].astype(np.float64)
                s_p = state[f"opt/{m}/{rest}/scale"].astype(np.float64)
                dx = np.abs(x_p - x_j).max(axis=-1, keepdims=True)
                np.testing.assert_array_less(
                    np.abs(s_p - s_j), dx / 127 + 1e-6 * s_j + 1e-30,
                    err_msg=f"{k} {m} scale")
                q_j = jq[f"{m}_q"][i].astype(np.float64)
                q_p = state[f"opt/{m}/{rest}/q"].astype(np.float64)
                moved = np.abs(x_p / s_p - x_j / s_j)
                np.testing.assert_array_less(
                    np.abs(q_p - q_j), 1 + moved + 1e-3,
                    err_msg=f"{k} {m} payload")
            held += 1
        assert held == 4


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_two_steps_on_zero3_shards_match_one_device(optimizer,
                                                    tmp_path_factory):
    res = _run(tmp_path_factory)
    run = res["ranks"][0]["steps"][optimizer]
    want = _one_device(res["cfgs"][optimizer], res["params"], run["grads"])
    for got, ref in zip(run["states"], want):
        _assert_states(got, ref, exact=optimizer == "adamw8bit")


def test_adafactor_over_expert_ranks_matches_one_device(tmp_path_factory):
    res = _run(tmp_path_factory)
    run = res["ep_only"][0]["steps"]["adafactor"]
    want = _one_device(res["cfgs"]["adafactor"], res["params"], run["grads"])
    for got, ref in zip(run["states"], want):
        _assert_states(got, ref, exact=False)


def test_every_rank_holds_the_same_state(tmp_path_factory):
    res = _run(tmp_path_factory)
    for ranks in (res["ranks"], res["ep_only"]):
        for name, run in ranks[0]["steps"].items():
            for r in ranks[1:]:
                for a, b in zip(run["states"], r["steps"][name]["states"]):
                    _assert_states(b, a, exact=True)


def _reckoned_rank_bytes(optimizer, params_np, mesh) -> int:
    """A rank's optimizer state bytes, reckoned from the JAX optimizer's
    state shapes (periods stacked): an expert leaf's state is cut over
    ep, and over dp (its ZeRO-3 columns) unless it drops the parameter's
    last axis, as an 8-bit row ``scale`` ``[..., 1]`` and Adafactor's
    ``vr`` ``[...]`` (the row means) do; the rest whole. The step count
    is an int in the port, not a tensor."""
    from repro.optim import get_optimizer as jax_optimizer
    dp, ep = mesh
    opt_mod, ocfg = jax_optimizer(optimizer, LR)
    state = opt_mod.abstract_state(jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params_np), ocfg)
    total = 0
    for kp, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        if not leaf.shape:
            continue
        names = [str(getattr(k, "key", getattr(k, "name", k))) for k in kp]
        nbytes = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
        if "experts" in names:
            nbytes //= ep * (1 if names[-1] in ("scale", "vr") else dp)
        total += nbytes
    return total


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_state_bytes_a_rank(optimizer, tmp_path_factory):
    """A rank at (2, 2) holds a quarter of each expert leaf's state (a
    half of what spans the split columns) and all the rest."""
    res = _run(tmp_path_factory)
    want = _reckoned_rank_bytes(optimizer, res["params"], (2, 2))
    for r in res["ranks"]:
        assert r["steps"][optimizer]["opt_bytes"] == want


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_resumed_run_is_bit_equal_to_an_uninterrupted_one(optimizer,
                                                          tmp_path_factory):
    for r in _run(tmp_path_factory)["ranks"]:
        c = r["ckpt"][optimizer]
        assert c["resumed_steps"] == [2, 3]
        _assert_states(c["resumed"], c["ref"], exact=True)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_checkpoint_restores_onto_another_mesh(optimizer, tmp_path_factory):
    res = _run(tmp_path_factory)
    saved = res["ranks"][0]["ckpt"][optimizer]["resumed"]
    for r in res["ep_only"]:
        _assert_states(r["restored"][optimizer], saved, exact=True)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_checkpoint_restores_onto_one_device(optimizer, tmp_path_factory):
    res = _run(tmp_path_factory)
    saved = res["ranks"][0]["ckpt"][optimizer]["resumed"]
    cfg, path, step = res["ckpts"][optimizer]
    state = Checkpointer(path).restore(step, like=init_state(
        cfg, TrainOptions(), device="cpu"))
    _assert_states(flat_state(state), saved, exact=True)
    whole = Checkpointer(path).restore(step)           # the flat dict
    _assert_states({k: v if v.ndim else int(v) for k, v in whole.items()},
                   saved, exact=True)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_one_device_checkpoint_restores_onto_a_mesh(optimizer,
                                                    tmp_path_factory):
    for r in _run(tmp_path_factory)["ranks"]:
        assert r["ckpt"][optimizer]["one_device_restored"]


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_failure_on_one_rank_rolls_every_rank_back(optimizer,
                                                   tmp_path_factory):
    for r in _run(tmp_path_factory)["ranks"]:
        c = r["ckpt"][optimizer]
        assert c["update_calls"] == 4      # steps 2 and 3, then again
        assert c["failed_steps"] == [2, 2, 3]
        _assert_states(c["failed"], c["ref"], exact=True)
        assert c["save"]["bytes"] > 0 and math.isfinite(c["save"]["copy_s"])
