"""The MoE path: router, dispatch, experts and the pipelined layer, the
port against the JAX package.

The same numpy inputs, made from a seed, go through each JAX function
and its counterpart in ``repro_torch`` on the CPU, in fp32. Floats are
held within rtol = atol = 1e-5: the two frameworks sum in a different
order, so bit-equality is not expected. Integer outputs (expert indices,
dispatch destinations) must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import pipeline_moe as jpipe
from repro.moe import dispatch as jdisp
from repro.moe import experts as jexp
from repro.moe import router as jrouter
from repro_torch.configs import get_config
from repro_torch.core import pipeline_moe as tpipe
from repro_torch.moe import dispatch as tdisp
from repro_torch.moe import experts as texp
from repro_torch.moe import router as trouter

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(),
                               **(tol or TOL))


def _cfgs():
    return jax_config("moe-gpt3-s").reduced(), \
        get_config("moe-gpt3-s").reduced()


# ---------------------------------------------------------------------------
# MoE: router, dispatch, experts, the pipelined layer
# ---------------------------------------------------------------------------

def _moe_params(cfg, r):
    m, d = cfg.moe, cfg.d_model
    return {"router": {"w_gate": r.standard_normal(
                (d, m.num_experts)).astype(np.float32) * 0.5},
            "experts": {
                "w_up": r.standard_normal(
                    (m.num_experts, d, m.d_expert)).astype(np.float32) * 0.1,
                "w_down": r.standard_normal(
                    (m.num_experts, m.d_expert, d)).astype(np.float32) * 0.1}}


@pytest.mark.parametrize("top_k", [1, 2])
def test_route_matches_including_ties(top_k):
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             top_k=top_k))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                             top_k=top_k))
    r = _rng(6)
    p = _moe_params(jcfg, r)["router"]
    p["w_gate"][:, 2] = p["w_gate"][:, 1]   # experts 1 and 2 always tie
    p["w_gate"][:, 3] = p["w_gate"][:, 1]   # ... and 3
    x = r.standard_normal((12, 64)).astype(np.float32)
    x[:4] = 0.0                              # all four experts tie here
    pj, ij, aj = jax.jit(lambda p_, x_: jrouter.route(p_, x_, jcfg))(
        _j(p), jnp.asarray(x))
    pt, it, at = trouter.route(_t(p), torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    assert (it.numpy()[:4, 0] == 0).all()    # the lowest index wins
    _close(pj, pt)
    for key in ("aux_loss", "z_loss"):
        _close(aj[key], at[key])


@pytest.mark.parametrize("top_k", [1, 2])
def test_route_and_plan_matches_route_then_dispatch_plan(top_k):
    """``route_and_plan`` without autograd (serving): one router launch
    gives what the JAX ``route`` and ``dispatch_plan`` give, and the aux
    losses built from its statistics agree with the JAX ones; under
    autograd its aux losses are ``route``'s PyTorch terms."""
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             top_k=top_k))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                             top_k=top_k))
    r = _rng(16)
    p = _moe_params(jcfg, r)["router"]
    p["w_gate"][:, 2] = p["w_gate"][:, 1]    # experts 1 and 2 always tie
    x = r.standard_normal((20, 64)).astype(np.float32)
    x[:4] = 0.0                              # all four experts tie here
    cap = 4                                  # tight: some routes drop
    pj, ij, dj, aj = jax.jit(lambda p_, x_: (
        lambda o: (o[0], o[1], jdisp.dispatch_plan(o[1], 4, cap)[0], o[2]))(
            jrouter.route(p_, x_, jcfg)))(_j(p), jnp.asarray(x))
    with torch.no_grad():
        pt, it, dt_, at = trouter.route_and_plan(_t(p), torch.from_numpy(x),
                                                 tcfg, cap)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_array_equal(np.asarray(dj), dt_.numpy())
    assert (dt_.numpy() == 4 * cap).any()    # overflow row used
    _close(pj, pt)
    for key in ("aux_loss", "z_loss"):
        _close(aj[key], at[key])
    wt = _t(p)
    wt["w_gate"].requires_grad_(True)
    pg, ig, dg, ag = trouter.route_and_plan(wt, torch.from_numpy(x), tcfg,
                                            cap)
    assert ag["aux_loss"].requires_grad and torch.equal(dg, dt_)
    for key in ("aux_loss", "z_loss"):
        _close(aj[key], ag[key])


@pytest.mark.parametrize("k", [1, 2])
def test_dispatch_plan_dispatch_combine(k):
    r = _rng(7)
    e, cap, t, m = 4, 3, 10, 8
    idx = r.integers(0, e, (t, k)).astype(np.int32)
    idx[:6, 0] = 2                           # overflow expert 2 past cap
    dj, vj = jax.jit(lambda i_: jdisp.dispatch_plan(i_, e, cap))(
        jnp.asarray(idx))
    dt_, vt = tdisp.dispatch_plan(torch.from_numpy(idx), e, cap)
    np.testing.assert_array_equal(np.asarray(dj), dt_.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    assert (dt_.numpy() == e * cap).any()    # overflow row used
    x = r.standard_normal((t, m)).astype(np.float32)
    bj = jdisp.dispatch(jnp.asarray(x), dj, e, cap)
    bt = tdisp.dispatch(torch.from_numpy(x), dt_, e, cap)
    _close(bj, bt)
    probs = r.random((t, k)).astype(np.float32)
    _close(jdisp.combine(bj, dj, jnp.asarray(probs), t),
           tdisp.combine(bt, dt_, torch.from_numpy(probs), t))


def test_apply_grouped():
    jcfg, tcfg = _cfgs()
    r = _rng(8)
    p = _moe_params(jcfg, r)["experts"]
    x = r.standard_normal((4, 8, 64)).astype(np.float32)
    _close(jexp.apply_grouped(_j(p), jnp.asarray(x), jcfg),
           texp.apply_grouped(_t(p), torch.from_numpy(x), tcfg))


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("n", [1, 2])
def test_pipelined_moe(n, mode):
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, num_partitions=n))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, num_partitions=n))
    r = _rng(9)
    p = _moe_params(jcfg, r)
    x = r.standard_normal((16, 64)).astype(np.float32)
    oj, aj = jax.jit(lambda p_, x_: jpipe.pipelined_moe(
        p_, x_, cfg=jcfg, mode=mode))(_j(p), jnp.asarray(x))
    ot, at = tpipe.pipelined_moe(_t(p), torch.from_numpy(x), cfg=tcfg,
                                 mode=mode)
    _close(oj, ot)
    for key in ("aux_loss", "z_loss"):
        _close(aj[key], at[key])
    assert tpipe._resolve_partitions(tcfg, 16, mode) == \
        jpipe._resolve_partitions(jcfg, 16, mode)


def test_pipelined_moe_under_autograd():
    """The train path of ``_chunk_fn``: with the parameters under
    autograd the router keeps ``route``'s PyTorch aux terms; the output
    and the aux losses still match the JAX layer."""
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, num_partitions=2))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, num_partitions=2))
    r = _rng(19)
    p = _moe_params(jcfg, r)
    x = r.standard_normal((16, 64)).astype(np.float32)
    oj, aj = jax.jit(lambda p_, x_: jpipe.pipelined_moe(
        p_, x_, cfg=jcfg, mode="train"))(_j(p), jnp.asarray(x))
    tp = _t(p)
    for leaf in (tp["router"]["w_gate"], *tp["experts"].values()):
        leaf.requires_grad_(True)
    ot, at = tpipe.pipelined_moe(tp, torch.from_numpy(x), cfg=tcfg,
                                 mode="train")
    assert at["aux_loss"].requires_grad
    _close(oj, ot)
    for key in ("aux_loss", "z_loss"):
        _close(aj[key], at[key])
