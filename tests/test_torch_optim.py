"""The 8-bit AdamW (here) and Adafactor (``test_torch_optim_adafactor.py``,
which shares this file's helpers: each file compiles its JAX optimizer's
ops once, ~12 s), the port against ``repro.optim``, on
the CPU in fp32 over the parameter tree of moe-gpt3-s's reduced size: 4
layers, so 2 periods, which is what lets the JAX package's cross-period
statistics show.

The JAX optimizers see the stacked tree (each period leaf on a leading
``layers`` axis); the port sees its list of periods and gathers them by
path (``optim.groups``). Each case draws seeded numpy gradients in the
JAX tree's shapes, converts them with ``convert.from_jax`` and runs 3
updates in both packages (lr 1e-3, the JAX ``lr_schedule``'s scale of
each step). Held after every update:

* parameters within rtol 1e-6, atol 1e-7 (both compute in float32 in the
  same order of operations);
* Adafactor's ``vr`` / ``vc`` (stacked in both) within rtol 1e-6 — the
  1-D period leaves' ``vc`` is the mean over the 2 periods, and their
  ``r`` divides by the mean of ``vr`` over the periods;
* each ``Q8`` scale within rtol 1e-6, and the int8 payloads equal except
  where ``x / scale`` lies within 1e-4 of a .5 tie (``x`` the float
  moment, recomputed in numpy from the JAX state before the update), and
  never more than 1 apart; the count of such differences is printed;
* the 1-D period leaves (the norms' scales and biases) have 8-bit
  moments, one row a period, while ``final_norm``'s stay fp32, as the
  stacked rank decides in JAX.

One case of each optimizer starts from a JAX state after 2 JAX updates,
carried across by ``convert.from_jax_state``, and takes 1 more update in
both. JAX runs its update eagerly (op by op).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.optim import adafactor as jafactor
from repro.optim import adamw as jadamw
from repro.optim import lr_schedule as jax_lr_schedule
from repro_torch.convert import from_jax, from_jax_state
from repro_torch.models.module import leaves
from repro_torch.optim import get_optimizer, lr_schedule
from repro_torch.optim.adamw import Q8
from test_torch_train import jax_params

LR = 1e-3
STEPS = 3


def make_setup():
    cfg = jax_config("moe-gpt3-s").reduced()
    assert cfg.num_periods == 2
    params = jax.tree.map(np.asarray, jax_params(cfg, 0))
    r = np.random.default_rng(7)
    grads = [jax.tree.map(lambda p: (r.standard_normal(p.shape) * 0.1)
                          .astype(np.float32), params)
             for _ in range(STEPS)]
    return params, grads


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def _jax_opt(name):
    """(module, config, update) of the JAX optimizer; the update runs
    eagerly, op by op (under ``jax.jit`` XLA fuses the arithmetic and
    rounds differently, and compiling the whole tree's update takes as
    long as the first eager run)."""
    if name == "adamw8bit":
        mod, cfg = jadamw, jadamw.AdamWConfig(lr=LR, quantize_moments=True)
    else:
        mod, cfg = jafactor, jafactor.AdafactorConfig(lr=LR)
    return mod, cfg, lambda g, s, p, scale: mod.update(g, s, p, cfg,
                                                       lr_scale=scale)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _x_before_quantize(jstate_m, jstate_v, g, cfg):
    """The float moments the JAX update quantises, from its state before
    the update, in numpy float32 in JAX's order: a tree shaped as the
    moments with ``Q8(m, v)`` pairs where they are 8-bit (zeros
    elsewhere)."""
    f32 = np.float32

    def deq(q8):
        return np.asarray(q8.q).astype(np.float32) * np.asarray(q8.scale)

    def mom(m, v, gg):
        if not isinstance(m, jadamw.Q8):
            return np.zeros(np.shape(m), np.float32)
        m_new = f32(cfg.b1) * deq(m) + f32(1 - cfg.b1) * gg
        v_new = f32(cfg.b2) * deq(v) + f32(1 - cfg.b2) * gg * gg
        return jadamw.Q8(m_new, v_new)

    is_q8 = lambda x: isinstance(x, jadamw.Q8)  # noqa: E731
    return jax.tree.map(mom, jstate_m, jstate_v, g, is_leaf=is_q8)


def _q8_leaves(tree):
    out = []

    def walk(t):
        if isinstance(t, Q8):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, list):
            for v in t:
                walk(v)
    walk(tree)
    return out


def _check_q8(port_tree, jax_tree, before, which: int) -> int:
    """Scales within rtol 1e-6; payloads equal but at near-ties. Returns
    the number of payload elements that differ."""
    got_l = _q8_leaves(port_tree)
    want_l = _q8_leaves(from_jax(jax_tree, device="cpu"))
    x_l = [x[which] for x in _q8_leaves(from_jax(before, device="cpu"))]
    assert len(got_l) == len(want_l) == len(x_l) > 0
    differ = 0
    for got, exp, x in zip(got_l, want_l, x_l):
        np.testing.assert_allclose(got.scale.numpy(), exp.scale.numpy(),
                                   rtol=1e-6)
        d = got.q.numpy().astype(np.int32) - exp.q.numpy().astype(np.int32)
        assert np.abs(d).max() <= 1
        if np.any(d):
            frac = np.abs(np.abs(x.numpy() / exp.scale.numpy()) % 1.0 - 0.5)
            assert (frac[d != 0] < 1e-4).all()
            differ += int(np.count_nonzero(d))
    return differ


def _jax_state(name, params):
    mod, cfg, _ = _jax_opt(name)
    jp = jax.tree.map(jnp.asarray, params)
    return jp, mod.init(jp, cfg)


def _run(name, params, grads, jp, js, tstate, first_step):
    _, jcfg, jupdate = _jax_opt(name)
    tmod, tcfg = get_optimizer(name, lr=LR)
    tp, ts = tstate["params"], tstate["opt"]
    differ = 0
    for i, g in enumerate(grads):
        step = first_step + i
        jscale = jax_lr_schedule(jnp.asarray(step), warmup=1, total=10)
        scale = lr_schedule(step, warmup=1, total=10)
        before = (_x_before_quantize(js["m"], js["v"], g, jcfg)
                  if name == "adamw8bit" else None)
        jp, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp, jscale)
        ts = tmod.update(from_jax(g, device="cpu"), ts, tp, tcfg,
                         lr_scale=scale)
        for a, b in zip(leaves(from_jax(_np(jp), device="cpu")),
                        leaves(tp)):
            np.testing.assert_allclose(b.detach().numpy(), a.numpy(),
                                       rtol=1e-6, atol=1e-7)
        if name == "adafactor":
            for a, b in zip(jax.tree.leaves(_np(js["factored"])),
                            leaves(ts["factored"])):
                assert a.shape == tuple(b.shape)
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-6)
        else:
            jm, jv = _np(js["m"]), _np(js["v"])
            differ += _check_q8(ts["m"], jm, before, 0)
            differ += _check_q8(ts["v"], jv, before, 1)
        assert ts["count"] == int(js["count"])
    if name == "adamw8bit":
        print(f"{name}: {differ} int8 payload elements differ (near-ties)")
    return jp, js, tp, ts


def three_updates(setup, name):
    params, grads = setup
    jp, js = _jax_state(name, params)
    tmod, tcfg = get_optimizer(name, lr=LR)
    tp = from_jax(params, device="cpu")
    _run(name, params, grads, jp, js,
         {"params": tp, "opt": tmod.init(tp, tcfg)}, 0)


def update_from_converted_state(setup, name):
    params, grads = setup
    _, _, jupdate = _jax_opt(name)
    jp, js = _jax_state(name, params)
    for step, g in enumerate(grads[:2]):
        jp, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp,
                         jax_lr_schedule(jnp.asarray(step), warmup=1,
                                         total=10))
    state = from_jax_state({"params": _np(jp), "opt": _np(js),
                            "step": np.asarray(2, np.int32)}, device="cpu")
    assert state["step"] == 2 and state["opt"]["count"] == 2
    _run(name, params, grads[2:], jp, js, state, 2)


def test_three_updates_match_jax(setup):
    three_updates(setup, "adamw8bit")


def test_update_from_a_converted_jax_state_matches_jax(setup):
    update_from_converted_state(setup, "adamw8bit")


def test_stacked_rank_decides_the_state_layout(setup):
    """What the JAX stacked tree decides, in the port's tree: 8-bit
    moments for the 1-D period leaves, fp32 for ``final_norm``;
    Adafactor's ``vr`` ``[P]`` and ``vc`` ``[d]`` for a 1-D period
    leaf."""
    params, _ = setup
    tp = from_jax(params, device="cpu")
    mod, cfg = get_optimizer("adamw8bit")
    m = mod.init(tp, cfg)["m"]
    for period in m["periods"]:
        scale = period["l0"]["mixer_norm"]["scale"]
        assert isinstance(scale, Q8) and tuple(scale.scale.shape) == (1,)
    assert isinstance(m["final_norm"]["scale"], torch.Tensor)
    mod, cfg = get_optimizer("adafactor")
    f = mod.init(tp, cfg)["factored"]
    d = params["final_norm"]["scale"].shape[0]
    st = f["periods"]["l0"]["mixer_norm"]["scale"]
    assert tuple(st["vr"].shape) == (2,) and tuple(st["vc"].shape) == (d,)
    assert set(f["final_norm"]["scale"]) == {"v"}
    up = f["periods"]["l1"]["moe"]["experts"]["w_up"]
    e, dm, h = tp["periods"][0]["l1"]["moe"]["experts"]["w_up"].shape
    assert tuple(up["vr"].shape) == (2, e, dm)
    assert tuple(up["vc"].shape) == (2, e, h)
