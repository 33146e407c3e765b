"""The training slice's pieces, the port against the JAX package, on the
CPU in fp32 at moe-gpt3-s's reduced size (2 layers, d 64, 4 experts).

The same weights (the JAX package's init, converted) and the same
``SyntheticTokens`` batch go through both packages. Held here:

* ``SyntheticTokens`` batches are byte-equal;
* one AdamW update and ``lr_schedule`` equal JAX within rtol 1e-6 (both
  compute in float32 in the same order of operations);
* ``lm.loss_fn``'s loss and metrics equal JAX within rtol 1e-5;
* one train step with ``grad_accum=2``: metrics within rtol 1e-5 and the
  updated parameters within atol 1e-6 (one AdamW step of lr 1e-3 moves a
  parameter by at most ~1e-3; the gradients agree to ~1e-7);
* the launcher runs 3 steps on the CPU (its offline resolve on the
  ``cpu-host`` spec, which has no host offload, picks S4), and the
  training entries the port lacks (MLA training, a non-token frontend's
  data) raise ``NotImplementedError`` naming ROADMAP.md.

Gradients under each strategy are in ``test_torch_train_grads.py``, the
10-step curve in ``test_torch_train_curve.py``; both take their weights
from ``jax_params`` here. The weights are drawn with numpy into the JAX
package's parameter tree (its ``abstract_params``), which takes
milliseconds where its jitted ``init`` takes seconds on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import SyntheticTokens as JaxTokens
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import lr_schedule as jax_lr_schedule
from repro.runtime import TrainOptions as JaxOptions
from repro.runtime import make_train_step as jax_make_step
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.data import SyntheticTokens
from repro_torch.models import lm as tlm
from repro_torch.models.module import leaves
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import get_optimizer, lr_schedule
from repro_torch.runtime import TrainOptions, init_state, make_train_step
from repro_torch.runtime import train


def jax_params(cfg, seed: int):
    """JAX parameter tree of ``cfg`` with numpy-drawn values: norm scales
    near 1, every other leaf normal with std 1/sqrt(fan-in)."""
    r = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "scale":
            x = 1.0 + 0.1 * r.standard_normal(leaf.shape)
        else:
            fan_in = int(np.prod(leaf.shape[1:-1])) if len(leaf.shape) > 2 \
                else leaf.shape[0]
            x = r.standard_normal(leaf.shape) / np.sqrt(max(fan_in, 1))
        return jnp.asarray(x.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, jlm.abstract_params(cfg))


def jax_state(cfg, params, lr: float):
    """The JAX package's train state (what its ``init_state`` builds)
    around ``params``."""
    return {"params": params,
            "opt": jadamw.init(params, jadamw.AdamWConfig(lr=lr)),
            "step": jnp.zeros((), jnp.int32)}


def _cfgs(strategy="none", n=2):
    out = []
    for get in (jax_config, get_config):
        c = get("moe-gpt3-s").reduced()
        out.append(dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, num_partitions=n, memory_reuse_strategy=strategy)))
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_synthetic_tokens_byte_equal():
    jcfg, tcfg = _cfgs()
    for step in (0, 1, 17):
        a = JaxTokens(jcfg, batch=4, seq=32, seed=3).batch_at(step)
        b = SyntheticTokens(tcfg, batch=4, seq=32, seed=3).batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes()


def test_adamw_update_and_lr_schedule_match_jax():
    r = np.random.default_rng(0)
    params = {"a": r.standard_normal((5, 7)).astype(np.float32),
              "b": [r.standard_normal((3,)).astype(np.float32)]}
    jcfg = jadamw.AdamWConfig(lr=1e-3)
    tmod, tcfg = get_optimizer("adamw", lr=1e-3)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.init(jp, jcfg)
    tp = jax.tree.map(torch.from_numpy, params)
    ts = tmod.init(tp, tcfg)
    for step in range(3):
        g = jax.tree.map(lambda p: r.standard_normal(p.shape).astype(
            np.float32), params)
        scale = lr_schedule(step, warmup=1, total=5)
        jscale = jax_lr_schedule(jnp.asarray(step), warmup=1, total=5)
        np.testing.assert_allclose(scale, float(jscale), rtol=1e-6)
        jp, js = jadamw.update(jax.tree.map(jnp.asarray, g), js, jp, jcfg,
                               lr_scale=jscale)
        ts = tadamw.update(jax.tree.map(torch.from_numpy, g), ts, tp, tcfg,
                           lr_scale=scale)
        for a, b in zip(leaves(_np(jp)), leaves(tp)):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-6, atol=1e-7)
    assert ts["count"] == 3
    for s in (0, 50, 100, 5000, 10_000, 12_000):
        np.testing.assert_allclose(lr_schedule(s),
                                   float(jax_lr_schedule(jnp.asarray(s))),
                                   rtol=1e-6)


def test_loss_fn_matches_jax():
    jcfg, tcfg = _cfgs()
    params = jax_params(jcfg, 0)
    batch = JaxTokens(jcfg, batch=4, seq=32, seed=0).batch_at(0)
    lj, mj = jax.jit(lambda p, b: jlm.loss_fn(p, b, jcfg))(
        params, jax.tree.map(jnp.asarray, batch))
    lt, mt = tlm.loss_fn(from_jax(_np(params), device="cpu"),
                         _torch_batch(batch), tcfg)
    for k in ("ce", "aux_loss", "z_loss", "loss"):
        np.testing.assert_allclose(float(mj[k]), float(mt[k]), rtol=1e-5)
    assert float(mt["aux_loss"]) > 0 and float(mt["z_loss"]) > 0


def test_grad_accum_step_matches_jax():
    jcfg, tcfg = _cfgs()
    jopts = JaxOptions(lr=1e-3, warmup=0, total_steps=10, grad_accum=2)
    topts = TrainOptions(lr=1e-3, warmup=0, total_steps=10, grad_accum=2)
    jstate = jax_state(jcfg, jax_params(jcfg, 1), jopts.lr)
    tstate = init_state(tcfg, topts, device="cpu",
                        params=from_jax(_np(jstate["params"]),
                                        device="cpu"))
    batch = JaxTokens(jcfg, batch=4, seq=16, seed=2).batch_at(0)
    jstate, jm = jax.jit(jax_make_step(jcfg, jopts))(
        jstate, jax.tree.map(jnp.asarray, batch))
    tstate, tm = make_train_step(tcfg, topts)(tstate, _torch_batch(batch))
    for k in ("ce", "aux_loss", "z_loss", "loss", "grad_norm", "lr_scale"):
        np.testing.assert_allclose(float(jm[k]), tm[k], rtol=1e-5)
    assert tstate["step"] == 1
    for a, b in zip(leaves(from_jax(_np(jstate["params"]), device="cpu")),
                    leaves(tstate["params"])):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=0,
                                   atol=1e-6)


def test_launcher_trains_three_steps_on_cpu(capsys):
    from repro_torch.launch import train as launcher
    hist = launcher.main(["--reduced", "--device", "cpu", "--steps", "3",
                          "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "MPipeMoE: n=2 strategy=s4" in out      # resolved on cpu-host
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_unported_training_entries_raise(tmp_path):
    """What the port still lacks in training raises
    ``NotImplementedError`` naming ROADMAP.md: MLA training and a
    non-token frontend's data. Checkpoints under a ``DistContext`` and a
    restore onto target shardings are ported
    (``tests/test_torch_ep_state.py``): here a one-rank layout restores
    what was saved."""
    from repro_torch.ckpt import Checkpointer, Layout
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        SyntheticTokens(dataclasses.replace(tcfg, frontend="vision_stub"),
                        batch=2, seq=8)
    mla = get_config("deepseek-v2-lite-16b").reduced()
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tlm.loss_fn(tlm.init(mla, 0, device="cpu"),
                    {"tokens": tokens, "labels": tokens}, mla)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.arange(2.0)}, block=True)
    whole = Layout(rank=0, world=1, cut=lambda key, ndim: (),
                   owns=lambda key, ndim: True)
    out = ck.restore(1, like={"w": torch.zeros(2)}, shardings=whole)
    assert torch.equal(out["w"], torch.arange(2.0))


def _one_step(tcfg, **kw):
    opts = TrainOptions(lr=1e-3, warmup=0, total_steps=2)
    state = init_state(tcfg, opts, device="cpu",
                       params=tlm.init(tcfg, 3, device="cpu"))
    return train(tcfg, steps=1, opts=opts, state=state, device="cpu",
                 batch_source=SyntheticTokens(tcfg, batch=2, seq=16, seed=4),
                 **kw)


def test_failed_backward_is_retried_from_the_same_state(monkeypatch):
    """A loss or backward pass that fails writes nothing, so its retry
    gives the run that never failed, exactly."""
    _, tcfg = _cfgs()
    ref_state, ref_hist = _one_step(tcfg)
    calls = []
    loss_fn = tlm.loss_fn

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("transient")
        return loss_fn(*a, **kw)

    monkeypatch.setattr(tlm, "loss_fn", flaky)
    state, hist = _one_step(tcfg)
    assert len(calls) == 2
    assert [h["loss"] for h in hist] == [h["loss"] for h in ref_hist]
    for a, b in zip(leaves(state["params"]), leaves(ref_state["params"])):
        assert torch.equal(a, b)


def test_failed_update_raises_without_retry(monkeypatch):
    """The update writes the parameters and moments in place: a failure
    there is not retried, since a retry would step them twice."""
    _, tcfg = _cfgs()
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise RuntimeError("out of memory in the update")

    monkeypatch.setattr(tadamw, "update", broken)
    with pytest.raises(RuntimeError, match="update"):
        _one_step(tcfg, max_retries=2)
    assert len(calls) == 1
