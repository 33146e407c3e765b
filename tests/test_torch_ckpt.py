"""Checkpoint/restart of the port: ``repro_torch.ckpt.Checkpointer`` and
``train(checkpointer=...)``, on the CPU at moe-gpt3-s's reduced size.

* The JAX package's four checkpointer cases (``tests/test_substrate.py``:
  round trip, keep-k, a ``.tmp`` directory ignored, async then wait) on a
  torch state, Python ints included.
* ``save`` copies every leaf before it returns: a leaf written in place
  right after it (as the optimizers write theirs) is restored with its
  saved value.
* ``train`` to step 4 with ``ckpt_every=2``, then a new run over the
  same directory to 6: its history starts at 4, and its parameters are
  bit-equal to an uninterrupted 6-step port run (fp32 AdamW, 8-bit AdamW
  and Adafactor) and, under fp32 AdamW, within
  ``test_torch_train_curve.py``'s tolerances of the JAX package's 6-step
  ``train`` from the same weights (losses rtol 1e-5, final parameters
  atol 1e-5).
* An optimizer update that fails once, with a checkpointer, rolls back
  to the latest checkpoint and re-runs from there: the run ends
  bit-equal to the uninterrupted one.
* The launcher's ``--ckpt-dir`` / ``--ckpt-every`` resume at the saved
  step.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import SyntheticTokens as JaxTokens
from repro.runtime import TrainOptions as JaxOptions
from repro.runtime import train as jax_train
from repro_torch.ckpt import Checkpointer
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.data import SyntheticTokens
from repro_torch.models.module import leaves
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.adamw import Q8
from repro_torch.runtime import TrainOptions, init_state, train
from test_torch_train import jax_params, jax_state

STEPS = 6
KW = dict(lr=1e-3, warmup=2, total_steps=STEPS)


def _state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v), "b": torch.zeros(4)},
            "opt": {"m": Q8(torch.full((4, 4), int(v), dtype=torch.int8),
                            torch.full((4, 1), v)), "count": int(v)},
            "step": int(v)}


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save(10, _state(1.0), block=True)
    like = _state()
    w = like["params"]["w"]
    out = ck.restore_latest(like=like)
    assert out["step"] == 10
    st = out["state"]
    assert st["params"]["w"] is w                    # restored in place
    assert torch.equal(w, torch.full((4, 4), 1.0))
    assert isinstance(st["opt"]["m"], Q8)
    assert torch.equal(st["opt"]["m"].q, torch.ones(4, 4, dtype=torch.int8))
    assert st["step"] == 1 and type(st["opt"]["count"]) is int
    flat = ck.restore(10)                            # no like: flat dict
    assert flat["opt/m/q"].dtype == np.int8 and int(flat["step"]) == 1


def test_checkpoint_keep_k_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(float(s)), block=True)
    assert ck.list_steps() == [3, 4]
    assert ck.restore_latest(like=_state())["step"] == 4


def test_checkpoint_atomic_ignores_tmp(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(1, _state(1.0), block=True)
    os.makedirs(os.path.join(str(tmp_path), "step_0000000002.tmp"))
    assert ck.list_steps() == [1]          # half-written ckpt invisible


def test_checkpoint_async_then_wait(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(7, _state(2.0))                # async
    ck.wait()
    assert ck.list_steps() == [7]


def test_save_copies_before_it_returns(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _state(1.0)
    ck.save(3, state)                      # async: the writer runs later
    state["params"]["w"].add_(5.0)         # as an optimizer writes
    state["opt"]["m"].q.fill_(9)
    ck.wait()
    out = ck.restore(3, like=_state())
    assert torch.equal(out["params"]["w"], torch.full((4, 4), 1.0))
    assert torch.equal(out["opt"]["m"].q, torch.ones(4, 4, dtype=torch.int8))
    with pytest.raises(TypeError, match="numpy cannot hold"):
        ck.save(4, {"w": torch.zeros(2, dtype=torch.bfloat16)})


def _cfg(optimizer="adamw"):
    c = get_config("moe-gpt3-s").reduced()
    return dataclasses.replace(c, optimizer=optimizer, moe=dataclasses.replace(
        c.moe, num_partitions=2, memory_reuse_strategy="s3"))


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config("moe-gpt3-s").reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, num_partitions=2, memory_reuse_strategy="s3"))
    return jcfg, jax.tree.map(np.asarray, jax_params(jcfg, 0))


def _fresh(cfg, weights):
    params = from_jax(weights[1], device="cpu")
    return init_state(cfg, TrainOptions(**KW), device="cpu", params=params)


def _run(cfg, weights, steps, **kw):
    return train(cfg, steps=steps, opts=TrainOptions(**KW), adaptive=False,
                 batch_source=SyntheticTokens(cfg, 2, 16, seed=5),
                 state=_fresh(cfg, weights), **kw)


def _bits_equal(a, b):
    la = [x for x in leaves(a) if isinstance(x, torch.Tensor)]
    lb = [x for x in leaves(b) if isinstance(x, torch.Tensor)]
    assert len(la) == len(lb) > 0
    return all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit", "adafactor"])
def test_resumed_run_is_bit_equal_to_an_uninterrupted_one(
        tmp_path, weights, optimizer):
    cfg = _cfg(optimizer)
    ref, ref_hist = _run(cfg, weights, STEPS)
    ck = Checkpointer(str(tmp_path), keep=3)
    first, hist = _run(cfg, weights, 4, checkpointer=ck, ckpt_every=2)
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert ck.list_steps() == [2, 4]
    # a new process: fresh weights, restored from the latest checkpoint
    state, hist = _run(cfg, weights, STEPS,
                       checkpointer=Checkpointer(str(tmp_path), keep=3),
                       ckpt_every=2)
    assert [h["step"] for h in hist] == [4, 5]
    assert state["step"] == STEPS
    assert [h["loss"] for h in hist] == [h["loss"] for h in ref_hist[4:]]
    assert _bits_equal(state["params"], ref["params"])
    assert _bits_equal(state["opt"], ref["opt"])
    if optimizer != "adamw":
        return
    jcfg, pnp = weights
    jstate = jax_state(jcfg, jax.tree.map(jax.numpy.asarray, pnp), KW["lr"])
    jstate, jhist = jax_train(jcfg, steps=STEPS, opts=JaxOptions(**KW),
                              batch_source=JaxTokens(jcfg, 2, 16, seed=5),
                              state=jstate, adaptive=False)
    np.testing.assert_allclose([h["loss"] for h in jhist[4:]],
                               [h["loss"] for h in hist], rtol=1e-5)
    for a, b in zip(leaves(from_jax(jax.tree.map(np.asarray,
                                                 jstate["params"]),
                                    device="cpu")),
                    leaves(state["params"])):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=0,
                                   atol=1e-5)


def test_failed_update_rolls_back_to_the_checkpoint(tmp_path, weights,
                                                    monkeypatch):
    cfg = _cfg()
    ref, ref_hist = _run(cfg, weights, 4)
    calls = []
    update = tadamw.update

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 4:                 # step 3, after the save at 2
            raise RuntimeError("out of memory in the update")
        return update(*a, **kw)

    monkeypatch.setattr(tadamw, "update", flaky)
    state, hist = _run(cfg, weights, 4, ckpt_every=2,
                       checkpointer=Checkpointer(str(tmp_path)))
    assert len(calls) == 6                  # steps 0-3, then 2 and 3 again
    assert [h["step"] for h in hist] == [0, 1, 2, 2, 3]
    assert [h["loss"] for h in hist[3:]] == [h["loss"]
                                             for h in ref_hist[2:]]
    assert _bits_equal(state["params"], ref["params"])
    assert _bits_equal(state["opt"], ref["opt"])


def test_launcher_resumes_from_ckpt_dir(tmp_path, capsys):
    from repro_torch.launch import train as launcher
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    hist = launcher.main(argv + ["--steps", "2"])
    assert [h["step"] for h in hist] == [0, 1]
    assert Checkpointer(str(tmp_path)).list_steps() == [2]
    hist = launcher.main(argv + ["--steps", "3"])
    assert [h["step"] for h in hist] == [2]
    assert Checkpointer(str(tmp_path)).list_steps() == [2, 3]
    capsys.readouterr()
