"""int8 gradient compression with error feedback: the port's
``distributed.compression`` against ``repro.distributed.compression``.

* ``compress_with_feedback`` run eagerly in JAX is held bit for bit
  over seeded trees shaped as a model's (period leaves stacked in JAX,
  a list in the port, so a period's 1-D leaf is compressed and the
  top-level one is not), with an all-zero row, a scalar and the error
  carried over three rounds.
* A ZeRO-3 shard (last dim split over dp, mesh (2, 1), gloo) takes its
  row maxima over the dp group: gathered, it is bit-equal to the whole
  leaf compressed on one process.
* Three steps of ``train(compress_grads=True)`` on reduced moe-gpt3-s
  match the JAX package's ``train``: each step's loss within rtol 1e-5
  and grad norm within rtol 1e-4 (a compressed gradient rounds to int8
  levels, so one level flipped by summation noise would move a single
  parameter by ~lr; the losses and norms are what the step's numbers
  can hold to a tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import SyntheticTokens as JaxTokens
from repro.distributed import compression as jcomp
from repro.optim import get_optimizer as jax_optimizer
from repro.runtime import TrainOptions as JaxOptions
from repro.runtime import train as jax_train
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.data import SyntheticTokens
from repro_torch.distributed.compression import (compress_with_feedback,
                                                 dequantize_int8,
                                                 quantize_int8)
from repro_torch.models.module import leaves
from repro_torch.runtime import TrainOptions, init_state, train
from torch_dense_harness import np_params
from torch_ep_harness import compress_rank, run_ranks


def _tree(seed):
    """A JAX-layout tree: periods stacked on axis 0 (P = 2)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * rng.uniform(1e-3, 10)  # noqa
                    ).astype(np.float32)
    w = f(2, 8, 12)
    w[1, 3] = 0.0                                 # an all-zero row
    return {"embed": {"tok": f(16, 8)},
            "periods": {"l0": {"norm": f(2, 8), "w": w, "b": f(2, 3, 1)}},
            "final_norm": {"scale": f(8), "step": np.float32(
                rng.standard_normal())}}


def _port(tree_np):
    return from_jax(tree_np, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_with_feedback_bit_equal_to_jax(seed):
    g_np = _tree(seed)
    jg, je = jax.tree.map(jnp.asarray, g_np), None
    tg, te = _port(g_np), None
    for _ in range(3):
        jg, je = jcomp.compress_with_feedback(jg, je)
        tg, te = compress_with_feedback(tg, te)
        for a, b in [(jg, tg), (je, te)]:
            want = leaves(_port(jax.tree.map(np.asarray, a)))
            got = leaves(b)
            assert len(want) == len(got)
            for x, y in zip(want, got):
                np.testing.assert_array_equal(y.numpy(), x.numpy())


def test_quantize_round_trip_bit_equal_to_jax():
    x = np.random.default_rng(7).standard_normal((5, 33)).astype(np.float32)
    x[2] = 0.0
    x[3, :4] = [0.5, -1.5, 2.5, 127.0]           # ties round half to even
    q, s = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    np.testing.assert_array_equal(dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jcomp.dequantize_int8(q, s)))


def test_zero3_shard_takes_row_max_over_dp():
    rng = np.random.default_rng(11)
    whole = rng.standard_normal((3, 6, 8)).astype(np.float32)
    whole[1, 2, :4] *= 100.0                 # the row's max on one rank
    error = (rng.standard_normal(whole.shape) * 1e-3).astype(np.float32)
    got = run_ranks(compress_rank, (2, 1), whole, error, 2)
    g = {"w": torch.from_numpy(whole)}
    e = {"w": torch.from_numpy(error)}
    for i in range(2):
        g, e = compress_with_feedback(g, e)
        for rank in got:
            np.testing.assert_array_equal(rank[i][0], g["w"].numpy())
            np.testing.assert_array_equal(rank[i][1], e["w"].numpy())


class _Source:
    def __init__(self, batches):
        self.batches = batches

    def batch_at(self, step):
        return self.batches[step]


def test_train_compress_grads_matches_jax():
    jcfg, tcfg = (get("moe-gpt3-s").reduced() for get in (jax_config,
                                                          get_config))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, num_partitions=2, memory_reuse_strategy="none"))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, num_partitions=2, memory_reuse_strategy="none"))
    params = np_params(jcfg, 0)
    src = JaxTokens(jcfg, batch=4, seq=32, seed=0)
    batches = _Source([src.batch_at(i) for i in range(3)])
    kw = dict(lr=1e-3, warmup=1, total_steps=3, compress_grads=True)
    opt_mod, ocfg = jax_optimizer(jcfg.optimizer, 1e-3)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = {"params": jparams, "opt": opt_mod.init(jparams, ocfg),
              "step": jnp.zeros((), jnp.int32),
              "grad_err": jax.tree.map(jnp.zeros_like, jparams)}
    _, jhist = jax_train(jcfg, steps=3, batch_source=batches,
                         opts=JaxOptions(**kw), state=jstate,
                         adaptive=False)
    opts = TrainOptions(**kw)
    state = init_state(tcfg, opts, params=from_jax(params, device="cpu"),
                       device="cpu")
    state, thist = train(tcfg, steps=3, batch_source=batches, opts=opts,
                         state=state, adaptive=False, device="cpu")
    for a, b in zip(jhist, thist):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"],
                                   rtol=1e-4)
    assert any(float(e.abs().max()) > 0 for e in leaves(state["grad_err"]))
