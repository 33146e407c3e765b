"""A 10-step training run, the port's ``train(adaptive=False)`` against
the JAX package's ``train()``, on the CPU in fp32 at moe-gpt3-s's
reduced size with n = 2 chunks under strategy S3.

Both start from the same weights (``test_torch_train.jax_params``), read the same
``SyntheticTokens`` batches and step AdamW with lr 1e-3, 2 warmup
steps, a 10-step cosine. The per-step loss, ce and grad norm are held
within rtol 1e-5, and the final parameters within atol 1e-5: ten AdamW
steps move a parameter by at most ~1e-2, and the gradients agree to
~1e-7, so any larger difference is a fault of the port, not rounding.
"""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.data import SyntheticTokens as JaxTokens
from repro.runtime import TrainOptions as JaxOptions
from repro.runtime import train as jax_train
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.data import SyntheticTokens
from repro_torch.models.module import leaves
from repro_torch.runtime import TrainOptions, init_state, train
from test_torch_train import jax_params, jax_state

STEPS = 10


def _cfg(get):
    c = get("moe-gpt3-s").reduced()
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, num_partitions=2, memory_reuse_strategy="s3"))


def test_ten_step_curve_and_final_params_match_jax():
    jcfg, tcfg = _cfg(jax_config), _cfg(get_config)
    kw = dict(lr=1e-3, warmup=2, total_steps=STEPS)
    jstate = jax_state(jcfg, jax_params(jcfg, 0), kw["lr"])
    tstate = init_state(tcfg, TrainOptions(**kw), device="cpu",
                        params=from_jax(jax.tree.map(np.asarray,
                                                     jstate["params"]),
                                        device="cpu"))
    jstate, jhist = jax_train(jcfg, steps=STEPS, opts=JaxOptions(**kw),
                              batch_source=JaxTokens(jcfg, 4, 32, seed=5),
                              state=jstate, adaptive=False)
    beats = []
    tstate, thist = train(tcfg, steps=STEPS, opts=TrainOptions(**kw),
                          batch_source=SyntheticTokens(tcfg, 4, 32, seed=5),
                          state=tstate, adaptive=False,
                          heartbeat=lambda s, m: beats.append(s))
    assert beats == list(range(STEPS))
    assert [h["step"] for h in thist] == list(range(STEPS))
    for key in ("loss", "ce", "grad_norm", "lr_scale"):
        np.testing.assert_allclose([h[key] for h in jhist],
                                   [h[key] for h in thist], rtol=1e-5)
    assert thist[-1]["loss"] < thist[0]["loss"]
    for a, b in zip(leaves(from_jax(jax.tree.map(np.asarray,
                                                 jstate["params"]),
                                    device="cpu")),
                    leaves(tstate["params"])):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=0,
                                   atol=1e-5)
    assert isinstance(tstate["params"]["embed"]["tok"], torch.Tensor)
