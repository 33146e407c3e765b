"""``train(adaptive=...)`` of the port against the JAX package's
``train``, on the CPU at moe-gpt3-s's reduced size (2 layers, fp32).

Both start from the same weights (``test_torch_train.jax_params``), read
the same ``VaryingSyntheticTokens`` batches (4, 8 and 4 sequences of 16
tokens) and resolve ``(n, strategy)`` through their controllers with the
same fake clock, whose optimum moves with the batch. The per-step
``(n, strategy)``, the step functions built and the searches must be
equal, and the loss, ce and grad norm within rtol 1e-5 (the tolerance of
``test_torch_train_curve.py``).
"""
import dataclasses

import jax
import numpy as np

from repro.configs import get_config as jax_config
from repro.data import VaryingSyntheticTokens as JaxVarying
from repro.runtime import AdaptiveController as JaxController
from repro.runtime import AdaptiveOptions as JaxAdaptiveOptions
from repro.runtime import TrainOptions as JaxOptions
from repro.runtime import train as jax_train
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.data import VaryingSyntheticTokens
from repro_torch.runtime import (AdaptiveController, AdaptiveOptions,
                                 TrainOptions, init_state, train)
from test_torch_train import jax_params, jax_state


def _adaptive(get):
    base = get("moe-gpt3-s").reduced()
    return dataclasses.replace(
        base, num_layers=2, compute_dtype="float32",
        moe=dataclasses.replace(base.moe, num_partitions=0,
                                memory_reuse_strategy="adaptive"))


def _steep_clock(b, n, strategy):
    """A fake clock whose optimum moves with the batch: n 1 at 64 tokens,
    n 2 at 128."""
    ideal = max(1, b // 64)
    return abs(n - ideal) + 0.01 * n


def test_train_adaptive_matches_jax():
    jcfg, tcfg = _adaptive(jax_config), _adaptive(get_config)
    kw = dict(lr=1e-3, warmup=1, total_steps=3)
    trace = (4, 8, 4)
    jstate = jax_state(jcfg, jax_params(jcfg, 0), kw["lr"])
    tstate = init_state(tcfg, TrainOptions(**kw), device="cpu",
                        params=from_jax(jax.tree.map(np.asarray,
                                                     jstate["params"]),
                                        device="cpu"))
    jctl = JaxController(jcfg, JaxOptions(**kw), aopts=JaxAdaptiveOptions(
        measure_fn=_steep_clock, candidates=(1, 2, 4)))
    tctl = AdaptiveController(tcfg, TrainOptions(**kw), AdaptiveOptions(
        measure_fn=_steep_clock, candidates=(1, 2, 4)))
    _, jhist = jax_train(jcfg, steps=3, opts=JaxOptions(**kw),
                         batch_source=JaxVarying(jcfg, trace, 16, seed=5),
                         state=jstate, adaptive=jctl)
    _, thist = train(tcfg, steps=3, opts=TrainOptions(**kw),
                     batch_source=VaryingSyntheticTokens(tcfg, trace, 16,
                                                         seed=5),
                     state=tstate, adaptive=tctl)
    assert [(h["n"], h["strategy"]) for h in thist] == \
        [(h["n"], h["strategy"]) for h in jhist] == \
        [(1, "s4"), (2, "s4"), (1, "s4")]
    assert tctl.rejit_count == jctl.rejit_count == 2
    assert tctl.resolver.search_calls == jctl.resolver.search_calls
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in thist],
                                   [h[key] for h in jhist], rtol=1e-5)
