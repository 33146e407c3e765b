"""Parameter gradients of the training loss under NONE, S1 and S2, the
port against ``jax.grad`` of the JAX package, on the CPU in fp32 at
moe-gpt3-s's reduced size with n = 2 chunks (S3, S4 and layer remat in
``test_torch_train_grads_recompute.py``, which shares ``check``; the
two files run on separate test workers).

Under S1–S4 the port recomputes each MoE chunk through
``torch.utils.checkpoint`` (S1/S3 taking T_DI from the stash instead of
re-dispatching, which on the CPU stays on the device, as the JAX package
turns an offload into a device save there); under NONE it keeps
everything. Every leaf's gradient is held within rtol 1e-4, atol 1e-6:
the two frameworks sum in a different order, and the largest difference
seen is ~2e-7. Routing must agree exactly, which the loss equality
(rtol 1e-5) shows: a flipped route would move it by far more.
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
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.models import lm as tlm
from repro_torch.models.module import leaves
from test_torch_train import jax_params

_PARAMS = {}


def _setup():
    if not _PARAMS:
        cfg = jax_config("moe-gpt3-s").reduced()
        params = jax_params(cfg, 0)
        _PARAMS["jax"] = params
        _PARAMS["np"] = jax.tree.map(np.asarray, params)
        _PARAMS["batch"] = JaxTokens(cfg, batch=4, seq=32,
                                     seed=0).batch_at(0)
    return _PARAMS["jax"], _PARAMS["np"], _PARAMS["batch"]


def check(strategy, remat):
    jparams, pnp, batch = _setup()
    cfgs = []
    for get in (jax_config, get_config):
        c = get("moe-gpt3-s").reduced()
        cfgs.append(dataclasses.replace(
            c, remat_policy=remat, moe=dataclasses.replace(
                c.moe, num_partitions=2, memory_reuse_strategy=strategy)))
    jcfg, tcfg = cfgs
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))(
            jparams, jax.tree.map(jnp.asarray, batch))
    tparams = from_jax(pnp, device="cpu")
    flat = [p.requires_grad_(True) for p in leaves(tparams)]
    lt, _ = tlm.loss_fn(tparams, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, tcfg)
    gt = torch.autograd.grad(lt, flat, allow_unused=True)
    np.testing.assert_allclose(float(lj), float(lt.detach()), rtol=1e-5)
    want = leaves(from_jax(jax.tree.map(np.asarray, gj), device="cpu"))
    assert len(want) == len(gt)
    for a, b in zip(want, gt):
        b = torch.zeros_like(a) if b is None else b
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("strategy", ["none", "s1", "s2"])
def test_gradients_match_jax(strategy):
    check(strategy, "nothing")
