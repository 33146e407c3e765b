"""Layer remat ``"dots"``, the port against the JAX package, on the CPU
in fp32 at moe-gpt3-s's reduced size (4 layers, n = 2 chunks).

The JAX package wraps each period in ``jax.checkpoint`` with
``dots_with_no_batch_dims_saveable``; the port runs it under
``torch.utils.checkpoint`` with a selective-checkpoint policy
(``models.lm._dots_policy``) that saves the outputs of the products
without a batch dimension (``mm``, and ``bmm`` over a batch of 1, which
is where ``torch.einsum``'s projections land) and recomputes the rest.
Under NONE and S4 (whose MoE chunks are checkpoints nested inside the
period's):

* loss and gradients equal ``jax.value_and_grad`` under JAX's ``"dots"``
  within rtol 1e-5 (gradients also atol 1e-6, for elements near zero;
  the two frameworks sum in a different order);
* loss and gradients equal the port's ``"nothing"`` exactly: the
  recompute repeats the same ops on the same inputs;
* the bytes held for the backward pass after the forward lie strictly
  between ``"full"`` and ``"nothing"``. They are counted as the storages
  that the forward's ops made (seen by a ``TorchDispatchMode``) and that
  are still alive when it returns, parameters excluded: what autograd,
  the checkpoints and the selective cache keep. A
  ``saved_tensors_hooks`` count cannot tell the policies apart, since a
  non-reentrant checkpoint packs its region's tensors through its own
  hooks and the selective cache keeps the saved outputs outside them; it
  sees the same bytes under ``"full"`` and ``"dots"``.
"""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_config
from repro.data import SyntheticTokens as JaxTokens
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.models import lm as tlm
from repro_torch.models.module import leaves
from test_torch_train import jax_params


@pytest.fixture(scope="module")
def setup():
    cfg = jax_config("moe-gpt3-s").reduced()
    assert cfg.num_periods == 2
    params = jax_params(cfg, 0)
    batch = JaxTokens(cfg, batch=4, seq=32, seed=0).batch_at(0)
    return params, jax.tree.map(np.asarray, params), batch


def _cfg(get, strategy, remat):
    c = get("moe-gpt3-s").reduced()
    return dataclasses.replace(c, remat_policy=remat, moe=dataclasses.replace(
        c.moe, num_partitions=2, memory_reuse_strategy=strategy))


def _port(pnp, batch, cfg):
    params = from_jax(pnp, device="cpu")
    flat = [p.requires_grad_(True) for p in leaves(params)]
    loss, _ = tlm.loss_fn(params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, flat)]


@pytest.mark.parametrize("strategy", ["none", "s4"])
def test_dots_matches_jax_and_nothing(setup, strategy):
    jparams, pnp, batch = setup
    jcfg = _cfg(jax_config, strategy, "dots")
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))(
            jparams, jax.tree.map(jnp.asarray, batch))
    lt, gt = _port(pnp, batch, _cfg(get_config, strategy, "dots"))
    np.testing.assert_allclose(float(lj), float(lt), rtol=1e-5)
    want = leaves(from_jax(jax.tree.map(np.asarray, gj), device="cpu"))
    assert len(want) == len(gt)
    for a, b in zip(want, gt):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6)
    ln, gn = _port(pnp, batch, _cfg(get_config, strategy, "nothing"))
    assert torch.equal(lt, ln)
    assert all(torch.equal(a, b) for a, b in zip(gt, gn))


class _Born(TorchDispatchMode):
    """Records every storage an op makes: a weak reference and its
    bytes."""

    def __init__(self):
        super().__init__()
        self.made = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.made.setdefault(st.data_ptr(),
                                     (StorageWeakRef(st), st.nbytes()))
        return out


def _held_bytes(pnp, batch, cfg) -> int:
    params = from_jax(pnp, device="cpu")
    flat = [p.requires_grad_(True) for p in leaves(params)]
    own = {p.untyped_storage().data_ptr() for p in flat}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with _Born() as born:
        loss, _ = tlm.loss_fn(params, tb, cfg)
    gc.collect()
    held = sum(n for ptr, (ref, n) in born.made.items()
               if not ref.expired() and ptr not in own)
    loss.backward()                  # the graph is whole: it runs
    return held


@pytest.mark.parametrize("strategy", ["none", "s4"])
def test_dots_holds_less_than_nothing_and_more_than_full(setup, strategy):
    _, pnp, batch = setup
    held = {r: _held_bytes(pnp, batch, _cfg(get_config, strategy, r))
            for r in ("nothing", "dots", "full")}
    print(strategy, held)
    assert held["full"] < held["dots"] < held["nothing"]
