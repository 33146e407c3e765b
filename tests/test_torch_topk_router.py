"""The top-k router kernel's plain version and ``route``, the port
against the JAX package, on the CPU in fp32.

The plain version (``repro_torch.kernels.topk_router.ref``, what the
wrapper runs on CPU tensors) is held against the JAX package's Pallas
kernel in interpret mode and against its jnp ``topk_router_ref``:
indices equal, probabilities within atol 1e-6 (the limit of the JAX
package's own kernel test; the two sum the softmax in another order).
``route``'s gradients are held against ``jax.grad`` of the JAX ``route``
within rtol 1e-5, atol 1e-6. The CUDA kernel itself is held against the
plain version on the card (``test_torch_train_cuda.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.topk_router import topk_router as jax_kernel
from repro.kernels.topk_router import topk_router_ref as jax_ref
from repro.moe import router as jrouter
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.topk_router import topk_router, topk_router_ref
from repro_torch.moe import router as trouter


def _logits(t, e, seed, ties=False):
    x = np.random.default_rng(seed).standard_normal((t, e))
    x = x.astype(np.float32)
    if ties:
        x[: t // 2, 3] = x[: t // 2].max(axis=1) + 1.0   # equal maxima at
        x[: t // 2, 7] = x[: t // 2, 3]                 # experts 3 and 7
        x[t // 2:, :] = 0.5                             # every expert ties
    return x


@pytest.mark.parametrize("t,e,k,ties", [(256, 64, 1, False),
                                        (300, 16, 2, False),
                                        (64, 8, 2, True),
                                        (40, 64, 1, True),
                                        (48, 128, 6, False)])
def test_plain_version_matches_jax_kernel_and_ref(t, e, k, ties):
    x = _logits(t, e, seed=t + e + k, ties=ties)
    pt, it = topk_router_ref(torch.from_numpy(x), k)
    pk, ik = jax_kernel(jnp.asarray(x), k)
    pr, ir = jax_ref(jnp.asarray(x), k)
    for p, i in ((pk, ik), (pr, ir)):
        np.testing.assert_array_equal(np.asarray(i), it.numpy())
        np.testing.assert_allclose(np.asarray(p), pt.numpy(), rtol=0,
                                   atol=1e-6)
    assert it.dtype == torch.int32 and pt.dtype == torch.float32
    if ties:                               # lowest index wins a tie
        assert (it.numpy()[: t // 2, 0] == 3).all()
        assert (it.numpy()[t // 2:, 0] == 0).all()
        if k > 1:
            assert (it.numpy()[: t // 2, 1] == 7).all()
            assert (it.numpy()[t // 2:, 1] == 1).all()


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    x = torch.from_numpy(_logits(32, 16, seed=1))
    build.reset_launches()
    p, i = topk_router(x, 2)
    pr, ir = topk_router_ref(x, 2)
    assert torch.equal(p, pr) and torch.equal(i, ir)
    assert build.LAUNCHES["topk_router"] == 0
    with pytest.raises(ValueError):
        topk_router(x, 17)                    # k > E


@pytest.mark.parametrize("k", [1, 2])
def test_route_gradients_match_jax(k):
    jcfg = jax_config("moe-gpt3-s").reduced()
    tcfg = get_config("moe-gpt3-s").reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             top_k=k))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                             top_k=k))
    r = np.random.default_rng(10 + k)
    w = (r.standard_normal((64, 4)) * 0.5).astype(np.float32)
    x = r.standard_normal((24, 64)).astype(np.float32)
    wp = r.standard_normal((24, k)).astype(np.float32)   # weights on probs

    def jloss(w_, x_):
        p, _, aux = jrouter.route({"w_gate": w_}, x_, jcfg)
        return jnp.sum(p * wp) + aux["aux_loss"] + aux["z_loss"]

    gw_j, gx_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w),
                                                 jnp.asarray(x))
    wt = torch.from_numpy(w).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    p, idx, aux = trouter.route({"w_gate": wt}, xt, tcfg)
    loss = (p * torch.from_numpy(wp)).sum() + aux["aux_loss"] \
        + aux["z_loss"]
    gw_t, gx_t = torch.autograd.grad(loss, (wt, xt))
    pj, ij, _ = jrouter.route({"w_gate": jnp.asarray(w)}, jnp.asarray(x),
                              jcfg)
    np.testing.assert_array_equal(np.asarray(ij), idx.numpy())
    for a, b in ((gw_j, gw_t), (gx_j, gx_t)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
