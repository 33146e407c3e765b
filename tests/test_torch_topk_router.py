"""The top-k router kernel's plain version and ``route``, the port
against the JAX package, on the CPU in fp32.

The plain version (``repro_torch.kernels.topk_router.ref``, what the
wrapper runs on CPU tensors) is held against the JAX package's Pallas
kernel in interpret mode and against its jnp ``topk_router_ref``:
indices equal, probabilities within atol 1e-6 (the limit of the JAX
package's own kernel test; the two sum the softmax in another order).
``route``'s gradients are held against ``jax.grad`` of the JAX ``route``
within rtol 1e-5, atol 1e-6. ``route_plan_ref`` (the fused launch's
plain version) is held against the JAX ``route`` followed by
``dispatch_plan``, jitted: indices, destinations and flags equal,
ties and overflow included, probabilities within atol 1e-6, and the aux
losses built from its statistics within rtol = atol = 1e-5. The CUDA
kernel itself is held against the plain versions on the card
(``test_torch_train_cuda.py``, ``test_torch_topk_router_cuda.py``).
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
from repro.moe import dispatch as jdisp
from repro.moe import router as jrouter
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.topk_router import (route_plan, route_plan_ref,
                                             topk_router, topk_router_ref)
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


def _cfg_for(e, k):
    """The reduced JAX config with E experts and top-k, d_model = E: with
    ``w_gate`` the identity, the JAX ``route`` sees the logits as given."""
    cfg = jax_config("moe-gpt3-s").reduced()
    return dataclasses.replace(cfg, d_model=e, moe=dataclasses.replace(
        cfg.moe, num_experts=e, top_k=k))


@pytest.mark.parametrize("t,e,k,cap,ties", [
    (64, 8, 2, 4, True),        # overflow past C 4, ties
    (40, 64, 1, 1, True),       # C 1: every second route to an expert drops
    (48, 16, 6, 8, False),      # DeepSeek's k 6
    (256, 64, 1, 8, False),     # moe-gpt3-s, capacity_for(256, 1, 1.25, 64)
    (17, 8, 8, 3, False),       # k = E
])
def test_route_plan_ref_matches_jax_route_then_dispatch_plan(t, e, k, cap,
                                                             ties):
    x = _logits(t, e, seed=3 * t + e + k, ties=ties)
    cfg = _cfg_for(e, k)
    eye = jnp.eye(e, dtype=jnp.float32)

    @jax.jit
    def jax_path(x_):
        p, i, aux = jrouter.route({"w_gate": eye}, x_, cfg)
        d, v = jdisp.dispatch_plan(i, e, cap)
        return p, i, d, v, aux

    pj, ij, dj, vj, auxj = jax_path(jnp.asarray(x))
    pt, it, dt_, vt, st = route_plan_ref(
        torch.from_numpy(x), k, cap, stats=True,
        aux_loss_weight=cfg.moe.aux_loss_weight,
        z_loss_weight=cfg.moe.z_loss_weight)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_array_equal(np.asarray(dj), dt_.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), rtol=0, atol=1e-6)
    assert dt_.dtype == torch.int32 and vt.dtype == torch.bool
    if cap * e < t * k:
        assert not vt.all() and (dt_.numpy()[~vt.numpy()] == e * cap).all()
    for key in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(np.asarray(auxj[key]), st[key].numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        st["primary_count"].numpy(), np.bincount(it.numpy()[:, 0],
                                                 minlength=e))


def test_route_plan_on_cpu_takes_plain_version_without_launching():
    x = torch.from_numpy(_logits(48, 16, seed=2, ties=True))
    build.reset_launches()
    got = route_plan(x, 2, 5, stats=True)
    want = route_plan_ref(x, 2, 5, stats=True)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    for key in want[4]:
        assert torch.equal(got[4][key], want[4][key])
    xg = x.clone().requires_grad_(True)     # the autograd path as well
    p, i, d, v = route_plan(xg, 2, 5)
    assert p.requires_grad and not d.requires_grad
    assert torch.equal(d, want[2]) and torch.equal(i, want[1])
    assert build.LAUNCHES["topk_router"] == 0
    with pytest.raises(ValueError):
        route_plan(x, 2, 0)                  # capacity < 1
    with pytest.raises(ValueError):
        route_plan(x, 17, 5)                 # k > E
