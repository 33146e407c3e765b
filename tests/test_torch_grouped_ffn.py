"""The grouped expert FFN kernel's plain version, the port against the
JAX package, on the CPU in fp32.

The plain version (``repro_torch.kernels.grouped_ffn.ref``, what the
wrapper runs on CPU tensors) is held against the JAX package's Pallas
kernel in interpret mode (``repro.kernels.grouped_ffn.grouped_ffn``,
which pads C = 100 to its 128-row tile) and its jnp ``grouped_ffn_ref``,
gated and not, with each activation, within atol 1e-5 (rtol 1e-5): the
frameworks sum in a different order. Gradients through the port's
autograd Function are held against ``jax.grad`` through the JAX custom
VJP within rtol 1e-4, atol 1e-5 (the limits of the JAX package's own
gradient test are 1e-4). Every activation the kernel takes maps 0 to
0, which its zero-expert skip rests on. The CUDA kernel itself is held
against the plain version on the card (``test_torch_train_cuda.py``,
``test_torch_grouped_ffn_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_ffn import grouped_ffn as jax_kernel
from repro.kernels.grouped_ffn import grouped_ffn_ref as jax_ref
from repro_torch.kernels import build
from repro_torch.kernels.grouped_ffn import grouped_ffn, grouped_ffn_ref

E, C, M, H = 2, 100, 32, 64


def _inputs(gated, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((E, C, M)).astype(np.float32)
    wu = (r.standard_normal((E, M, H)) / np.sqrt(M)).astype(np.float32)
    wg = ((r.standard_normal((E, M, H)) / np.sqrt(M)).astype(np.float32)
          if gated else None)
    wd = (r.standard_normal((E, H, M)) / np.sqrt(H)).astype(np.float32)
    return x, wu, wg, wd


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("gated", [False, True])
def test_plain_version_matches_jax_kernel_and_ref(act, gated):
    x, wu, wg, wd = _inputs(gated, seed=len(act) + gated)
    out = grouped_ffn_ref(*map(_t, (x, wu, wg, wd)), act)
    kern = jax_kernel(*map(_j, (x, wu, wg, wd)), act)
    ref = jax_ref(*map(_j, (x, wu, wg, wd)), act=act)
    assert out.shape == (E, C, M) and out.dtype == torch.float32
    for want in (kern, ref):
        np.testing.assert_allclose(np.asarray(want), out.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    x, wu, wg, wd = map(_t, _inputs(True, seed=3))
    build.reset_launches()
    out = grouped_ffn(x, wu, wg, wd, "silu")
    assert torch.equal(out, grouped_ffn_ref(x, wu, wg, wd, "silu"))
    assert build.LAUNCHES["grouped_ffn"] == 0
    with pytest.raises(ValueError):
        grouped_ffn(x, wu, wg, wd[:, :-1], "silu")


@pytest.mark.parametrize("gated,act", [(False, "gelu"), (True, "silu")])
def test_gradients_match_jax_custom_vjp(gated, act):
    x, wu, wg, wd = _inputs(gated, seed=7 + gated)
    g = np.random.default_rng(9).standard_normal((E, C, M)).astype(
        np.float32)
    args = [a for a in (x, wu, wg, wd) if a is not None]

    def jloss(*a):
        full = list(a) if gated else [a[0], a[1], None, a[2]]
        return jnp.sum(jax_kernel(*full, act) * g)

    want = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    full = ts if gated else [ts[0], ts[1], None, ts[2]]
    loss = (grouped_ffn(*full, act) * torch.from_numpy(g)).sum()
    got = torch.autograd.grad(loss, ts)
    for a, b in zip(want, got):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_every_kernel_activation_maps_zero_to_zero():
    """The bf16 kernel writes an idle expert's rows as 0 without reading
    its weights, which equals the plain version only while act(0) = 0 for
    every activation the kernel takes; the wrapper refuses the others."""
    from repro_torch.kernels.grouped_ffn import ops
    assert ops._ZERO_TO_ZERO == set(ops._ACT_IDS)
    for act in ops._ACT_IDS:
        assert grouped_ffn_ref(torch.zeros(1, 2, 16), torch.ones(1, 16, 16),
                               None, torch.ones(1, 16, 16), act).eq(0).all()
