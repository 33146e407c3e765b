"""The flash-attention kernel's plain version and the model's train-path
attention, the port against the JAX package, on the CPU in fp32.

The plain version (``repro_torch.kernels.flash_attention.ref``, what the
wrapper runs on CPU tensors) is held against the JAX package's Pallas
kernel in interpret mode (``repro.kernels.flash_attention``) and its jnp
``flash_attention_ref``: causal and not, with a window, GQA, Sq != Sk,
within atol 2e-5 (rtol 2e-5), the limit of the JAX package's own fp32
kernel test (the kernel's online softmax rescales in another order).
Gradients through the port's autograd Function are held against
``jax.grad`` of the model's jnp blockwise ``flash_attention`` — what the
JAX training path differentiates — within rtol 1e-4, atol 1e-5. The
CUDA kernel itself is held against the plain version on the card
(``test_torch_train_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_kernel
from repro.kernels.flash_attention import flash_attention_ref as jax_ref
from repro.models.layers.attention import flash_attention as jax_model_fa
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)

CASES = [  # b, sq, sk, hq, kv, d, causal, window
    (2, 64, 64, 4, 2, 32, True, 0),
    (1, 100, 100, 4, 4, 32, True, 24),
    (2, 48, 96, 4, 1, 16, False, 0),
    (1, 96, 64, 2, 2, 32, True, 0),
]


def _qkv(b, sq, sk, hq, kv, d, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, sq, hq, d)).astype(np.float32),
            r.standard_normal((b, sk, kv, d)).astype(np.float32),
            r.standard_normal((b, sk, kv, d)).astype(np.float32))


def _flat(a):      # [B, S, H, D] -> [B*H, S, D], the JAX kernel's layout
    b, s, h, d = a.shape
    return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(b * h, s, d)


@pytest.mark.parametrize("b,sq,sk,hq,kv,d,causal,window", CASES)
def test_plain_version_matches_jax_kernel_and_ref(b, sq, sk, hq, kv, d,
                                                  causal, window):
    q, k, v = _qkv(b, sq, sk, hq, kv, d, seed=sq + sk + hq)
    out = flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window).numpy()
    kern = jax_kernel(*map(jnp.asarray, (q, k, v)), causal=causal,
                      window=window, block_q=32, block_k=32)
    ref = jax_ref(_flat(q), _flat(k), _flat(v), causal=causal,
                  window=window)
    ref = np.asarray(ref).reshape(b, hq, sq, d).transpose(0, 2, 1, 3)
    for want in (np.asarray(kern), ref):
        np.testing.assert_allclose(want, out, rtol=2e-5, atol=2e-5)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    q, k, v = map(torch.from_numpy, _qkv(1, 32, 32, 4, 2, 16, seed=1))
    build.reset_launches()
    out = flash_attention(q, k, v, causal=True, window=8)
    assert torch.equal(out, flash_attention_ref(q, k, v, causal=True,
                                                window=8))
    assert build.LAUNCHES["flash_attention"] == 0
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :1].expand(1, 32, 3, 16), v)


@pytest.mark.parametrize("case", [CASES[0], CASES[1]])
def test_gradients_match_jax_model_flash(case):
    b, sq, sk, hq, kv, d, causal, window = case
    q, k, v = _qkv(b, sq, sk, hq, kv, d, seed=3)
    g = np.random.default_rng(4).standard_normal((b, sq, hq, d)).astype(
        np.float32)

    def jloss(q_, k_, v_):
        o = jax_model_fa(q_, k_, v_, causal=causal, window=window,
                         q_block=32, kv_block=32)
        return jnp.sum(o * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    loss = (flash_attention(*ts, causal=causal, window=window)
            * torch.from_numpy(g)).sum()
    got = torch.autograd.grad(loss, ts)
    for a, bb in zip(want, got):
        np.testing.assert_allclose(np.asarray(a), bb.numpy(), rtol=1e-4,
                                   atol=1e-5)
