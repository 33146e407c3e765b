"""The flash-attention kernel against its plain version on the card, over
the shapes its register-resident bf16 design has to get right.

Each case runs ``flash_attention`` on CUDA tensors (one launch) and
``flash_attention_ref`` on the same inputs, and holds the difference
within ``ref.tolerance`` per element (1e-5 in fp32; in bf16 one output
rounding plus the bf16 rounding of the probabilities, weighted by |v|).
The cases cover sequence lengths 1, 17, 200 and 1024 (a single query,
ragged tiles, several tiles, the training shape), every head dim the
bf16 kernel is built for up to 128 (32 to 128 here, 16 in
``test_torch_train_cuda.py``; 144 to 192 in ``test_torch_dense_cuda.py``), causal and not, sliding windows, GQA,
Sq != Sk, and a q that is a strided view into a packed qkv tensor. Rows
that see no key at all are not among them: there the kernel and the
plain version average different sets of keys. This file imports neither
``jax`` nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_flash_cuda.py

Elsewhere it skips: a CUDA kernel has no CPU mode.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build

CASES = [  # b, sq, sk, hq, kv, d, causal, window
    (2, 1, 1, 4, 4, 64, True, 0),          # one query
    (2, 17, 17, 4, 2, 96, True, 0),        # ragged tile, GQA
    (1, 17, 40, 4, 1, 128, False, 0),      # Sq != Sk, non-causal, MQA
    (2, 200, 200, 8, 2, 64, True, 64),     # GQA + window
    (1, 200, 256, 4, 4, 128, False, 48),   # non-causal window, Sq < Sk
    (1, 200, 120, 4, 2, 96, True, 0),      # causal, Sq > Sk
    (2, 1024, 1024, 8, 8, 96, True, 0),    # moe-gpt3-s training shape
    (1, 1024, 1024, 8, 2, 128, True, 256),  # D 128, GQA, window
    (1, 1024, 1024, 4, 4, 64, False, 0),   # non-causal, long
    (1, 100, 100, 2, 1, 32, True, 0),      # the other head dims
    (1, 70, 70, 2, 2, 48, False, 0),
    (1, 130, 130, 2, 2, 80, True, 32),
    (1, 64, 96, 2, 1, 112, True, 0),
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _randn(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(x.astype(np.float32)).cuda().to(dtype)


def _check(q, k, v, causal, window):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ref import tolerance
    build.reset_launches()
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == 1
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs()
    tol = tolerance(q, k, v, ref, causal=causal, window=window)
    assert (err <= tol).all(), (err / tol).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,hq,kv,d,causal,window", CASES)
def test_flash_kernel_matches_plain(dtype, b, sq, sk, hq, kv, d, causal,
                                    window):
    _cuda()
    q = _randn((b, sq, hq, d), sq + d, dtype)
    k = _randn((b, sk, kv, d), sk + d + 1, dtype)
    v = _randn((b, sk, kv, d), sk + d + 2, dtype)
    _check(q, k, v, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_takes_strided_views(dtype):
    """q, k and v as slices of one packed [B, S, Hq + 2 Kv, D] tensor, as
    a fused projection would leave them."""
    _cuda()
    b, s, hq, kv, d = 2, 300, 8, 2, 96
    qkv = _randn((b, s, hq + 2 * kv, d), 7, dtype)
    q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + kv], qkv[:, :, hq + kv:]
    assert not q.is_contiguous()
    _check(q, k, v, True, 0)


@pytest.mark.cuda
def test_flash_kernel_rejects_wide_heads_in_bf16():
    _cuda()
    from repro_torch.kernels.flash_attention import flash_attention
    q = _randn((1, 16, 2, 208), 1, torch.bfloat16)
    with pytest.raises(ValueError, match="head dims 16 to 192 in steps of "
                                         "16, and 256; got 208"):
        flash_attention(q, q, q)
