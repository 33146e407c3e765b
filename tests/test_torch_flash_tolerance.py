"""The bf16 limit that the flash-attention kernel is held to on the card
(``repro_torch.kernels.flash_attention.ref.tolerance``), on the CPU.

The card cannot be asked here, so a PyTorch copy of the kernel's
arithmetic stands in for it: an fp32 online softmax over 64-key tiles,
each probability rounded to bf16 before the PV product, the running sum
taken from the unrounded probabilities, the output rounded to bf16. The
limit must admit that computation everywhere, and must reject it once
the rows past the first tile are off by 10%, a fault the largest-output
limit this one replaced let through.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention.ref import NEG, tolerance

BK = 64     # the kernel's KV tile


def _kernel_like(q, k, v, causal, window):
    b, sq, hq, d = q.shape
    sk, g = k.shape[1], hq // k.shape[2]
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), kf) * d ** -0.5
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    s = torch.where(mask, s, NEG)
    m = torch.full((b, hq, sq), NEG)
    l = torch.zeros((b, hq, sq))
    acc = torch.zeros((b, hq, sq, d))
    for j in range(0, sk, BK):
        st = s[..., j:j + BK]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqt,bthd->bhqd", p.bfloat16().float(), vf[:, j:j + BK])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3)          # [B, Sq, Hq, D] fp32


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128),
                                           (False, 0)])
def test_bf16_limit_admits_the_kernels_roundings_and_rejects_a_10pct_fault(
        causal, window):
    r = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(r.standard_normal((1, 512, h, 32))
                                .astype(np.float32)).bfloat16()
               for h in (4, 2, 2))
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = tolerance(q, k, v, ref, causal=causal, window=window)
    assert tol.shape == ref.shape
    exact = _kernel_like(q, k, v, causal, window)
    err = (exact.bfloat16().float() - ref.float()).abs()
    assert (err <= tol).all(), (err / tol).max().item()
    faulty = exact.clone()
    faulty[:, BK:] *= 1.1
    err = (faulty.bfloat16().float() - ref.float()).abs()
    assert not (err <= tol).all()


def test_fp32_limit_is_1e_5_everywhere():
    r = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(r.standard_normal((1, 64, 2, 16))
                                .astype(np.float32)) for _ in range(3))
    ref = flash_attention_ref(q, k, v)
    tol = tolerance(q, k, v, ref)
    assert tol.shape == ref.shape and (tol == 1e-5).all()
