"""Plain PyTorch version of the flash-attention kernel: one fp32 softmax
over the whole masked score matrix — the function of the JAX package's
``repro.kernels.flash_attention`` kernel and of its
``flash_attention_ref``, in the ``[B, S, H, D]`` layout of the model. The
CPU path uses it, the CUDA kernel is held against it on the card, and
the kernel's backward differentiates it."""
from __future__ import annotations

import torch

NEG = -1e30   # the TPU kernel's mask value


def _probs(q, k, causal: bool, window: int) -> torch.Tensor:
    """The normalised fp32 probabilities ``[B, Kv, G, Sq, Sk]``."""
    b, sq, hq, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, kv, hq // kv, d)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k.float()) * (d ** -0.5)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window > 0:
        mask = mask & (q_pos - k_pos < window)
    s = torch.where(mask, s, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)


def _weigh(p, v) -> torch.Tensor:
    """``sum_t p[..., q, t] v[t]`` -> ``[B, Sq, Hq, D]`` fp32."""
    b, kv, g, sq, _ = p.shape
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return out.reshape(b, sq, kv * g, v.shape[-1])


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q ``[B, Sq, Hq, D]``; k/v ``[B, Sk, Kv, D]`` (Hq = Kv * group) ->
    ``[B, Sq, Hq, D]`` in q's dtype. Query head h reads KV head
    h // group; positions of q and k both start at 0."""
    return _weigh(_probs(q, k, causal, window), v).to(q.dtype)


def tolerance(q, k, v, ref: torch.Tensor, *, causal: bool = True,
              window: int = 0) -> torch.Tensor:
    """Per-element limit ``[B, Sq, Hq, D]`` (fp32) on the CUDA kernel's
    difference from ``ref``, this module's output on the same inputs.

    fp32: summation order and the online rescaling, 1e-5.

    bf16: the kernel rounds each probability p_t to bf16 before the PV
    product (as the TPU kernel does) but sums l from the unrounded ones,
    so its fp32 output differs from the exact one by at most
    2^-8 * B with B = sum_t p_t |v_t| (half a unit of bf16's 8-bit
    significand each). Both outputs are then rounded to bf16, which may
    put them one unit apart: at most 2^-7 |ref|. 2^-14 * B more covers
    the second-order terms (B >= |ref|, a rounding of a rounded value,
    fp32 exp), and 1e-5 the fp32 sums. A limit taken from the largest
    output instead (the first causal rows, nearly v itself) would admit
    errors as large as the typical output of a long causal row, which
    averages many values of v."""
    if ref.dtype == torch.float32:
        return torch.full(ref.shape, 1e-5, device=ref.device)
    if ref.dtype != torch.bfloat16:
        raise ValueError(f"no tolerance for {ref.dtype}")
    bsum = _weigh(_probs(q, k, causal, window), v.abs())
    return (2.0 ** -7 * ref.float().abs() + (2.0 ** -8 + 2.0 ** -14) * bsum
            + 1e-5)
