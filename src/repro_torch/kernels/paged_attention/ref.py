"""Plain PyTorch version of the paged-decode kernel: gather the pages,
then one masked fp32 softmax — the same function as the JAX package's
``repro.kernels.paged_attention.ref.paged_decode_attention_ref``. The
CPU tests use it, and the CUDA kernel is held against it on the card."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38   # matches repro_torch.models.layers.attention.NEG_INF


def _gather(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """``[P, ps, ...]`` x ``[B, NP]`` -> ``[B, NP*ps, ...]``."""
    b, npages = page_table.shape
    ps = pool.shape[1]
    return pool[page_table.long()].reshape((b, npages * ps)
                                           + tuple(pool.shape[2:]))


def paged_decode_attention_ref(q, k_pool, v_pool, page_table, lens, *,
                               window: int = 0):
    """q ``[B, Kv, G, D]``; pools ``[P, ps, Kv, D]``; lens ``[B]`` — valid
    cache entries per slot (including the token written this step).
    Returns ``[B, Kv, G, D]`` in q's dtype."""
    d = q.shape[-1]
    k = _gather(k_pool, page_table)                  # [B, T, Kv, D]
    v = _gather(v_pool, page_table)
    t = k.shape[1]
    s_ = torch.einsum("bkgd,btkd->bkgt", q.float(), k.float()) * (d ** -0.5)
    cl = torch.as_tensor(lens, device=q.device).reshape(-1, 1)   # [B, 1]
    idx = torch.arange(t, device=q.device)[None, :]
    valid = idx < cl
    if window > 0:
        valid = valid & (idx >= cl - window)
    s_ = torch.where(valid[:, None, None, :], s_, NEG_INF)
    m = s_.amax(dim=-1, keepdim=True)
    p = torch.exp(s_ - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgt,btkd->bkgd", p / torch.clamp(l, min=1e-30),
                       v.float())
    return out.to(q.dtype)


def tolerance(ref: torch.Tensor) -> float:
    """The largest max-abs difference the CUDA kernel may show against
    ``ref``, this function's output on the same inputs. Both compute in
    fp32 and round once to the output dtype. In fp32 they differ only by
    summation order: 1e-5. In bf16 a rounding may flip by one unit in the
    last place, at most 2^-7 of the largest output; plus 1e-5, and never
    above 2e-2."""
    if ref.dtype == torch.float32:
        return 1e-5
    if ref.dtype != torch.bfloat16:
        raise ValueError(f"no tolerance for {ref.dtype}")
    return min(2e-2, 2.0 ** -7 * ref.float().abs().max().item() + 1e-5)
