"""Plain PyTorch versions of the paged-decode kernels: gather the pages,
then one masked fp32 softmax — the same functions as the JAX package's
``repro.kernels.paged_attention.ref.paged_decode_attention_ref`` and
``paged_mla_decode_ref``. The CPU path uses them, and the CUDA kernels
are held against them on the card."""
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


def paged_mla_decode_ref(q_abs, q_rope, ckv_pool, kr_pool, page_table,
                         lens, *, scale: float):
    """Plain version of the MLA decode kernel: the JAX package's
    ``paged_mla_decode_ref`` einsums over gathered pages. q_abs ``[B, H,
    R]``; q_rope ``[B, H, E]``; ckv_pool ``[P, ps, R]``; kr_pool ``[P, ps,
    E]``; lens ``[B]`` — the slot's decode position (keys at ``t <= lens``
    are visible). Returns the latent context ``[B, H, R]`` float32. The
    products are taken in fp32 (exact for bf16 inputs), as the JAX
    package's ``preferred_element_type=float32``."""
    ckv = _gather(ckv_pool, page_table).float()      # [B, T, R]
    kr = _gather(kr_pool, page_table).float()        # [B, T, E]
    t = ckv.shape[1]
    s_ = (torch.einsum("bhr,btr->bht", q_abs.float(), ckv)
          + torch.einsum("bhe,bte->bht", q_rope.float(), kr)) * scale
    ln = torch.as_tensor(lens, device=ckv.device).reshape(-1, 1, 1)
    mask = torch.arange(t, device=ckv.device)[None, None, :] <= ln
    s_ = torch.where(mask, s_, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    return torch.einsum("bht,btr->bhr", p, ckv)


def tolerance_mla(q_abs, q_rope, ckv_pool, kr_pool, page_table, lens, *,
                  scale: float) -> float:
    """The largest max-abs difference the CUDA MLA kernel may show against
    ``paged_mla_decode_ref`` on the same inputs, in fp32 and bf16 alike:
    both take the products in fp32 (exact for bf16 values) and keep the
    probabilities and the context in fp32, so they differ only in the
    order of fp32 sums. The score is a sum of R + E products; two orders
    of it differ by about sqrt(R + E) roundings of its largest terms,
    bounded here by ds = 2^-22 * sqrt(R + E) * max|q| * max|k| * scale
    (max|k| over the visible keys only: stale and sink pages never reach
    either version). A score error ds moves each probability by a
    relative 2 ds at most, so the context moves by 2 ds * max|c_kv|; 1e-5
    covers the softmax and PV sums."""
    ckv = _gather(ckv_pool, page_table).float()
    kr = _gather(kr_pool, page_table).float()
    t = ckv.shape[1]
    ln = torch.as_tensor(lens, device=ckv.device).reshape(-1, 1)
    vis = (torch.arange(t, device=ckv.device)[None, :] <= ln)[..., None]
    ckv_max = torch.where(vis, ckv, 0).abs().max().item()
    k_max = max(ckv_max, torch.where(vis, kr, 0).abs().max().item())
    q_max = max(q_abs.float().abs().max().item(),
                q_rope.float().abs().max().item())
    depth = ckv.shape[-1] + kr.shape[-1]
    ds = 2.0 ** -22 * depth ** 0.5 * q_max * k_max * scale
    return 1e-5 + 2.0 * ds * ckv_max
