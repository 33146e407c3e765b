"""Paged KV pools for the serving engine (``repro_torch.serve``).

The counterpart of the paged half of ``repro.models.kv_cache``: per
attention layer a global pool ``[num_pages, page_size, kv_heads,
head_dim]`` for K and one for V (MLA: the latent ``c_kv`` ``[num_pages,
page_size, kv_lora_rank]`` and the shared rotary key ``[num_pages,
page_size, rope_head_dim]``), shared by every in-flight sequence; a
per-sequence page table maps logical page -> physical page. Page 0 is
the reserved write sink for masked (padding / inactive-slot) writes.
Everything past the page axis is trailing-dim generic, so the page
allocator does not know which kind of pool it serves.

Unlike JAX, which returns new pools from every scatter, the port updates
the pools **in place** (``scatter_pages`` writes into the tensor it is
given and returns it): the pools are the engine's largest allocation
and a copy per step would double it.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import ArchConfig


def paged_layer_pool(cfg: ArchConfig, role: Dict, num_pages: int,
                     page_size: int, dtype=torch.bfloat16,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """The pools of one attention layer, zero-filled: K and V, each
    ``[num_pages, page_size, kv_heads, head_dim]``, or for MLA
    ``ckv_pool`` ``[num_pages, page_size, kv_lora_rank]`` and
    ``kr_pool`` ``[num_pages, page_size, rope_head_dim]``."""
    a = cfg.attn
    if role["mixer"] != "attn":
        raise NotImplementedError(
            f"paged KV supports attention layers only "
            f"(got mixer={role['mixer']!r})")
    if a.mla is not None:
        m = a.mla
        return {"ckv_pool": torch.zeros((num_pages, page_size,
                                         m.kv_lora_rank), dtype=dtype,
                                        device=device),
                "kr_pool": torch.zeros((num_pages, page_size,
                                        m.rope_head_dim), dtype=dtype,
                                       device=device)}
    kd = (num_pages, page_size, a.num_kv_heads, cfg.head_dim)
    return {"k_pool": torch.zeros(kd, dtype=dtype, device=device),
            "v_pool": torch.zeros(kd, dtype=dtype, device=device)}


def init_paged_pools(cfg: ArchConfig, num_pages: int, page_size: int,
                     dtype=torch.bfloat16, device="cpu") -> List[dict]:
    """One ``{"l{i}": pools}`` dict per period, covering the attention
    layers of the period (the JAX package stacks these on a leading
    period axis instead)."""
    roles = cfg.layer_roles()
    return [{f"l{i}": paged_layer_pool(cfg, role, num_pages, page_size,
                                       dtype, device)
             for i, role in enumerate(roles) if role["mixer"] == "attn"}
            for _ in range(cfg.num_periods)]


def pools_bytes(pools) -> int:
    return sum(t.numel() * t.element_size()
               for period in pools for layer in period.values()
               for t in layer.values())


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """pool ``[P, ps, ...]``, page_table ``[B, NP]`` ->
    position-contiguous view ``[B, NP*ps, ...]`` per sequence."""
    g = pool[page_table.long()]                    # [B, NP, ps, ...]
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def scatter_pages(pool: torch.Tensor, page_table: torch.Tensor,
                  positions: torch.Tensor, values: torch.Tensor,
                  valid=None, sink=0) -> torch.Tensor:
    """Write ``values[b, s]`` at absolute position ``positions[b, s]`` of
    sequence ``b``'s paged cache, **in place**; returns ``pool``.

    pool ``[P, ps, ...]``; page_table ``[B, NP]``; positions ``[B, S]``;
    values ``[B, S, ...]``. Writes masked out by ``valid`` (or falling
    past the table) go to the reserved ``sink`` page: a scalar (page 0
    by default) or a per-sequence ``[B]`` tensor.
    """
    ps = pool.shape[1]
    np_ = page_table.shape[1]
    positions = positions.long()
    pidx = positions.div(ps, rounding_mode="floor").clamp(0, np_ - 1)
    page = torch.gather(page_table.long(), 1, pidx)          # [B, S]
    ok = positions < np_ * ps
    if valid is not None:
        ok = ok & valid
    if isinstance(sink, torch.Tensor) and sink.ndim == 1:
        sink = sink.long()[:, None].expand_as(page)
    else:
        sink = torch.as_tensor(sink, dtype=torch.long, device=page.device)
    page = torch.where(ok, page, sink)
    off = positions % ps
    flat = values.reshape((-1,) + tuple(values.shape[2:])).to(pool.dtype)
    pool[page.reshape(-1), off.reshape(-1)] = flat
    return pool
