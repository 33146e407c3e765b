"""Decode caches: the dense per-sequence cache of ``lm.prefill`` /
``lm.decode_step`` and the paged KV pools of the serving engine
(``repro_torch.serve``), as ``repro.models.kv_cache``.

Dense: per attention layer ``k``/``v`` ``[batch, T, kv_heads, head_dim]``
(T = ``max_len``, or ``min(window, max_len)`` for a sliding-window layer,
a ring buffer once full) or, for MLA, the latent ``c_kv`` ``[batch,
max_len, kv_lora_rank]`` and the rotated key ``k_rope`` ``[batch,
max_len, rope_head_dim]``, with ``len``, the tokens cached. ``len`` (and
``lm.init_cache``'s ``pos``) is a host int where the JAX package keeps an
int32 scalar: every sequence of the batch is at the same position, so
the fixed-batch loop advances it without reading the device.
``cache_bytes`` counts each such int as the 4 bytes of JAX's scalar.

Paged: the counterpart of the paged half of the JAX module: per
attention layer a global pool ``[num_pages, page_size, kv_heads,
head_dim]`` for K and one for V (MLA: the latent ``c_kv`` ``[num_pages,
page_size, kv_lora_rank]`` and the shared rotary key ``[num_pages,
page_size, rope_head_dim]``), shared by every in-flight sequence; a
per-sequence page table maps logical page -> physical page. Page 0 is
the reserved write sink for masked (padding / inactive-slot) writes.
Everything past the page axis is trailing-dim generic, so the page
allocator does not know which kind of pool it serves.

Unlike JAX, which returns new caches from every update, the port updates
the dense caches and the pools **in place** (``scatter_pages`` writes into the tensor it is
given and returns it): the pools are the engine's largest allocation
and a copy per step would double it. The swap-in of preempt-by-offload
(``insert_pages``) and the prefix cache's copy-on-write
(``copy_pages``) write in place too: a captured decode graph reads the
pools at the addresses they had at capture.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.module import leaves


def layer_cache(cfg: ArchConfig, role: Dict, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cpu") -> Dict:
    """The zero-filled dense cache of one attention layer (recurrent
    mixers' state comes with ROADMAP.md's 'Other architectures' slice)."""
    a = cfg.attn
    if role["mixer"] != "attn":
        raise NotImplementedError(
            f"mixer {role['mixer']!r} comes with ROADMAP.md's 'Other "
            f"architectures' slice")

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    if a.mla is not None:
        m = a.mla
        return {"c_kv": zeros(batch, max_len, m.kv_lora_rank),
                "k_rope": zeros(batch, max_len, m.rope_head_dim), "len": 0}
    window = 0 if (role["global_attn"] and a.global_period > 1) \
        else a.window
    t = min(window, max_len) if window > 0 else max_len
    kd = (batch, t, a.num_kv_heads, cfg.head_dim)
    return {"k": zeros(*kd), "v": zeros(*kd), "len": 0}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> List[dict]:
    """One ``{"l{i}": layer_cache}`` dict per period (the JAX package
    stacks them on a leading period axis)."""
    roles = cfg.layer_roles()
    return [{f"l{i}": layer_cache(cfg, role, batch, max_len, dtype, device)
             for i, role in enumerate(roles)}
            for _ in range(cfg.num_periods)]


def cache_bytes(cache) -> int:
    """Bytes of a dense cache tree, as the JAX package's ``cache_bytes``:
    each tensor's, and 4 for each host int (JAX's int32 scalars)."""
    return sum(4 if isinstance(x, int) else x.numel() * x.element_size()
               for x in leaves(cache))


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


def tree_bytes(tree) -> int:
    """Total bytes of a (host or device) tensor tree."""
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _page_index(page_ids: Sequence[int], device) -> torch.Tensor:
    return torch.as_tensor(list(page_ids), dtype=torch.long).to(device)


def _in_order(pools) -> List[torch.Tensor]:
    """The pools' leaves in the order ``_map`` visits them."""
    return [t for period in pools for layer in period.values()
            for t in layer.values()]


def _map(fn, pools, *trees):
    """``fn`` over the pools' leaves, zipped with same-shaped ``trees``:
    the pools' per-period ``{layer: {name: tensor}}`` structure."""
    return [{lk: {name: fn(t, *(tr[p][lk][name] for tr in trees))
                  for name, t in layer.items()}
             for lk, layer in period.items()}
            for p, period in enumerate(pools)]


def extract_pages(pools, page_ids: Sequence[int]):
    """Copy physical pages out of the pools to the host (swap-out).

    Returns a tree shaped like the pools with ``[len(page_ids), ps,
    ...]`` host tensors (the JAX package stacks the periods on a leading
    axis instead), all views of one host buffer: the pages are gathered
    into one device buffer, which goes to the host in one copy. From
    CUDA pools that copy goes to pinned memory, asynchronously on the
    current stream: a kernel queued later on that stream (one reusing a
    freed page) runs after the read, and the swap-in reads the host copy
    in the same stream order, so neither needs a host sync. From CPU
    pools the buffer is the host copy."""
    if not page_ids:
        raise ValueError("extract_pages of no pages")
    ts = _in_order(pools)
    if any(t.dtype != ts[0].dtype for t in ts):
        raise ValueError("extract_pages needs pools of one dtype")
    idx = _page_index(page_ids, ts[0].device)
    shapes = [(idx.numel(),) + tuple(t.shape[1:]) for t in ts]
    sizes = [math.prod(shape) for shape in shapes]
    buf = torch.empty(sum(sizes), dtype=ts[0].dtype, device=ts[0].device)
    for t, part, shape in zip(ts, buf.split(sizes), shapes):
        torch.index_select(t, 0, idx, out=part.view(shape))
    host = buf
    if buf.device.type == "cuda":
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        host.copy_(buf, non_blocking=True)
    views = iter([part.view(shape)
                  for part, shape in zip(host.split(sizes), shapes)])
    return _map(lambda t: next(views), pools)


def insert_pages(pools, page_ids: Sequence[int], host):
    """Write host page copies back into the pools, **in place** (swap-in):
    the inverse of :func:`extract_pages`, page ``host[..][i]`` into
    physical page ``page_ids[i]``. Returns ``pools``, the same tensors."""
    first = leaves(pools)[0]
    idx = _page_index(page_ids, first.device)

    def one(t, h):
        if h.shape[0] != idx.numel() or h.shape[1:] != t.shape[1:]:
            raise ValueError(f"host pages {tuple(h.shape)} do not fit "
                             f"{idx.numel()} pages of {tuple(t.shape)}")
        t.index_copy_(0, idx, h.to(t.device, t.dtype, non_blocking=True))
    _map(one, pools, host)
    return pools


def copy_pages(pools, src_pages: Sequence[int], dst_pages: Sequence[int]):
    """Duplicate physical pages on the device, **in place**
    (copy-on-write): every ``dst_pages[i]`` gets a copy of
    ``src_pages[i]`` in every pool leaf, one ``index_copy_`` a leaf on
    the current stream, so a decode step queued after it on that stream
    (eager or a graph replay) reads the copy. The sources and the
    destinations must be disjoint. Returns ``pools``, the same tensors:
    a captured decode graph reads the pools at the addresses they had
    at capture."""
    if len(src_pages) != len(dst_pages):
        raise ValueError(f"copy_pages of {len(src_pages)} sources into "
                         f"{len(dst_pages)} destinations")
    if set(src_pages) & set(dst_pages):
        raise ValueError("copy_pages sources and destinations overlap")
    first = leaves(pools)[0]
    src = _page_index(src_pages, first.device)
    dst = _page_index(dst_pages, first.device)
    for t in _in_order(pools):
        t.index_copy_(0, dst, t.index_select(0, src))
    return pools


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
