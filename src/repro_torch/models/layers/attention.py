"""Attention: GQA/MHA with RoPE and sliding windows, and MLA, over the
dense per-sequence cache (``lm.prefill`` / ``lm.decode_step``) or the
paged KV pools of the serving engine, as ``repro.models.layers.attention``.
Every GQA path (train, dense prefill and decode, paged prefill chunk and
decode) rotates q and k after the projection (``_rope_qk``: ``rope_theta``,
gemma3's ``rope_local_theta`` on its local layers), so caches and pools
hold rotated keys:

* ``flash_attention`` is the JAX package's blockwise online-softmax
  attention as a plain PyTorch function (prefill chunks, with
  ``q_offset``); the q and kv blocks are Python loops.
* ``decode_attention`` is single-query attention over gathered pages.
* ``apply`` scatters this step's K/V into the pools (in place —
  see ``models/kv_cache``) *before* attention reads them, then runs
  decode through the hand-written CUDA kernel
  (``repro_torch.kernels.paged_attention``) when ``attn_kernel ==
  "kernel"``, else through ``gather_pages`` + ``decode_attention``.
* MLA (DeepSeek-V2, ``_apply_mla_paged``) pages the compressed latent
  ``c_kv`` and the shared rotary key instead of K/V, and attends in the
  absorbed form (q projected into the latent space): decode through the
  hand-written MLA kernel when ``attn_kernel == "kernel"``, chunked
  prefill always through the gathered einsums, as in the JAX package.
* Over a dense cache (``_fill_cache`` / ``_append_cache``, a ring
  buffer of ``window`` slots for a windowed layer) and without a cache
  (``mode="train"``), prefill and train run causal attention through
  the hand-written ``flash_attention`` kernel
  (``repro_torch.kernels.flash_attention``; its plain version on the
  CPU), where the JAX package runs its jnp ``flash_attention``: the two
  compute the same function. Dense decode attends through the plain
  ``decode_attention``, as JAX's dense decode is jnp outside any Pallas
  kernel; it also keeps the token oracle (``serve.trace``) independent
  of the paged kernels it checks. MLA's dense path (``_apply_mla``)
  prefills in the expanded form through the flash kernel at head dim
  ``nope + rope`` (v padded to it) and decodes in the absorbed form.
  Chunked paged prefill keeps the blockwise ``flash_attention`` below,
  which takes ``q_offset``; the kernel does not.

Scores, softmax and the PV sum are fp32 whatever the compute dtype (the
JAX package's ``preferred_element_type=float32``); ``NEG_INF`` is only
ever used in fp32 scores, where it stays finite.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import kv_cache as KV
from repro_torch.models.layers import rope as rope_lib
from repro_torch.models.module import Spec

NEG_INF = -2.0e38
ATTN_KERNELS = ("kernel", "gather")   # decode attention paths


def specs(cfg: ArchConfig):
    a = cfg.attn
    d, hd = cfg.d_model, cfg.head_dim
    if a.mla is not None:
        m = a.mla
        qk_dim = m.nope_head_dim + m.rope_head_dim
        s = {
            "w_dkv": Spec((d, m.kv_lora_rank), ("embed", "kv_lora")),
            "w_kr": Spec((d, m.rope_head_dim), ("embed", None)),
            "w_uk": Spec((m.kv_lora_rank, a.num_heads, m.nope_head_dim),
                         ("kv_lora", "heads", "head_dim")),
            "w_uv": Spec((m.kv_lora_rank, a.num_heads, m.v_head_dim),
                         ("kv_lora", "heads", "head_dim")),
            "w_o": Spec((a.num_heads, m.v_head_dim, d),
                        ("heads", "head_dim", "embed_out")),
        }
        if m.q_lora_rank:
            s["w_dq"] = Spec((d, m.q_lora_rank), ("embed", "kv_lora"))
            s["w_uq"] = Spec((m.q_lora_rank, a.num_heads, qk_dim),
                             ("kv_lora", "heads", "head_dim"))
        else:
            s["w_q"] = Spec((d, a.num_heads, qk_dim),
                            ("embed", "heads", "head_dim"))
        return s
    s = {
        "w_q": Spec((d, a.num_heads, hd), ("embed", "heads", "head_dim")),
        "w_k": Spec((d, a.num_kv_heads, hd),
                    ("embed", "kv_heads", "head_dim")),
        "w_v": Spec((d, a.num_kv_heads, hd),
                    ("embed", "kv_heads", "head_dim")),
        "w_o": Spec((a.num_heads, hd, d),
                    ("heads", "head_dim", "embed_out")),
    }
    if a.qkv_bias:
        s["b_q"] = Spec((a.num_heads, hd), ("heads", "head_dim"), "zeros")
        s["b_k"] = Spec((a.num_kv_heads, hd), ("kv_heads", "head_dim"),
                        "zeros")
        s["b_v"] = Spec((a.num_kv_heads, hd), ("kv_heads", "head_dim"),
                        "zeros")
    return s


def _pad_seq(x: torch.Tensor, to: int) -> torch.Tensor:
    """Zero-pad dim 1 of ``[B, S, H, D]`` up to ``to``."""
    return F.pad(x, (0, 0, 0, 0, 0, to - x.shape[1]))


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_block: int = 512, kv_block: int = 512,
                    q_offset=0):
    """Blockwise attention. q ``[B,Sq,Hq,D]``, k/v ``[B,Sk,Kv,D]`` ->
    ``[B,Sq,Hq,D]`` in q's dtype.

    ``q_offset``: absolute position of ``q[:, 0]`` (chunked prefill); an
    int or a 0-d tensor, which keeps the position on the device. Sq/Sk
    are padded up to block multiples internally.
    """
    b, sq, hq, d = q.shape
    sk, kv_heads = k.shape[1], k.shape[2]
    g = hq // kv_heads
    scale = d ** -0.5
    dev = q.device

    qb, kb = min(q_block, sq), min(kv_block, sk)
    sq_p, sk_p = -(-sq // qb) * qb, -(-sk // kb) * kb
    nq, nk = sq_p // qb, sk_p // kb
    qp = _pad_seq(q, sq_p).reshape(b, nq, qb, kv_heads, g, d).float()
    kp = _pad_seq(k, sk_p).reshape(b, nk, kb, kv_heads, d).float()
    vp = _pad_seq(v, sk_p).reshape(b, nk, kb, kv_heads, d).float()

    q_pos = (torch.arange(sq_p, device=dev) + q_offset).reshape(nq, qb)
    k_pos = torch.arange(sk_p, device=dev).reshape(nk, kb)
    k_valid = k_pos < sk

    outs = []
    for i in range(nq):
        qc, qpos = qp[:, i], q_pos[i]                   # [B,qb,K,G,D]
        o = torch.zeros((b, kv_heads, g, qb, d), device=dev)
        m = torch.full((b, kv_heads, g, qb), NEG_INF, device=dev)
        l = torch.zeros((b, kv_heads, g, qb), device=dev)
        for j in range(nk):
            s_ = torch.einsum("bqkgd,btkd->bkgqt", qc, kp[:, j]) * scale
            mask = k_valid[j][None, :]
            if causal:
                mask = mask & (qpos[:, None] >= k_pos[j][None, :])
            if window > 0:
                mask = mask & (qpos[:, None] - k_pos[j][None, :] < window)
            s_ = torch.where(mask, s_, NEG_INF)
            m_new = torch.maximum(m, s_.amax(dim=-1))
            p = torch.exp(s_ - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgqt,btkd->bkgqd", p, vp[:, j])
            o = o * alpha[..., None] + pv
            m = m_new
        o = o / torch.clamp(l[..., None], min=1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))  # [B,qb,K,G,D]
    out = torch.cat(outs, dim=1).reshape(b, sq_p, hq, d)
    return out[:, :sq]


def decode_attention(q, k, v, cache_len, *, window: int = 0,
                     ring: bool = False):
    """Single-step attention over a cache.

    q ``[B,1,Hq,D]``; k/v ``[B,T,Kv,D]``; cache_len: int or ``[B]``
    tensor — valid entries per sequence. ``ring``: the cache is a ring
    buffer of size ``window`` (all slots valid once full).
    """
    b, t, kv_heads, d = k.shape
    hq = q.shape[2]
    g = hq // kv_heads
    qe = q.reshape(b, kv_heads, g, d).float()
    s_ = torch.einsum("bkgd,btkd->bkgt", qe, k.float()) * (d ** -0.5)
    idx = torch.arange(t, device=q.device)[None, :]
    if isinstance(cache_len, int):        # the dense cache's host length
        cl = cache_len
    else:
        cl = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    if ring:
        valid = idx < (min(cl, t) if isinstance(cl, int)
                       else torch.clamp(cl, max=t))
    else:
        valid = idx < cl
        if window > 0:
            valid = valid & (idx >= cl - window)
    s_ = torch.where(valid[:, None, None, :], s_, NEG_INF)
    m = s_.amax(dim=-1, keepdim=True)
    p = torch.exp(s_ - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgt,btkd->bkgd", p / torch.clamp(l, min=1e-30),
                       v.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def _proj_qkv(params, x, cfg: ArchConfig):
    a = cfg.attn
    dt = x.dtype
    q = torch.einsum("bsd,dhe->bshe", x, params["w_q"].to(dt))
    k = torch.einsum("bsd,dhe->bshe", x, params["w_k"].to(dt))
    v = torch.einsum("bsd,dhe->bshe", x, params["w_v"].to(dt))
    if a.qkv_bias:
        q = q + params["b_q"].to(dt)
        k = k + params["b_k"].to(dt)
        v = v + params["b_v"].to(dt)
    return q, k, v


def _rope_qk(q, k, cfg: ArchConfig, positions, *, is_global: bool):
    """q and k rotated at ``positions`` (``[B, S]``), as the JAX
    package's ``_rope_qk``: ``rope_theta``, or ``rope_local_theta`` on a
    local layer (``is_global=False``) where the config sets it (gemma3);
    unchanged without rotary positions (learned positions, or a theta of
    0). M-RoPE raises."""
    a = cfg.attn
    if cfg.positional != "rope" or a.rope_theta == 0.0:
        return q, k
    if a.mrope:
        raise NotImplementedError(
            "M-RoPE positions (qwen2-vl) come with ROADMAP.md's 'Other "
            "architectures' slice, with its vision frontend")
    theta = a.rope_theta
    if not is_global and a.rope_local_theta:
        theta = a.rope_local_theta
    return (rope_lib.apply_rope(q, positions, theta),
            rope_lib.apply_rope(k, positions, theta))


def _mla_q(params, x, cfg: ArchConfig):
    """x ``[B, S, d]`` -> (q_nope ``[B, S, H, nope]``, q_rope ``[B, S, H,
    rope]``), through the low-rank ``w_dq``/``w_uq`` when q is
    compressed."""
    m = cfg.attn.mla
    dt = x.dtype
    if m.q_lora_rank:
        cq = torch.einsum("bsd,dr->bsr", x, params["w_dq"].to(dt))
        q = torch.einsum("bsr,rhe->bshe", cq, params["w_uq"].to(dt))
    else:
        q = torch.einsum("bsd,dhe->bshe", x, params["w_q"].to(dt))
    return q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]


def _apply_mla_paged(params, x, *, cfg: ArchConfig, positions, cache: dict):
    """MLA over paged *latent* pools: ``ckv_pool`` ``[P, ps,
    kv_lora_rank]`` and ``kr_pool`` ``[P, ps, rope_head_dim]`` in place of
    K/V. This step's latent and rotated rotary key are scattered first
    (in place); then attention runs in the absorbed form, ``q_abs =
    q_nope . w_uk``, so the latents are never expanded to per-head K/V.
    Key position ``t`` is visible to the query at absolute position
    ``positions[b, s]`` iff ``t <= positions`` (decode passes ``lens``,
    which includes the token just written). Padding and inactive-slot
    writes go to the sink page as on the GQA path; their query rows read
    finite values that the engine discards."""
    a, m = cfg.attn, cfg.attn.mla
    dt = x.dtype
    s = x.shape[1]
    q_nope, q_rope = _mla_q(params, x, cfg)
    q_rope = rope_lib.apply_rope(q_rope, positions, a.rope_theta)
    c_kv = torch.einsum("bsd,dr->bsr", x, params["w_dkv"].to(dt))
    k_rope = torch.einsum("bsd,dr->bsr", x, params["w_kr"].to(dt))
    k_rope = rope_lib.apply_rope(k_rope[:, :, None, :], positions,
                                 a.rope_theta)[:, :, 0, :]
    if s > 1:
        assert x.shape[0] == 1, "paged chunked prefill runs one sequence"

    valid = cache.get("write_valid")
    sink = cache.get("write_sink")
    sink = 0 if sink is None else sink
    ckv_pool = KV.scatter_pages(cache["ckv_pool"], cache["page_table"],
                                positions, c_kv, valid, sink=sink)
    kr_pool = KV.scatter_pages(cache["kr_pool"], cache["page_table"],
                               positions, k_rope, valid, sink=sink)
    new_cache = {"ckv_pool": ckv_pool, "kr_pool": kr_pool}

    q_abs = torch.einsum("bshe,rhe->bshr", q_nope, params["w_uk"].to(dt))
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    kern = cache.get("attn_kernel")
    if kern not in ATTN_KERNELS:
        raise ValueError(f"attn_kernel must be one of {ATTN_KERNELS}, "
                         f"got {kern!r}")
    if s == 1 and kern == "kernel":
        from repro_torch.kernels.paged_attention import paged_mla_decode
        ctx = paged_mla_decode(q_abs.contiguous(), q_rope.contiguous(),
                               ckv_pool, kr_pool, cache["page_table"],
                               cache["lens"], scale=scale)
    else:
        ckv_all = KV.gather_pages(ckv_pool, cache["page_table"]).float()
        kr_all = KV.gather_pages(kr_pool, cache["page_table"]).float()
        s_ = (torch.einsum("bshr,btr->bhst", q_abs.float(), ckv_all)
              + torch.einsum("bshe,bte->bhst", q_rope.float(), kr_all))
        s_ = s_ * scale
        t = ckv_all.shape[1]
        mask = (torch.arange(t, device=x.device)[None, None, :]
                <= positions[:, :, None])
        s_ = torch.where(mask[:, None, :, :], s_, NEG_INF)
        p = torch.softmax(s_, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", p, ckv_all)
    out = torch.einsum("bshr,rhe->bshe", ctx.to(dt), params["w_uv"].to(dt))
    out = torch.einsum("bshe,hed->bsd", out, params["w_o"].to(dt))
    return out, new_cache


def _fill_cache(cache, k, v, window: int):
    """Prefill's K/V into a fresh dense cache, in place; absolute position
    p of a ring buffer (``window`` slots) lives at slot ``p % window``."""
    t = cache["k"].shape[1]
    s = k.shape[1]
    if window > 0 and t == window and s >= window:
        k = torch.roll(k[:, -window:], s % window, dims=1)
        v = torch.roll(v[:, -window:], s % window, dims=1)
    cache["k"][:, :k.shape[1]] = k
    cache["v"][:, :v.shape[1]] = v
    return {"k": cache["k"], "v": cache["v"], "len": s}


def _append_cache(cache, k, v, window: int):
    """One decode step's K/V at ``len`` (a ring buffer: ``len % window``),
    in place. Past the end it overwrites the last slot, as JAX's clamped
    ``dynamic_update_slice`` does."""
    t = cache["k"].shape[1]
    pos = cache["len"]
    slot = pos % t if window > 0 and t == window else min(pos, t - 1)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    return {"k": cache["k"], "v": cache["v"], "len": pos + 1}


def _apply_mla(params, x, *, cfg: ArchConfig, positions, mode: str,
               cache: Optional[dict]):
    """MLA over a dense latent cache (``c_kv``, ``k_rope``, ``len``).

    Prefill runs the expanded form: per-head K and V from the latent,
    causal attention through the flash kernel at head dim ``nope + rope``
    (v zero-padded to it, the output sliced back to ``v_head_dim``, so
    the kernel's ``d ** -0.5`` is MLA's scale), and the latents written
    into the cache in place. Decode runs the absorbed form over the
    cache: ``q_abs = q_nope . w_uk``, fp32 scores against the latents
    rounded to the compute dtype, the context in fp32 over the cache as
    it is, as the JAX package does."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    if mode == "train":
        raise NotImplementedError(
            "MLA training (_apply_mla's gradients and a launcher) is "
            "ROADMAP.md Queue 1 item 4; its expanded forward runs in "
            "prefill")
    a, m = cfg.attn, cfg.attn.mla
    dt = x.dtype
    s = x.shape[1]
    q_nope, q_rope = _mla_q(params, x, cfg)
    if mode == "decode":
        pos = cache["len"]
        positions = torch.full((1, 1), pos, dtype=torch.long,
                               device=x.device)
    q_rope = rope_lib.apply_rope(q_rope, positions, a.rope_theta)
    c_kv = torch.einsum("bsd,dr->bsr", x, params["w_dkv"].to(dt))
    k_rope = torch.einsum("bsd,dr->bsr", x, params["w_kr"].to(dt))
    k_rope = rope_lib.apply_rope(k_rope[:, :, None, :], positions,
                                 a.rope_theta)[:, :, 0, :]

    if mode == "prefill":
        k_nope = torch.einsum("bsr,rhe->bshe", c_kv, params["w_uk"].to(dt))
        v = torch.einsum("bsr,rhe->bshe", c_kv, params["w_uv"].to(dt))
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            k_nope.shape[:3] + (m.rope_head_dim,))], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        qk_dim = m.nope_head_dim + m.rope_head_dim
        vpad = F.pad(v, (0, qk_dim - m.v_head_dim))
        out = fa(q, k, vpad, causal=True)[..., :m.v_head_dim]
        new_cache = None
        if cache is not None:
            cache["c_kv"][:, :s] = c_kv
            cache["k_rope"][:, :s] = k_rope
            new_cache = {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"],
                         "len": s}
    else:
        pos = cache["len"]
        ckv_c, kr_c = cache["c_kv"], cache["k_rope"]
        ckv_c[:, pos:pos + 1] = c_kv
        kr_c[:, pos:pos + 1] = k_rope
        new_cache = {"c_kv": ckv_c, "k_rope": kr_c, "len": pos + 1}
        q_abs = torch.einsum("bshe,rhe->bshr", q_nope, params["w_uk"].to(dt))
        s_ = (torch.einsum("bshr,btr->bhst", q_abs.float(),
                           ckv_c.to(dt).float())
              + torch.einsum("bshe,bte->bhst", q_rope.float(),
                             kr_c.to(dt).float()))
        s_ = s_ * ((m.nope_head_dim + m.rope_head_dim) ** -0.5)
        valid = torch.arange(ckv_c.shape[1], device=x.device) < pos + 1
        s_ = torch.where(valid, s_, NEG_INF)
        p = torch.softmax(s_, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", p, ckv_c.float())
        out = torch.einsum("bshr,rhe->bshe", ctx.to(dt),
                           params["w_uv"].to(dt))
    out = torch.einsum("bshe,hed->bsd", out, params["w_o"].to(dt))
    return out, new_cache


def _apply_paged(params, x, *, cfg: ArchConfig, positions, is_global: bool,
                 window: int, cache: dict):
    """GQA over a paged KV pool; see ``apply``. The pools hold every
    position (no ring buffers): a window masks, as in the JAX package."""
    a = cfg.attn
    s = x.shape[1]
    q, k, v = _proj_qkv(params, x, cfg)
    q, k = _rope_qk(q, k, cfg, positions, is_global=is_global)
    valid = cache.get("write_valid")
    sink = cache.get("write_sink")
    sink = 0 if sink is None else sink
    k_pool = KV.scatter_pages(cache["k_pool"], cache["page_table"],
                              positions, k, valid, sink=sink)
    v_pool = KV.scatter_pages(cache["v_pool"], cache["page_table"],
                              positions, v, valid, sink=sink)
    new_cache = {"k_pool": k_pool, "v_pool": v_pool}

    kern = cache.get("attn_kernel")
    if kern not in ATTN_KERNELS:
        raise ValueError(f"attn_kernel must be one of {ATTN_KERNELS}, "
                         f"got {kern!r}")
    if s == 1 and kern == "kernel":
        from repro_torch.kernels.paged_attention import \
            paged_decode_attention
        out = paged_decode_attention(q.contiguous(), k_pool, v_pool,
                                     cache["page_table"],
                                     cache["lens"] + 1, window=window)
    else:
        kf = KV.gather_pages(k_pool, cache["page_table"])  # [B,NP*ps,Kv,D]
        vf = KV.gather_pages(v_pool, cache["page_table"])
        if s == 1:
            out = decode_attention(q, kf, vf, cache["lens"] + 1,
                                   window=window)
        else:
            assert x.shape[0] == 1, "paged chunked prefill runs one sequence"
            g = a.num_heads // a.num_kv_heads
            if g > 1:
                kf = kf.repeat_interleave(g, dim=2)
                vf = vf.repeat_interleave(g, dim=2)
            out = flash_attention(q, kf, vf, causal=True, window=window,
                                  q_offset=cache["lens"][0])
    out = torch.einsum("bshe,hed->bsd", out, params["w_o"].to(x.dtype))
    return out, new_cache


def apply(params, x, *, cfg: ArchConfig, positions, is_global: bool = True,
          mode: str = "prefill", cache: Optional[dict] = None):
    """Self-attention. Returns (out, new_cache).

    Over a paged KV pool (``repro_torch.serve``): ``cache`` holds
    ``k_pool``/``v_pool`` ``[P, ps, Kv, D]`` (MLA:
    ``ckv_pool``/``kr_pool``, see ``_apply_mla_paged``), ``page_table``
    ``[B, NP]``, ``lens`` ``[B]`` (tokens already cached per sequence),
    optionally ``write_valid`` ``[B, S]`` and ``write_sink`` ``[B]``,
    and ``attn_kernel``: ``"kernel"`` (decode through the CUDA
    paged-decode kernel) or ``"gather"``; anything else raises. The pools
    are updated in place and returned as the new cache. Decode (S == 1)
    runs every slot with its own cache length; chunked prefill (S > 1)
    requires B == 1 and attends the chunk against the gathered pages
    with ``q_offset = lens[0]``.

    Otherwise over a dense cache (``models/kv_cache.layer_cache``; MLA:
    ``_apply_mla``), or none: ``"train"`` and ``"prefill"`` attend over
    ``x`` through the flash kernel, prefill also filling the cache;
    ``"decode"`` appends one token at ``cache["len"]`` and attends over
    the cache with ``decode_attention``. The cache is updated in place
    and returned as the new cache (None without one).
    """
    if cache is not None and "ckv_pool" in cache:
        return _apply_mla_paged(params, x, cfg=cfg, positions=positions,
                                cache=cache)
    a = cfg.attn
    if a.mla is not None:
        return _apply_mla(params, x, cfg=cfg, positions=positions,
                          mode=mode, cache=cache)
    window = 0 if (is_global and a.global_period > 1) else a.window
    if cache is not None and "k_pool" in cache:
        return _apply_paged(params, x, cfg=cfg, positions=positions,
                            is_global=is_global, window=window, cache=cache)
    from repro_torch.kernels.flash_attention import flash_attention as fa
    q, k, v = _proj_qkv(params, x, cfg)
    q, k = _rope_qk(q, k, cfg, positions, is_global=is_global)
    if mode in ("train", "prefill"):
        new_cache = None
        if mode == "prefill" and cache is not None:
            new_cache = _fill_cache(cache, k, v, window)
        out = fa(q, k, v, causal=True, window=window)
    elif mode == "decode":
        new_cache = _append_cache(cache, k, v, window)
        ring = window > 0 and new_cache["k"].shape[1] == window
        out = decode_attention(q, new_cache["k"], new_cache["v"],
                               new_cache["len"], window=window, ring=ring)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return torch.einsum("bshe,hed->bsd", out, params["w_o"].to(x.dtype)), \
        new_cache
