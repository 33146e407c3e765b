"""Decoder-only language model: init, the training forward and loss, the
dense-cache forward with ``prefill`` / ``decode_step`` and the paged
forward with its two serving steps, as ``repro.models.lm``.

Under a ``DistContext`` (``dist``) each rank holds its data-parallel
replica's rows of the batch and this rank's shard of the experts
(``convert.shard_params``); the MoE layers run expert parallelism over
the EP group (``moe.layer``). The training loss divides by the global
count of valid labels, so the ranks' losses sum to the loss of the
whole batch (``loss_fn``). The paged serving steps run under ``dist``
too, over this rank's pools in its own page ids (``serve.paged_kv``):
``prefill_chunk_paged``'s one-sequence chunk is the same on every rank,
and so is ``decode_step_paged``'s batch over replicated pools; over
dp-sharded pools (``kv_sharded``) each rank decodes its shard's slots.

Depth is a Python loop over the layer periods (JAX scans a stacked
``periods`` axis). Parameters keep the JAX package's layouts, with the
``periods`` axis unstacked into a list — ``repro_torch.convert`` turns a
JAX tree into this one by slicing. Dense caches and paged pools are
updated in place; the steps still return them, so the call sites read
like the JAX package's.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import dtype_of, resolve_device
from repro_torch.models import blocks, kv_cache, module
from repro_torch.models.layers import embedding, norm


def specs_tree(cfg: ArchConfig):
    if cfg.kind != "decoder":
        raise NotImplementedError(
            "encoder-decoder models come with ROADMAP.md's 'Other "
            "architectures' slice")
    roles = cfg.layer_roles()
    period = {f"l{i}": blocks.block_specs(cfg, role)
              for i, role in enumerate(roles)}
    return {
        "embed": embedding.specs(cfg),
        "periods": module.stack(period, cfg.num_periods),
        "final_norm": norm.specs(cfg.d_model, cfg.norm),
    }


def _draw(cfg: ArchConfig, seed: int, device, leaf_fn=None):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return module.build(specs_tree(cfg), gen, dev, leaf_fn)


def init(cfg: ArchConfig, seed: int = 0, *, device=None):
    """Random fp32 parameters from a seeded ``torch.Generator`` on
    ``device`` (default ``cuda``; raises without CUDA unless
    ``device="cpu"``)."""
    return _draw(cfg, seed, device)


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    total = module.count(specs_tree(cfg))
    if active_only and cfg.moe is not None:
        from repro_torch.moe import experts as E
        per_layer = module.count(E.specs(cfg))
        n_moe = cfg.num_periods * sum(r["moe"] for r in cfg.layer_roles())
        inactive = 1.0 - cfg.moe.top_k / cfg.moe.num_experts
        total -= int(n_moe * per_layer * inactive)
    return total


def _keeps_fp32(path: tuple) -> bool:
    return "router" in path


def compute_params(params, cfg: ArchConfig):
    """The compute-dtype copy of the weights, made once at load. The
    router gate stays fp32, as the JAX package's gate casts to fp32 per
    op; every other float leaf is cast to ``cfg.compute_dtype``."""
    return module.cast_tree(params, dtype_of(cfg.compute_dtype),
                            keep=_keeps_fp32)


def init_compute(cfg: ArchConfig, seed: int = 0, *, device=None):
    """``compute_params(init(cfg, seed))``, bit for bit, without ever
    holding the fp32 tree: each leaf is drawn in fp32 from the same
    seeded generator in the same order as ``init`` draws it and cast at
    once, so at most one fp32 leaf lives beside the compute-dtype tree
    (DeepSeek-V2-Lite: 32.4 GB of bf16 weights instead of 64.8 GB of fp32
    beside them)."""
    dt = dtype_of(cfg.compute_dtype)
    return _draw(cfg, seed, device, lambda path, x: module.cast_leaf(
        x, dt, _keeps_fp32, path))


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``"dots"``: the counterpart of
    JAX's ``dots_with_no_batch_dims_saveable``. Save the outputs of the
    products that have no batch dimension and recompute everything else.
    The port's products reach three aten ops (logged on the train
    forward): ``mm`` for ``x @ w`` (dense FFN, router logits, LM head),
    ``bmm`` with a batch of 1 where ``torch.einsum`` has no batch label
    to keep (the q/k/v and output projections, ``bsd,dhe->bshe``), and
    ``bmm`` over a real batch (attention's scores and PV in the plain
    version, the experts' ``[E, C, M]`` products). The first two are
    saved, the third is recomputed; so are the CUDA kernels, which are
    no aten ops. A real batch of one (one expert, or one batch row with
    one KV head) would be saved too: the values are the same either
    way, only the memory differs."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg: ArchConfig):
    """Layer-level rematerialisation of a period body, as the JAX
    package's ``_remat_wrap``: ``"nothing"`` keeps every activation,
    ``"full"`` recomputes the period in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), ``"dots"`` recomputes
    it but keeps the outputs of its products without a batch dimension
    (``_dots_policy``, through a selective-checkpoint context)."""
    if cfg.remat_policy == "nothing":
        return fn
    if cfg.remat_policy == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat_policy == "dots":
        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _dots_policy)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        context_fn=context)
    raise ValueError(cfg.remat_policy)


def _forward_train(params, tokens: torch.Tensor, cfg: ArchConfig,
                   dist=None):
    dt = dtype_of(cfg.compute_dtype)
    x = embedding.embed(params["embed"], tokens, cfg, dtype=dt)
    b, s = tokens.shape
    if cfg.positional == "learned":
        x = x + params["embed"]["pos"][:s].to(dt)[None]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    roles = cfg.layer_roles()

    def period(x, aux_loss, z_loss, pparams):
        for i, role in enumerate(roles):
            x, a, _ = blocks.block_apply(pparams[f"l{i}"], x, cfg=cfg,
                                         role=role, positions=positions,
                                         mode="train", dist=dist)
            if a:
                aux_loss = aux_loss + a["aux_loss"]
                z_loss = z_loss + a["z_loss"]
        return x, aux_loss, z_loss

    body = _remat_wrap(period, cfg)
    aux_loss = torch.zeros((), device=x.device)
    z_loss = torch.zeros((), device=x.device)
    for pparams in params["periods"]:
        x, aux_loss, z_loss = body(x, aux_loss, z_loss, pparams)
    x = norm.apply(params["final_norm"], x, cfg.norm)
    logits = embedding.logits(params["embed"], x, cfg)
    return logits, {"aux_loss": aux_loss, "z_loss": z_loss}, None


def forward(params, tokens: torch.Tensor, cfg: ArchConfig, *,
            mode: str, cache: Optional[dict] = None, dist=None,
            replicated: bool = False):
    """Returns (logits, aux, new_cache).

    ``mode="train"`` without a cache: the whole sequence at learned
    positions 0..S-1, each period under ``cfg.remat_policy``, each MoE
    chunk under the config's strategy; ``new_cache`` is None.

    Over a paged ``cache``: ``layers`` (the per-period pools),
    ``page_table``, ``lens``, ``attn_kernel`` (``"kernel"`` or
    ``"gather"``), and optionally ``write_valid``, ``write_sink``;
    ``new_cache`` is ``{"layers"}``.

    Over a dense ``cache`` (``init_cache``: ``layers`` and ``pos``):
    ``"prefill"`` runs the prompt at positions 0..S-1 and fills the
    cache, ``"decode"`` one token per sequence at ``pos``; ``new_cache``
    is ``{"layers", "pos"}`` with ``pos`` advanced. ``"prefill"`` without
    a cache returns the logits only. The MoE layers run decode at n = 1
    and prefill at the config's n, as in the JAX package. ``dist``: see
    the module's docstring; ``replicated``: the batch is the same on
    every rank of the dp group (``moe.layer.apply``)."""
    if cache is None and mode == "train":
        return _forward_train(params, tokens, cfg, dist)
    if cache is None and mode != "prefill":
        raise ValueError(f"mode {mode!r} needs a cache")
    dt = dtype_of(cfg.compute_dtype)
    paged = cache is not None and "page_table" in cache
    b = tokens.shape[0]

    if mode == "decode":
        if paged:
            positions = cache["lens"][:, None].long()     # per-slot [B, 1]
        else:
            positions = torch.full((b, 1), cache["pos"], dtype=torch.long,
                                   device=tokens.device)
        x = embedding.embed(params["embed"], tokens, cfg,
                            positions=positions, dtype=dt)
    else:
        x = embedding.embed(params["embed"], tokens, cfg, dtype=dt)
        s = x.shape[1]
        base = torch.arange(s, device=x.device)[None, :]
        if paged:                                         # chunk at offset
            positions = cache["lens"][:, None].long() + base
        else:
            positions = base.expand(b, s)
        if cfg.positional == "learned":
            x = x + params["embed"]["pos"][positions[0]].to(dt)[None]

    shared_kv = {k: cache.get(k) for k in ("page_table", "lens",
                                           "write_valid", "write_sink",
                                           "attn_kernel")
                 if cache.get(k) is not None} if paged else {}
    roles = cfg.layer_roles()
    aux = {"aux_loss": torch.zeros((), device=x.device),
           "z_loss": torch.zeros((), device=x.device)}
    layers = (cache["layers"] if cache is not None
              else [None] * cfg.num_periods)
    new_layers = []
    for pparams, pcache in zip(params["periods"], layers):
        new_pcache = {}
        for i, role in enumerate(roles):
            lcache = (None if pcache is None
                      else dict(pcache[f"l{i}"], **shared_kv))
            x, a, nc = blocks.block_apply(
                pparams[f"l{i}"], x, cfg=cfg, role=role,
                positions=positions, mode=mode, cache=lcache, dist=dist,
                replicated=replicated)
            for k in a:
                aux[k] = aux[k] + a[k]
            new_pcache[f"l{i}"] = nc
        new_layers.append(new_pcache)

    x = norm.apply(params["final_norm"], x, cfg.norm)
    logits = embedding.logits(params["embed"], x, cfg)
    if cache is None:
        return logits, aux, None
    if paged:
        return logits, aux, {"layers": new_layers}
    pos = cache["pos"] + 1 if mode == "decode" else x.shape[1]
    return logits, aux, {"layers": new_layers, "pos": pos}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, dist=None):
    """Mean next-token NLL over labels >= 0, in fp32, as the JAX
    package's ``cross_entropy`` (its masked reduction picks the label
    logit; a gather picks the same value without a ``[B, S, V]`` mask).
    Under ``dist`` with dp > 1 the count of valid labels is the whole
    batch's (an ``all_reduce`` over the dp group), so this rank's value
    is its share of the whole batch's mean."""
    valid = labels >= 0
    lab = torch.where(valid, labels, 0).long()
    x = logits.float()
    m = x.amax(dim=-1, keepdim=True).detach()
    shifted = x - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    label_logit = shifted.gather(-1, lab[..., None])[..., 0]
    nll = lse - label_logit
    count = valid.sum()
    if dist is not None and dist.dp_size > 1:
        torch.distributed.all_reduce(count, group=dist.dp_group)
    denom = torch.clamp(count, min=1)
    return torch.where(valid, nll, 0.0).sum() / denom


def loss_fn(params, batch: dict, cfg: ArchConfig, dist=None):
    """``batch``: ``tokens`` and ``labels`` ``[B, S]``. Returns (loss,
    metrics ``ce``, ``aux_loss``, ``z_loss``, ``loss``).

    Under ``dist`` the batch is this rank's rows and ``loss`` is this
    rank's share: its ``ce`` term over the whole batch's count of valid
    labels plus the aux losses, averaged over the mesh; the shares of
    the dp group sum to the whole batch's loss. The metrics are the
    whole batch's (``ce`` summed over the dp group)."""
    logits, aux, _ = forward(params, batch["tokens"], cfg, mode="train",
                             dist=dist)
    labels = batch["labels"]
    logits = logits[:, -labels.shape[1]:]
    ce = cross_entropy(logits, labels, dist)
    loss = ce + aux["aux_loss"] + aux["z_loss"]
    if dist is not None and dist.dp_size > 1:
        ce = ce.detach().clone()
        torch.distributed.all_reduce(ce, group=dist.dp_group)
    return loss, {"ce": ce, "aux_loss": aux["aux_loss"],
                  "z_loss": aux["z_loss"],
                  "loss": ce + aux["aux_loss"] + aux["z_loss"]}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> dict:
    """A zero-filled dense cache of ``batch`` sequences of up to
    ``max_len`` tokens: ``{"layers": [per period], "pos": 0}``, on
    ``device`` (default ``cuda``; raises without CUDA unless
    ``device="cpu"``)."""
    return {"layers": kv_cache.init_cache(cfg, batch, max_len, dtype,
                                          resolve_device(device)),
            "pos": 0}


def decode_step(params, cache: dict, tokens: torch.Tensor,
                cfg: ArchConfig, dist=None):
    """One token per sequence over a dense cache: tokens ``[B, 1]`` ->
    (logits ``[B, vocab]``, cache — updated in place, ``pos`` + 1).
    Under ``dist`` the MoE layers run the replicated decode."""
    logits, _, new_cache = forward(params, tokens, cfg, mode="decode",
                                   cache=cache, dist=dist)
    return logits[:, -1], new_cache


def prefill(params, tokens: torch.Tensor, cfg: ArchConfig, max_len: int,
            dtype=torch.bfloat16, dist=None):
    """The prompts ``[B, S]`` into a fresh dense cache of ``max_len``
    tokens (in ``dtype``, on the tokens' device). Returns (logits ``[B,
    S, vocab]``, cache with ``pos`` = S). Under ``dist`` the MoE layers
    run the sharded layout (the sequence split over the EP group)."""
    cache = init_cache(cfg, tokens.shape[0], max_len, dtype,
                       device=tokens.device)
    logits, _, new_cache = forward(params, tokens, cfg, mode="prefill",
                                   cache=cache, dist=dist)
    return logits, new_cache


def init_paged_cache(cfg: ArchConfig, num_pages: int, page_size: int,
                     dtype=torch.bfloat16, device="cpu"):
    """Global page pools shared by every in-flight sequence."""
    return kv_cache.init_paged_pools(cfg, num_pages, page_size, dtype,
                                     device)


def decode_step_paged(params, pools, page_table, lens, tokens,
                      cfg: ArchConfig, active=None, write_sink=None,
                      attn_kernel: Optional[str] = None, dist=None,
                      kv_sharded: bool = False):
    """One decode step over the whole continuous batch.

    pools: the per-period paged pools; page_table ``[slots, NP]``; lens
    ``[slots]`` (tokens cached per slot); tokens ``[slots, 1]``;
    ``active`` ``[slots]`` masks finished / mid-prefill slots so their
    KV writes land in the sink (page 0, or per-slot ``write_sink``).
    ``attn_kernel``: ``"kernel"`` runs the CUDA paged-decode kernel,
    ``"gather"`` the gather baseline; None picks ``"kernel"`` for CUDA
    tensors and ``"gather"`` for CPU ones. Under ``dist`` the slots are
    every slot (replicated pools, the same batch on every rank) or, with
    ``kv_sharded``, this rank's shard's. Returns (last-token logits
    ``[slots, vocab]``, pools — updated in place).
    """
    if attn_kernel is None:
        attn_kernel = "kernel" if tokens.device.type == "cuda" else "gather"
    cache = {"layers": pools, "page_table": page_table, "lens": lens,
             "attn_kernel": attn_kernel}
    if active is not None:
        cache["write_valid"] = active[:, None]
    if write_sink is not None:
        cache["write_sink"] = write_sink
    logits, _, new_cache = forward(params, tokens, cfg, mode="decode",
                                   cache=cache, dist=dist,
                                   replicated=not kv_sharded)
    return logits[:, -1], new_cache["layers"]


def prefill_chunk_paged(params, pools, page_table, pos0, tokens, valid_len,
                        cfg: ArchConfig, write_sink=None, dist=None):
    """One chunked-prefill step for a single sequence.

    tokens ``[1, C]`` (bucket-padded); page_table ``[1, NP]``; pos0
    ``[1]`` = tokens already prefilled; valid_len (int) = real tokens in
    this chunk; ``write_sink`` ``[1]`` = the sink page masked writes go
    to. Pad positions' KV writes are masked and their logits discarded.
    Under ``dist`` every rank runs the same chunk (the MoE splits its
    sequence over the EP group). Returns (logits at the last real token
    ``[1, vocab]``, pools — updated in place).
    """
    c = tokens.shape[1]
    valid_len = int(valid_len)
    write_valid = torch.arange(c, device=tokens.device)[None, :] < valid_len
    cache = {"layers": pools, "page_table": page_table, "lens": pos0,
             "write_valid": write_valid, "attn_kernel": "gather"}
    if write_sink is not None:
        cache["write_sink"] = write_sink
    logits, _, new_cache = forward(params, tokens, cfg, mode="prefill",
                                   cache=cache, dist=dist, replicated=True)
    return logits[:, max(valid_len - 1, 0)], new_cache["layers"]
