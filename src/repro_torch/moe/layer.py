"""MoE layer: router + dispatch + the pipelined engine, and the entry of
expert parallelism, as ``repro.moe.layer``.

Without ``dist`` (or on a 1 x 1 mesh) the layer runs on one device.
Under a ``DistContext`` each rank holds its data-parallel replica's
batch rows, whole sequences, and:

* with ``ep > 1`` it stands in for the JAX layer's ``shard_map``
  (``layer.py:59-121`` there). It enters the MoE with its ``1 / ep``
  slice of the sequence (sequence-parallel MoE: every rank of the EP
  group routes distinct tokens into the All-to-All), gathered back
  after the layer, or at decode with the EP group's tokens,
  replicated. Outside decode the sequence must split over ``ep``: the
  JAX layer's ``shard_map`` refuses a replicated output there, and
  replicated tokens would each reach an expert ``ep`` times. It holds
  its ``E / ep`` experts (``shard_params``), in training, where the
  sizes divide (``zero3_ok``), each also split on its last dim over
  the dp group (ZeRO-3, gathered inside). The aux losses are averaged
  (``pmean``) over the groups on which they vary.
* with ``ep == 1`` it computes what the JAX layer's plain branch
  computes over the global batch (``_global_batch``): its chunks,
  capacities and aux losses are those of the whole batch's tokens.

``replicated=True`` says that ``x`` is already the same on every rank of
the dp group (the serving engine's batch-1 prefill chunk, and the
decode batch over replicated pools), as a batch that the JAX layer does
not split over ``data``. With ``ep == 1`` the MoE then runs on that
batch as on one device; with ``ep > 1`` each dp group takes its
``B / dp`` rows where dp divides ``B`` (the JAX layer's
``b % dp_size == 0`` rule) and the rows are gathered back over dp after
the layer, else every group runs the whole batch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.pipeline_moe import _resolve_partitions, pipelined_moe
from repro_torch.distributed import collectives as C
from repro_torch.moe import experts as E
from repro_torch.moe import router as R


def specs(cfg: ArchConfig):
    s = {"router": R.specs(cfg), "experts": E.specs(cfg)}
    if cfg.moe.num_shared_experts:
        s["shared"] = E.shared_specs(cfg)
    return s


def zero3_ok(cfg: ArchConfig, dist, mode: str = "train") -> bool:
    """The JAX layer's ``zero3_ok``, the one place that decides whether
    a rank's expert leaves are ZeRO-3 shards: training in the
    expert-parallel branch (``ep > 1``) on a mesh with dp > 1 whose
    extent divides ``d_expert`` and ``d_model`` (every expert leaf's
    last dim)."""
    dp = dist.dp_size if dist is not None else 1
    return (mode == "train" and dp > 1 and dist.ep_size > 1
            and cfg.moe.d_expert % dp == 0 and cfg.d_model % dp == 0)


def expert_slice(shape, dist, zero3: bool) -> Tuple[slice, ...]:
    """The slice of a whole expert leaf ``[E, ..., D]`` that this rank
    holds: the counterpart of the JAX layer's ``_param_specs``."""
    out = [slice(None)] * len(shape)
    e_local = shape[0] // dist.ep_size
    out[0] = slice(dist.ep_rank * e_local, (dist.ep_rank + 1) * e_local)
    if zero3:
        d = shape[-1] // dist.dp_size
        out[-1] = slice(dist.dp_rank * d, (dist.dp_rank + 1) * d)
    return tuple(out)


def shard_params(params, cfg: ArchConfig, dist, mode: str = "train"):
    """One MoE layer's whole parameters -> this rank's: the expert leaves
    sliced (copies, so the whole leaves can be freed), the router and
    shared experts as they are (every rank holds them)."""
    z3 = zero3_ok(cfg, dist, mode)
    return dict(params, experts={
        k: v[expert_slice(v.shape, dist, z3)].clone()
        for k, v in params["experts"].items()})


def _global_batch(params, x: torch.Tensor, *, cfg: ArchConfig, mode: str,
                  dist) -> Tuple[torch.Tensor, dict]:
    """``ep == 1`` under dp > 1: the MoE over the global batch, as the
    JAX layer runs it (``layer.py:64``). The global batch's ``n`` chunks
    are cut from the rank-major token order, so where dp divides ``n``
    each chunk lies within one rank's rows: each rank runs its ``n /
    dp`` of them and the aux losses are averaged over dp. Otherwise
    every rank gathers the whole batch, runs all ``n`` chunks and keeps
    its rows; its aux losses are then the same on every rank, and the
    average over dp carries ``1 / dp`` of their cotangent to each."""
    b, s, d = x.shape
    dp = dist.dp_size
    n = _resolve_partitions(cfg, b * dp * s, mode)
    if n % dp == 0:
        out, aux = pipelined_moe(params, x.reshape(b * s, d), cfg=cfg,
                                 mode=mode, dist=dist, n=n // dp)
        out = out.reshape(b, s, d)
    else:
        whole = C.all_gather(x, dist.dp_group, 0)
        out, aux = pipelined_moe(params, whole.reshape(-1, d), cfg=cfg,
                                 mode=mode, dist=dist, n=n)
        out = out.reshape(dp * b, s, d)[dist.dp_rank * b:
                                        (dist.dp_rank + 1) * b]
    return out, {k: C.mean(v, dist.dp_group) for k, v in aux.items()}


def apply(params, x: torch.Tensor, *, cfg: ArchConfig,
          mode: str = "prefill", dist=None,
          replicated: bool = False) -> Tuple[torch.Tensor, dict]:
    """x ``[B, S, M]`` -> (``[B, S, M]``, aux). ``replicated``: see the
    module docstring."""
    b, s, d = x.shape
    if replicated and dist is not None and dist.dp_size > 1:
        if dist.ep_size == 1:
            dist = None                  # the plain branch, on every rank
        elif b % dist.dp_size == 0:
            rows = b // dist.dp_size
            r0 = dist.dp_rank * rows
            out, aux = apply(params, x[r0:r0 + rows], cfg=cfg, mode=mode,
                             dist=dist)
            return C.all_gather(out, dist.dp_group, 0), aux
    if dist is None or dist.world_size == 1:
        out, aux = pipelined_moe(params, x.reshape(b * s, d), cfg=cfg,
                                 mode=mode)
        return out.reshape(b, s, d), aux
    if dist.ep_size == 1:
        return _global_batch(params, x, cfg=cfg, mode=mode, dist=dist)
    seq = mode != "decode"
    if seq and s % dist.ep_size:
        raise NotImplementedError(
            f"{mode} over ep={dist.ep_size} ranks needs a sequence length "
            f"that splits over them, not {s} (the JAX layer's shard_map "
            f"refuses it too)")
    xl = C.scatter_seq(x, dist.ep_group) if seq else x
    out, aux = pipelined_moe(params, xl.reshape(-1, d), cfg=cfg, mode=mode,
                             dist=dist, zero3=zero3_ok(cfg, dist, mode))
    out = out.reshape(xl.shape)
    if seq:
        out = C.gather_seq(out, dist.ep_group)
        # pmean over the groups on which the value varies (None: the world)
        aux = {k: C.mean(v, None) for k, v in aux.items()}
    elif dist.dp_size > 1:
        aux = {k: C.mean(v, dist.dp_group) for k, v in aux.items()}
    return out, aux
