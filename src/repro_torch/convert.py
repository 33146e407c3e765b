"""JAX parameter tree or train state (as numpy) -> the port's.

The two packages share every leaf's layout (``w_q`` ``[d, H, hd]``,
experts ``[E, d, h]``, ...), so conversion is a copy. The one difference
is depth: the JAX tree stacks each period leaf on a leading ``layers``
axis (``repro.models.module.stack``), which the port unstacks into a
list of per-period trees. The caller turns the JAX tree into numpy
first (``jax.tree.map(np.asarray, params)``), so this module never sees
a JAX array.

``shard_params`` turns the whole tree into one rank's under expert
parallelism (``moe.layer.shard_params``: its experts, ZeRO-3 shards of
them in training), and ``gather_params`` turns any tree shaped as a
rank's parameters (its gradients too) back into the whole tree on every
rank.

``from_jax_state`` carries a whole train state across (parameters, the
optimizer state of any of the three optimizers, the step), so a run
begun in the JAX package can go on in the port. The moments mirror the
parameters and are unstacked with them (an 8-bit moment, a ``q`` /
``scale`` pair, per period); Adafactor's ``factored`` state keeps the
JAX tree's stacked shape in the port too (``optim.adafactor``), so it is
copied as it is.

``shard_state`` turns a whole train state (the port's, or a JAX one
through ``from_jax_state``) into this rank's, and ``gather_state`` turns
a rank's back into the whole state on every rank: the parameters, the
compression error, the AdamW moments (an 8-bit moment's ``q`` is cut as
its parameter; its row ``scale`` is whole along a ZeRO-3 shard's
columns, so it is cut only over the experts) and Adafactor's ``vr`` /
``vc`` / ``v`` in their stacked JAX shapes (the experts on axis 1 there;
``vr`` spans the split columns and is cut only over the experts).
``leaf_cut`` is the one rule of which leaves are cut and how: the train
loop's gradient reductions, its optimizers' splits and its checkpoint
layout (``runtime.train_loop.state_layout``) read it too.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import gather_dim
from repro_torch.models.module import leaves
from repro_torch.moe import layer as moe_layer
from repro_torch.optim.adamw import Q8


def _to_torch(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _is_q8(x) -> bool:
    """An 8-bit moment of either package (a ``(q, scale)`` NamedTuple)."""
    return isinstance(x, tuple) and getattr(x, "_fields", None) == ("q",
                                                                    "scale")


def _map(tree, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if _is_q8(tree):
        return Q8(*(fn(t) for t in tree))
    return fn(tree)


def _slice(tree, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    if _is_q8(tree):
        return Q8(*(t[i] for t in tree))
    return tree[i]


def from_jax(params_np: dict, *, device=None) -> dict:
    """``{"embed", "periods", "final_norm"}`` numpy tree (periods stacked
    on axis 0) -> the port's tree with ``periods`` a list, on ``device``
    (default ``cuda``; raises without CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    periods = params_np["periods"]
    n = len(leaves(periods)[0])
    conv = lambda x: _to_torch(x, dev)  # noqa: E731
    return {
        "embed": _map(params_np["embed"], conv),
        "periods": [_map(_slice(periods, i), conv) for i in range(n)],
        "final_norm": _map(params_np["final_norm"], conv),
    }


def from_jax_state(state_np: dict, *, device=None) -> dict:
    """A JAX train state (``params``, ``opt`` of ``adamw``, ``adamw8bit``
    or ``adafactor``, ``step``; numpy leaves) -> the port's, on
    ``device`` (default ``cuda``; raises without CUDA unless
    ``device="cpu"``). The parameters come back with ``requires_grad``
    set, as ``runtime.init_state`` makes them."""
    dev = resolve_device(device)
    params = from_jax(state_np["params"], device=dev)
    for p in leaves(params):
        p.requires_grad_(True)
    opt = state_np["opt"]
    count = int(np.asarray(opt["count"]))
    if "factored" in opt:
        conv = lambda x: _to_torch(x, dev)  # noqa: E731
        new_opt = {"factored": _map(opt["factored"], conv), "count": count}
    else:
        new_opt = {"m": from_jax(opt["m"], device=dev),
                   "v": from_jax(opt["v"], device=dev), "count": count}
    return {"params": params, "opt": new_opt,
            "step": int(np.asarray(state_np["step"]))}


def _map_moe(tree, fn) -> Any:
    """``tree`` with each MoE layer's dict (the one holding ``experts``)
    replaced by ``fn(it)``."""
    if isinstance(tree, dict):
        if "experts" in tree and "router" in tree:
            return fn(tree)
        return {k: _map_moe(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_moe(v, fn) for v in tree]
    return tree


def shard_tree(params: dict, cfg, dist, mode: str = "train") -> dict:
    """The port's whole parameter tree -> this rank's (``dist``: a
    ``DistContext``; ``mode="train"`` takes ZeRO-3 shards where the
    JAX layer would, ``moe.layer.zero3_ok``)."""
    return _map_moe(params, lambda p: moe_layer.shard_params(p, cfg, dist,
                                                             mode))


def shard_params(params_np: dict, cfg, dist, *, mode: str = "train",
                 device=None) -> dict:
    """The JAX package's whole tree (numpy) -> this rank's tree on
    ``device`` (default: the context's)."""
    return shard_tree(from_jax(params_np, device=device or dist.device),
                      cfg, dist, mode)


@torch.no_grad()
def _gather_experts(experts: dict, dist, zero3: bool) -> dict:
    out = {}
    for k, v in experts.items():
        v = v.detach()
        if zero3:
            v = gather_dim(v, dist.dp_group, v.dim() - 1)
        out[k] = gather_dim(v, dist.ep_group, 0) if dist.ep_size > 1 else v
    return out


def gather_params(params: dict, cfg, dist, mode: str = "train") -> dict:
    """A tree shaped as this rank's parameters (or their gradients),
    sharded for ``mode`` -> the whole tree, on every rank (collective
    over the mesh)."""
    zero3 = moe_layer.zero3_ok(cfg, dist, mode)
    return _map_moe(params, lambda p: dict(
        p, experts=_gather_experts(p["experts"], dist, zero3)))


# ---------------------------------------------------------------------------
# Train states over ranks
# ---------------------------------------------------------------------------

def leaf_cut(path, zero3: bool) -> Optional[Tuple[int, bool]]:
    """How a train state's leaf at ``path`` (its keys, as ``str`` or
    ``int``) is cut over ranks: None where every rank holds it whole,
    else (the axis of its experts, whether its last axis is a ZeRO-3
    shard's split columns). Expert leaves lie under ``moe/experts``;
    Adafactor's stacked period statistics hold the periods on axis 0."""
    keys = [str(k) for k in path]
    if not any(a == "moe" and b == "experts"
               for a, b in zip(keys, keys[1:])):
        return None
    stacked = "factored" in keys and keys[keys.index("factored") + 1:
                                          ][:1] == ["periods"]
    return int(stacked), zero3 and keys[-1] not in ("vr", "scale")


def _map_path(tree, fn, path=()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_path(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_path(v, fn, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_path(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _parts(path, x, cfg, dist) -> list:
    """The cuts of a leaf on this rank: (axis, index, parts, group)."""
    cut = leaf_cut(path, moe_layer.zero3_ok(cfg, dist))
    if cut is None or not isinstance(x, torch.Tensor):
        return []
    axis, cols = cut
    out = [(axis, dist.ep_rank, dist.ep_size, dist.ep_group)]
    if cols:
        out.append((x.dim() - 1, dist.dp_rank, dist.dp_size, dist.dp_group))
    return [c for c in out if c[2] > 1]


def shard_state(state: dict, cfg, dist) -> dict:
    """A whole train state -> this rank's (copies; the parameters leaves
    that require grad, as ``runtime.init_state`` makes them)."""
    def cut(path, x):
        parts = _parts(path, x, cfg, dist)
        if parts:
            sl = [slice(None)] * x.dim()
            for axis, i, n, _ in parts:
                size = x.shape[axis] // n
                sl[axis] = slice(i * size, (i + 1) * size)
            x = x[tuple(sl)].clone()
        if path and path[0] == "params":
            x = x.detach().requires_grad_(True)
        return x
    return _map_path(state, cut)


@torch.no_grad()
def gather_state(state: dict, cfg, dist) -> dict:
    """A rank's train state -> the whole state, on every rank (collective
    over the mesh, leaf by leaf in the same order on every rank); the
    leaves every rank holds whole come back as they are, not copied."""
    def whole(path, x):
        for axis, _, _, group in _parts(path, x, cfg, dist):
            x = gather_dim(x.detach(), group, axis)
        return x
    return _map_path(state, whole)
