"""JAX parameter tree or train state (as numpy) -> the port's.

The two packages share every leaf's layout (``w_q`` ``[d, H, hd]``,
experts ``[E, d, h]``, ...), so conversion is a copy. The one difference
is depth: the JAX tree stacks each period leaf on a leading ``layers``
axis (``repro.models.module.stack``), which the port unstacks into a
list of per-period trees. The caller turns the JAX tree into numpy
first (``jax.tree.map(np.asarray, params)``), so this module never sees
a JAX array.

``from_jax_state`` carries a whole train state across (parameters, the
optimizer state of any of the three optimizers, the step), so a run
begun in the JAX package can go on in the port. The moments mirror the
parameters and are unstacked with them (an 8-bit moment, a ``q`` /
``scale`` pair, per period); Adafactor's ``factored`` state keeps the
JAX tree's stacked shape in the port too (``optim.adafactor``), so it is
copied as it is.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.module import leaves
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
