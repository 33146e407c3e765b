"""JAX parameter tree (as numpy) -> the port's parameter tree.

The two packages share every leaf's layout (``w_q`` ``[d, H, hd]``,
experts ``[E, d, h]``, ...), so conversion is a copy. The one difference
is depth: the JAX tree stacks each period leaf on a leading ``layers``
axis (``repro.models.module.stack``), which the port unstacks into a
list of per-period trees. The caller turns the JAX tree into numpy
first (``jax.tree.map(np.asarray, params)``), so this module never sees
a JAX array.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.module import leaves


def _to_torch(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _map(tree, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _slice(tree, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
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

