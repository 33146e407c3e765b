"""Minimal functional parameter system, on ``torch.Generator``.

The counterpart of ``repro.models.module``: models declare parameter
*specs* (shape + logical axes + init) and ``build`` materializes a tree
of tensors (nested dicts and lists) with the same layouts as the JAX
package. Where JAX stacks a period's specs on a leading ``layers`` axis
for ``lax.scan``, ``stack`` here gives a list of per-period trees that
the model walks with a Python loop.

``build`` draws from the caller's ``torch.Generator`` in the sorted-key
order of the tree, so a seed fixes the weights. The draws are not JAX's
(``jax.random`` and torch generators differ): tests that need the same
weights in both packages convert them with ``repro_torch.convert``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis names (len == ndim)
    init: str = "normal"                 # normal | zeros | ones | embed
    scale: float = 0.0                   # 0 => fan-in default for "normal"
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _fan_in(shape: Tuple[int, ...]) -> int:
    # convention: last dim is fan-out; product of the rest is fan-in
    if len(shape) <= 1:
        return max(1, shape[0] if shape else 1)
    return int(math.prod(shape[:-1]))


def _materialize(spec: Spec, gen: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "embed":
        scale = spec.scale or 1.0
    elif spec.init == "normal":
        scale = spec.scale or (1.0 / math.sqrt(_fan_in(spec.shape)))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    x = torch.randn(spec.shape, generator=gen, dtype=spec.dtype,
                    device=device)
    return x.mul_(scale)


def leaves(tree) -> list:
    """Leaves in sorted-key order (lists in index order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def _unflatten(t, it) -> Any:
    if isinstance(t, dict):
        out = {k: _unflatten(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    if isinstance(t, (list, tuple)):
        return [_unflatten(v, it) for v in t]
    return next(it)


def unflatten(tree, flat: list) -> Any:
    """``flat`` (in ``leaves(tree)`` order) put back into ``tree``'s
    nesting of dicts and lists. (A module-level recursion: a recursive
    closure would be a reference cycle keeping ``flat``'s tensors alive
    until the garbage collector runs.)"""
    it = iter(flat)
    out = _unflatten(tree, it)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree holds")
    return out


def build(spec_tree, gen: torch.Generator, device,
          leaf_fn: Optional[Callable[[tuple, torch.Tensor],
                                     torch.Tensor]] = None,
          path: tuple = ()) -> Any:
    """Materialize a tree of Specs into tensors on ``device``, drawing
    from ``gen`` leaf by leaf in sorted-key order (deterministic).
    ``leaf_fn(path, leaf)``, when given, replaces each leaf as soon as it
    is drawn, before the next one is: a cast there keeps one fp32 leaf
    alive at a time instead of the whole fp32 tree."""
    device = torch.device(device)
    if isinstance(spec_tree, dict):
        return {k: build(spec_tree[k], gen, device, leaf_fn, path + (k,))
                for k in sorted(spec_tree)}
    if isinstance(spec_tree, (list, tuple)):
        return [build(v, gen, device, leaf_fn, path + (i,))
                for i, v in enumerate(spec_tree)]
    x = _materialize(spec_tree, gen, device)
    return x if leaf_fn is None else leaf_fn(path, x)


def stack(spec_tree, n: int) -> list:
    """``n`` per-period copies of a spec tree (the Python-loop analogue
    of the JAX package's stacked ``layers`` axis)."""
    return [spec_tree] * n


def count(spec_tree) -> int:
    return sum(int(math.prod(s.shape)) for s in leaves(spec_tree))


def cast_leaf(x, dtype: torch.dtype, keep: Callable[[tuple], bool],
              path: tuple):
    """``x`` cast to ``dtype`` if it is a floating tensor whose key path
    ``keep(path)`` does not hold; otherwise ``x`` as it is."""
    if (isinstance(x, torch.Tensor) and x.is_floating_point()
            and not keep(path)):
        return x.to(dtype)
    return x


def cast_tree(params, dtype: torch.dtype, keep: Callable[[tuple], bool],
              path: tuple = ()):
    """Floating leaves cast to ``dtype`` (a copy made once at load), except
    leaves whose key path ``keep(path)`` holds, which stay as they are."""
    if isinstance(params, dict):
        return {k: cast_tree(v, dtype, keep, path + (k,))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(cast_tree(v, dtype, keep, path + (i,))
                            for i, v in enumerate(params))
    return cast_leaf(params, dtype, keep, path)
