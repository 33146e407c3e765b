"""The parameter tree as the JAX package's optimizers see it.

The JAX tree stacks every period leaf on a leading ``layers`` axis, so
``periods/l0/mixer_norm/scale`` is one ``[P, d]`` leaf there; the port
holds ``params["periods"]`` as a list of ``P`` per-period trees. AdamW is
elementwise and never notices. The 8-bit AdamW and Adafactor do: the
first quantises a leaf by its stacked rank, and Adafactor's factored
statistics and its update's RMS clip run over the whole stacked leaf,
across periods. ``groups`` gathers the period leaves by path so that an
optimizer can compute those statistics period by period, without
stacking the leaves themselves.

A tree here nests dicts and lists; anything else (a tensor, a ``Q8``
pair) is a leaf.

Over ranks (``runtime.train(dist=)``) a leaf may be a shard of the JAX
package's global leaf: ``Split`` says over which process groups, so that
an optimizer's statistics that span the split axes take their
collective.
"""
from __future__ import annotations

from typing import Any, Iterator, List, NamedTuple, Tuple

Path = Tuple[Any, ...]


class Split(NamedTuple):
    """How a leaf (or a stacked group) is cut over ranks. ``cols``: the
    process group its last axis is split over (a ZeRO-3 expert shard's
    dp group), ``cols_ranks`` that group's size; ``whole``: the group
    over which the whole leaf is split (an expert leaf's EP group, or
    the world under ZeRO-3), ``whole_ranks`` its size. An optimizer
    takes ``split(path) -> Split | None`` (None: the whole leaf)."""
    cols: Any = None
    cols_ranks: int = 1
    whole: Any = None
    whole_ranks: int = 1


class Group(NamedTuple):
    path: Path          # ("periods", "l0", ...) for a stacked group
    leaves: list        # one leaf, or one per period
    stacked: bool       # True: the JAX leaf is these stacked on axis 0


def paths(tree, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in sorted-key order (lists in index order), the
    order of ``models.module.leaves``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from paths(v, prefix + (i,))
    else:
        yield prefix, tree


def get(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def _stacks(tree) -> bool:
    return (isinstance(tree, dict) and isinstance(tree.get("periods"), list)
            and len(tree["periods"]) > 0)


def groups(tree) -> List[Group]:
    """Every leaf of ``tree`` in one group, except that the leaves at one
    path of each period of a top-level ``periods`` list form one stacked
    group (path ``("periods", *path_in_period)``)."""
    if not _stacks(tree):
        return [Group(p, [x], False) for p, x in paths(tree)]
    out = []
    for k in sorted(tree):
        if k != "periods":
            out += [Group((k,) + p, [x], False) for p, x in paths(tree[k])]
            continue
        per = tree[k]
        for p, _ in paths(per[0]):
            out.append(Group((k,) + p, [get(t, p) for t in per], True))
    return out


def _mirror(t, fn, prefix: Path, per) -> Any:
    if isinstance(t, dict):
        return {k: _mirror(t[k], fn, prefix + (k,), per) for k in t}
    if isinstance(t, list):
        return [_mirror(v, fn, prefix + (i,), per) for i, v in enumerate(t)]
    if per is None:
        return fn(Group(prefix, [t], False))
    return fn(Group(("periods",) + prefix, [get(q, prefix) for q in per],
                    True))


def mirror(tree, fn) -> Any:
    """A tree of ``fn(group)`` shaped as the JAX tree: ``tree``'s nesting
    with ``periods`` one per-period tree (its leaves standing for the
    stacked ones) instead of a list."""
    if not _stacks(tree):
        return _mirror(tree, fn, (), None)
    return {k: (_mirror(v[0], fn, (), v) if k == "periods"
                else _mirror(v, fn, (k,), None))
            for k, v in tree.items()}


# fp32 elements a slice of a large leaf may hold in each temporary that an
# update makes (128 MB): one expert of moe-gpt3-xl's [64, 2048, 8192]
# expert weights is 16.8 M, where the whole leaf's temporaries would be
# 4.3 GB each
SLICE_ELEMENTS = 1 << 25


def slices(shape, min_dim: int) -> Iterator[slice]:
    """Slices along axis 0 of a leaf of ``shape`` that keep each slice
    within ``SLICE_ELEMENTS``; the whole leaf (``slice(None)``) when it
    has fewer than ``min_dim`` axes or fits already. Slicing axis 0 keeps
    every statistic that runs over the last ``min_dim - 1`` axes exact."""
    numel = 1
    for s in shape:
        numel *= s
    if len(shape) < min_dim or numel <= SLICE_ELEMENTS:
        yield slice(None)
        return
    per = numel // shape[0]
    n = max(1, SLICE_ELEMENTS // max(per, 1))
    for i in range(0, shape[0], n):
        yield slice(i, i + n)
