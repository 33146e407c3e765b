"""Adafactor (factored second moment, no first moment), as
``repro.optim.adafactor``: the memory-lean optimizer, whose state is
O(rows + cols) per matrix instead of O(rows x cols).

A leaf whose JAX rank is 2 or more keeps ``vr`` (the mean of ``g^2 +
eps`` over its last axis) and ``vc`` (over its second-to-last axis);
any other leaf keeps a full ``v``. The JAX rank of a period leaf is its
rank + 1 (``optim.groups``), and its state keeps the JAX package's
stacked shape, one ``vr``/``vc`` pair for the path and not one a period:
``state["factored"]`` is shaped as the JAX tree, so ``convert`` carries
it over with a copy. For a 1-D period leaf ``[d]`` (stacked ``[P, d]``)
that makes ``vr`` ``[P]`` and ``vc`` ``[d]``: ``vc`` averages over the
periods, and ``r = vr / mean(vr)`` mixes them. The update's RMS clip
``mean(u * u)`` runs over the whole stacked leaf for every period leaf.

The update keeps JAX's order of operations: ``g2 = g * g + eps``, the
running means, ``r``, the two ``rsqrt``s, the RMS clip, then the decay
term. It never stacks the period leaves: a first pass updates ``vr`` and
``vc`` period by period (the cross-period column mean from a sum over
periods), a second sums ``u * u`` for the RMS, and a third recomputes
``u`` and writes the parameters in place. A large period leaf is walked
in slices along its axis 0 (``groups.slices``), which keeps every
statistic over its last two axes exact.

Over ranks, ``update(split=)`` names each group's ``groups.Split``. An
expert leaf ``w_up [E, M, H]`` / ``w_down [E, H, M]`` is split on E over
the EP group and, as a ZeRO-3 shard, on its last axis over dp: ``vr``'s
sum over the last axis is then summed over dp before it is divided by
the global width (``vr`` comes out the same on every rank of the
group), while ``vc`` (axis -2) and ``r``'s mean over ``vr``'s last axis
read whole axes. The RMS clip's sum of ``u * u`` is summed over the
group the leaf is split over and divided by the global count. The
replicated leaves take no collective: their gradients are already
reduced and equal on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.optim.groups import (Group, Split, get, groups, mirror,
                                     slices)


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8          # beta2_t = 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0


def _jax_shape(g: Group) -> tuple:
    shape = tuple(g.leaves[0].shape)
    return (len(g.leaves),) + shape if g.stacked else shape


def _factored(shape) -> bool:
    return len(shape) >= 2


def init(params, cfg: AdafactorConfig) -> Dict:
    def state_like(g: Group):
        shape = _jax_shape(g)
        dev = g.leaves[0].device
        zeros = lambda s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                      device=dev)
        if _factored(shape):
            return {"vr": zeros(shape[:-1]),
                    "vc": zeros(shape[:-2] + shape[-1:])}
        return {"v": zeros(shape)}
    return {"factored": mirror(params, state_like), "count": 0}


def _at(x, sl):
    """``x[sl]``, or ``x`` itself for the whole leaf (which may be 0-d)."""
    return x if sl == slice(None) else x[sl]


@torch.no_grad()
def _update_group(gr: Group, grads: list, s: Dict, cfg: AdafactorConfig,
                  beta2: float, lr: float, sp: Split = Split()) -> None:
    """One group's update (its leaves and state written in place); ``sp``
    how the group is cut over ranks."""
    shape = _jax_shape(gr)
    n_per = len(gr.leaves)
    factored = _factored(shape)
    # a period leaf of rank >= 2 keeps its own rows and columns; a 1-D
    # period leaf shares vc and vr's mean across the periods
    shared = factored and gr.stacked and len(shape) == 2
    f32 = np.float32
    one_m = float(f32(1) - f32(beta2))
    eps = cfg.eps
    min_dim = 3 if factored else 1        # keep axes -1 and -2 whole

    def state_of(i, key):
        x = s[key]
        return x[i] if gr.stacked and not (shared and key == "vc") else x

    def grad(i, sl):
        g = grads[i]
        if g is None:
            return torch.zeros(_at(gr.leaves[i], sl).shape,
                               dtype=torch.float32,
                               device=gr.leaves[i].device)
        return _at(g, sl).float()

    # pass 1: the running means
    col = None
    for i in range(n_per):
        for sl in slices(gr.leaves[i].shape, min_dim):
            g = grad(i, sl)
            g2 = g * g + eps
            del g
            if not factored:
                v = _at(state_of(i, "v"), sl)
                v.copy_(beta2 * v + one_m * g2)
                continue
            vr = _at(state_of(i, "vr"), sl)
            rows = g2.sum(-1)
            if sp.cols is not None:
                dist.all_reduce(rows, group=sp.cols)
            vr.copy_(beta2 * vr + one_m * (rows / (g2.shape[-1]
                                                   * sp.cols_ranks)))
            if shared:
                col = g2 if col is None else col + g2
            else:
                vc = _at(state_of(i, "vc"), sl)
                vc.copy_(beta2 * vc + one_m * (g2.sum(-2) / g2.shape[-2]))
    if shared:
        s["vc"].copy_(beta2 * s["vc"] + one_m * (col / n_per))
        del col
        denom = s["vr"].sum() / n_per               # over the periods

    def u_of(i, sl):
        g = grad(i, sl)
        if not factored:
            v = _at(state_of(i, "v"), sl)
            return g * torch.rsqrt(torch.clamp(v, min=eps))
        vr = state_of(i, "vr")
        if shared:                      # r and vc shared by the periods
            r = vr / torch.clamp(denom, min=eps)
            vc = s["vc"]
        else:
            d = vr.sum(-1, keepdim=True) / vr.shape[-1]
            r = _at((vr / torch.clamp(d, min=eps))[..., None], sl)
            vc = _at(state_of(i, "vc")[..., None, :], sl)
        return (g * torch.rsqrt(torch.clamp(r, min=eps))
                * torch.rsqrt(torch.clamp(vc, min=eps)))

    # pass 2: the RMS of the whole (stacked) update
    sq, numel = None, 0
    for i in range(n_per):
        for sl in slices(gr.leaves[i].shape, min_dim):
            u = u_of(i, sl)
            part = (u * u).sum()
            sq = part if sq is None else sq + part
            numel += u.numel()
            del u
    if sp.whole is not None:
        dist.all_reduce(sq, group=sp.whole)
        numel *= sp.whole_ranks
    rms = torch.sqrt(sq / numel + 1e-30)
    div = torch.clamp(rms / cfg.clip_threshold, min=1.0)
    lr_wd = float(f32(lr) * f32(cfg.weight_decay))
    # pass 3: the step, written in place
    for i in range(n_per):
        p = gr.leaves[i]
        for sl in slices(p.shape, min_dim):
            ps = _at(p, sl)
            step = (u_of(i, sl) / div).mul_(lr)
            if cfg.weight_decay:
                step.add_(lr_wd * ps.float())
            ps.copy_(ps.float() - step)


def update(grads, state: Dict, params, cfg: AdafactorConfig,
           lr_scale=1.0, split=None) -> Dict:
    """One Adafactor step: ``params`` and ``state["factored"]`` are
    updated in place; returns the new state. ``grads`` mirrors
    ``params`` (None leaves count as zero gradients). ``split``:
    ``path -> groups.Split | None`` over ranks (a group's path)."""
    count = state["count"] + 1
    f32 = np.float32
    beta2 = float(f32(1.0) - f32(count) ** f32(-cfg.decay))
    lr = float(f32(cfg.lr) * f32(lr_scale))
    gmap = {g.path: g.leaves for g in groups(grads)}
    for gr in groups(params):
        sp = split(gr.path) if split is not None else None
        _update_group(gr, gmap[gr.path], get(state["factored"], gr.path),
                      cfg, beta2, lr, sp or Split())
    return {"factored": state["factored"], "count": count}
