"""AdamW, with fp32 or 8-bit moments, as ``repro.optim.adamw``.

The update repeats the JAX package's arithmetic in the same order —
bias-corrected moments, then ``weight_decay * p`` added to the step
(decoupled decay), then ``p - lr * lr_scale * step`` — rather than
``torch.optim.AdamW``, which decays the parameter before the step and so
rounds differently. Scalars that JAX computes as float32 arrays (the
bias corrections, ``lr * lr_scale``) are computed as numpy float32 here.

Unlike the JAX package, which returns new trees, the update writes the
parameters and moments in place: the full-width model's fp32 weights and
moments are ~23 GB, and a second copy would not fit beside the
activations.

With ``quantize_moments`` (``get_optimizer("adamw8bit")``) each moment
of a leaf whose JAX rank is 2 or more is a ``Q8``: int8 values and one
fp32 scale a row of the last axis, ``scale = max(amax, 1e-12) / 127``,
rounded half to even as ``jnp.round`` does. The JAX rank of a period
leaf is its rank + 1 (JAX stacks periods on axis 0, ``optim.groups``),
so a period's 1-D norm scales and biases are quantised too, one row
each, while ``final_norm``'s stay fp32. The update dequantises, steps
and requantises a large leaf slice by slice along axis 0, so that no
temporary of the whole leaf is made; rows run along the last axis, so
each row's scale is the same as over the whole leaf.

Over ranks, ``update(split=)`` names each leaf's ``groups.Split``: a
ZeRO-3 expert shard holds part of every row, so its row maximum is
reduced (``all_reduce`` MAX) over the dp group before the scale is
taken, and the scale comes out the same on every rank of the group
while each keeps its own int8 columns. An expert leaf split only over
the EP group, on its leading axis, holds whole rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.optim.groups import paths, slices


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    quantize_moments: bool = False   # int8 moments + per-row scales


class Q8(NamedTuple):
    q: torch.Tensor        # int8 payload, the leaf's shape
    scale: torch.Tensor    # fp32, the leaf's shape with the last axis 1


def _zeros(p) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _q8_zeros(p) -> Q8:
    """``_quantize`` of zeros: q 0 and the scale of an all-zero row."""
    scale = torch.full(tuple(p.shape[:-1]) + (1,), 1e-12,
                       dtype=torch.float32, device=p.device) / 127.0
    return Q8(torch.zeros(p.shape, dtype=torch.int8, device=p.device), scale)


def _moments(t, cfg: AdamWConfig, stacked: bool = False, top: bool = True):
    """A moment tree shaped as ``t``: fp32 zeros, or ``Q8`` zeros for the
    leaves whose JAX rank is 2 or more (a leaf of the top-level
    ``periods`` list is stacked there)."""
    if isinstance(t, dict):
        return {k: _moments(v, cfg, stacked or (top and k == "periods"
                                                and isinstance(v, list)),
                            False)
                for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_moments(v, cfg, stacked, False) for v in t]
    if cfg.quantize_moments and t.dim() + stacked >= 2:
        return _q8_zeros(t)
    return _zeros(t)


def init(params, cfg: AdamWConfig) -> Dict:
    return {"m": _moments(params, cfg), "v": _moments(params, cfg),
            "count": 0}


def _dequantize(x: Q8, sl) -> torch.Tensor:
    return x.q[sl].float() * x.scale[sl]


def _quantize_into(x: torch.Tensor, out: Q8, sl, cols=None) -> None:
    """``out[sl] = _quantize(x)``; overwrites ``x``. ``cols``: the group
    the rows' other columns lie on."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    if cols is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=cols)
    scale = amax.clamp_min_(1e-12).div_(127.0)
    out.scale[sl].copy_(scale)
    out.q[sl].copy_(x.div_(scale).round_())


def _q8_step(g, m: Q8, v: Q8, p, cfg: AdamWConfig, b1c: float, b2c: float,
             lr: float, cols=None) -> None:
    """One step of a leaf with int8 moments, in slices along axis 0, in
    the JAX package's order of operations."""
    for sl in slices(p.shape, 2):
        ps = p[sl]
        gs = torch.zeros(ps.shape, dtype=torch.float32, device=p.device) \
            if g is None else g[sl].float()
        m_new = _dequantize(m, sl).mul_(cfg.b1).add_(gs * (1 - cfg.b1))
        v_new = _dequantize(v, sl).mul_(cfg.b2).add_(
            gs.mul(1 - cfg.b2).mul_(gs))
        del gs
        step = (m_new / b1c) / ((v_new / b2c).sqrt_() + cfg.eps)
        if cfg.weight_decay:
            step.add_(ps.float() * cfg.weight_decay)
        ps.copy_(ps.float() - step.mul_(lr))
        del step
        _quantize_into(m_new, m, sl, cols)
        _quantize_into(v_new, v, sl, cols)


@torch.no_grad()
def update(grads, state: Dict, params, cfg: AdamWConfig,
           lr_scale=1.0, split=None) -> Dict:
    """One AdamW step: ``params`` and the moments are updated in place;
    returns the new state. ``grads`` mirrors ``params`` (leaves may be
    None for a parameter that got no gradient: it is treated as zero).
    ``split``: ``path -> groups.Split | None`` over ranks."""
    count = state["count"] + 1
    f32 = np.float32
    b1c = f32(1) - f32(cfg.b1) ** f32(count)
    b2c = f32(1) - f32(cfg.b2) ** f32(count)
    lr = float(f32(cfg.lr) * f32(lr_scale))
    b1c, b2c = float(b1c), float(b2c)
    flat = lambda t: [x for _, x in paths(t)]  # noqa: E731 (Q8 a leaf)
    for g, m, v, (path, p) in zip(flat(grads), flat(state["m"]),
                                  flat(state["v"]), paths(params)):
        if isinstance(m, Q8):
            sp = split(path) if split is not None else None
            _q8_step(g, m, v, p, cfg, b1c, b2c, lr,
                     sp.cols if sp is not None else None)
            continue
        g = torch.zeros_like(m) if g is None else g.float()
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g * g * (1 - cfg.b2))
        step = (m / b1c) / ((v / b2c).sqrt_() + cfg.eps)
        if cfg.weight_decay:
            step.add_(p.float() * cfg.weight_decay)
        p.copy_(p.float() - step.mul_(lr))
    return {"m": state["m"], "v": state["v"], "count": count}
