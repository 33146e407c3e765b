"""RMSNorm / LayerNorm (pre-norm convention, fp32 statistics).

As in ``repro.models.layers.norm``: statistics in fp32 with eps 1e-6,
and the normalized value is cast to the compute dtype *before* the
scale (and bias) are applied.
"""
from __future__ import annotations

import torch

from repro_torch.models.module import Spec


def specs(d: int, kind: str):
    if kind == "rmsnorm":
        return {"scale": Spec((d,), ("embed",), "ones")}
    if kind == "layernorm":
        return {"scale": Spec((d,), ("embed",), "ones"),
                "bias": Spec((d,), ("embed",), "zeros")}
    raise ValueError(kind)


def apply(params, x: torch.Tensor, kind: str, eps: float = 1e-6):
    dtype = x.dtype
    x32 = x.float()
    if kind == "rmsnorm":
        var = x32.square().mean(dim=-1, keepdim=True)
        y = (x32 * (var + eps) ** -0.5).to(dtype)
        return y * params["scale"].to(dtype)
    if kind == "layernorm":
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        y = ((x32 - mean) * (var + eps) ** -0.5).to(dtype)
        return y * params["scale"].to(dtype) + params["bias"].to(dtype)
    raise ValueError(kind)
