"""Dense feed-forward layers (gated SwiGLU-style or plain MLP), as in
``repro.models.layers.ffn``. GELU is the tanh approximation."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.module import Spec

ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def specs(d_model: int, d_ff: int, gated: bool):
    s = {
        "w_up": Spec((d_model, d_ff), ("embed", "mlp")),
        "w_down": Spec((d_ff, d_model), ("mlp_c", "embed_out")),
    }
    if gated:
        s["w_gate"] = Spec((d_model, d_ff), ("embed", "mlp"))
    return s


def apply(params, x: torch.Tensor, *, act: str = "silu",
          gated: bool = True):
    dt = x.dtype
    h = x @ params["w_up"].to(dt)
    if gated:
        h = ACTS[act](x @ params["w_gate"].to(dt)) * h
    else:
        h = ACTS[act](h)
    return h @ params["w_down"].to(dt)
