"""Plain PyTorch version of the grouped expert FFN kernel: the function
of the JAX package's ``repro.kernels.grouped_ffn`` kernel. GEMM1 in
fp32, the activation in fp32, the hidden tile rounded to x's dtype, GEMM2
in fp32 and the result rounded to x's dtype. The CPU path uses it, and
the CUDA kernel is held against it on the card."""
from __future__ import annotations

import torch
import torch.nn.functional as F

ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def grouped_ffn_ref(x, w_up, w_gate, w_down, act: str = "silu", *,
                    round_hidden: bool = True):
    """x ``[E, C, M]``; w_up/w_gate ``[E, M, H]`` (w_gate may be None);
    w_down ``[E, H, M]`` -> ``[E, C, M]`` in x's dtype.

    ``round_hidden=False`` keeps the hidden activation in fp32, which is
    the JAX package's ``grouped_ffn_ref`` — the function its custom VJP
    differentiates."""
    xf = x.float()
    h = torch.bmm(xf, w_up.float())
    if w_gate is not None:
        h = ACTS[act](torch.bmm(xf, w_gate.float())) * h
    else:
        h = ACTS[act](h)
    if round_hidden:
        h = h.to(x.dtype).float()
    return torch.bmm(h, w_down.float()).to(x.dtype)


def tolerance(ref: torch.Tensor) -> float:
    """The largest max-abs difference the CUDA kernel may show against
    ``ref``, this module's output on the same inputs. fp32: the two sum
    in a different order, 1e-5. bf16: both take the products of the same
    bf16 values in fp32 and round the hidden tile and the output once;
    the output rounding may flip by one unit in the last place, at most
    2^-7 of the largest output, plus 1e-5 for the fp32 sums (a flipped
    hidden rounding moves the output by far less than one output unit)."""
    if ref.dtype == torch.float32:
        return 1e-5
    if ref.dtype != torch.bfloat16:
        raise ValueError(f"no tolerance for {ref.dtype}")
    return 2.0 ** -7 * ref.float().abs().max().item() + 1e-5
