"""Entry point of the top-k router kernel.

``topk_router(logits, k)`` launches the hand-written CUDA kernel
(``csrc/topk_router.cu``) on CUDA tensors or raises, and takes the plain
version (``ref.py``) on CPU tensors; it never falls back from one to the
other. Its probabilities carry a gradient: the backward recomputes the
softmax in PyTorch and differentiates the gather at the kernel's
indices, which is the gradient ``lax.top_k`` gives in the JAX package.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.topk_router.ref import topk_router_ref

NAME = "topk_router"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.topk_router.argtypes is None:
        lib.topk_router.argtypes = ([ctypes.c_void_p] * 3
                                    + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.topk_router.restype = ctypes.c_int
        for fn in (lib.topk_router_max_experts, lib.topk_router_max_k):
            fn.argtypes = []
            fn.restype = ctypes.c_int
    return lib


def _launch(logits: torch.Tensor, k: int):
    t, e = logits.shape
    if logits.dtype not in _DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16 logits, got "
                         f"{logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    lib = _bind(build.load("topk_router"))
    if e > lib.topk_router_max_experts() or k > lib.topk_router_max_k():
        raise ValueError(
            f"the kernel takes E <= {lib.topk_router_max_experts()} and "
            f"k <= {lib.topk_router_max_k()}, got E={e}, k={k}")
    probs = torch.empty((t, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((t, k), dtype=torch.int32, device=logits.device)
    err = lib.topk_router(
        logits.data_ptr(), probs.data_ptr(), idx.data_ptr(), t, e, k,
        _DTYPES[logits.dtype],
        torch.cuda.current_stream(logits.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk_router kernel launch failed: "
                           f"cudaError {err}")
    build.LAUNCHES[NAME] += 1
    return probs, idx


def _forward(logits: torch.Tensor, k: int):
    if logits.dim() != 2:
        raise ValueError(f"logits must be [T, E], got {tuple(logits.shape)}")
    if not 1 <= k <= logits.shape[1]:
        raise ValueError(f"k={k} outside [1, E={logits.shape[1]}]")
    if logits.device.type == "cpu":
        return topk_router_ref(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"no top-k router kernel for device "
                         f"{logits.device}")
    return _launch(logits, k)


class _TopkRouter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, k):
        probs, idx = _forward(logits, k)
        ctx.save_for_backward(logits, idx)
        ctx.mark_non_differentiable(idx)
        return probs, idx

    @staticmethod
    def backward(ctx, g_probs, _g_idx):
        logits, idx = ctx.saved_tensors
        with torch.enable_grad():
            x = logits.detach().requires_grad_(True)
            top = torch.softmax(x.float(), dim=-1).gather(-1, idx.long())
            if idx.shape[1] > 1:
                top = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9)
            (g,) = torch.autograd.grad(top, x, g_probs)
        return g, None


def topk_router(logits: torch.Tensor, k: int):
    """logits ``[T, E]`` (fp32 or bf16) -> (probs ``[T, k]`` fp32, idx
    ``[T, k]`` int32): softmax over E, top-k with ties to the lowest
    index, renormalised when k > 1."""
    return _TopkRouter.apply(logits, k)
