"""Entry points of the top-k router kernel.

``route_plan(logits, k, capacity)`` launches the hand-written CUDA kernel
(``csrc/topk_router.cu``) once for everything an MoE chunk needs before
its dispatch: the top-k probabilities and indices, the dispatch plan
(``dest``, ``valid``) and, with ``stats=True``, the aux statistics and
losses. ``topk_router(logits, k)`` is the same launch with the plan and
the statistics off. On CUDA tensors both launch the kernel or raise; on
CPU tensors they take the plain versions (``ref.py``); they never fall
back from one to the other. ``build.LAUNCHES["topk_router"]`` counts one
per call of either.

The probabilities carry a gradient: the backward recomputes the softmax
in PyTorch and differentiates the gather at the kernel's indices, which
is the gradient ``lax.top_k`` gives in the JAX package. The plan and the
statistics carry none.

With more than one block the kernel takes an int32 workspace, one per
stream and shape: counters and flags the kernel's last block resets, so
the buffer is zeroed once, when it is made, and a launch never finds
another shape's histograms where its flags lie.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.topk_router.ref import route_plan_ref, topk_router_ref

NAME = "topk_router"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WORKSPACES = {}   # (t, e, k, stats, device, stream) -> int32 buffer or None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.route_plan.argtypes is None:
        lib.topk_router.argtypes = ([ctypes.c_void_p] * 3
                                    + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.route_plan.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
            + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.route_plan_workspace.argtypes = [ctypes.c_int] * 5
        for fn in (lib.topk_router, lib.route_plan, lib.route_plan_workspace,
                   lib.topk_router_max_experts, lib.topk_router_max_k):
            fn.restype = ctypes.c_int
        for fn in (lib.topk_router_max_experts, lib.topk_router_max_k):
            fn.argtypes = []
    return lib


def _workspace(lib, device: torch.device, t: int, e: int, k: int,
               stats: bool):
    """The current stream's zeroed workspace for this shape (None when the
    kernel runs as one block)."""
    key = (t, e, k, stats, device.index,
           torch.cuda.current_stream(device).cuda_stream)
    if key not in _WORKSPACES:
        words = lib.route_plan_workspace(t, e, k, int(stats), device.index)
        if words < 0:
            raise RuntimeError(f"route_plan_workspace failed on {device}")
        _WORKSPACES[key] = (torch.zeros(words, dtype=torch.int32,
                                        device=device) if words else None)
    return _WORKSPACES[key]


def _check(logits: torch.Tensor, k: int):
    if logits.dim() != 2:
        raise ValueError(f"logits must be [T, E], got {tuple(logits.shape)}")
    if not 1 <= k <= logits.shape[1]:
        raise ValueError(f"k={k} outside [1, E={logits.shape[1]}]")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no top-k router kernel for device "
                         f"{logits.device}")


def _launch(logits: torch.Tensor, k: int, capacity=None, stats=False,
            aux_loss_weight=1.0, z_loss_weight=1.0):
    """One launch. ``capacity`` None: probabilities and indices only."""
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
    dev = logits.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    probs = torch.empty((t, k), dtype=torch.float32, device=dev)
    idx = torch.empty((t, k), dtype=torch.int32, device=dev)
    if capacity is None:
        err = lib.topk_router(logits.data_ptr(), probs.data_ptr(),
                              idx.data_ptr(), t, e, k,
                              _DTYPES[logits.dtype], stream)
        out = (probs, idx)
    else:
        dest = torch.empty(t * k, dtype=torch.int32, device=dev)
        valid = torch.empty(t * k, dtype=torch.bool, device=dev)
        st = (torch.empty(2 * e + 3, dtype=torch.int32, device=dev)
              if stats else None)
        ws = _workspace(lib, dev, t, e, k, stats)
        err = lib.route_plan(
            logits.data_ptr(), probs.data_ptr(), idx.data_ptr(),
            dest.data_ptr(), valid.data_ptr(),
            None if st is None else st.data_ptr(),
            None if ws is None else ws.data_ptr(),
            t, e, k, capacity, aux_loss_weight, z_loss_weight,
            _DTYPES[logits.dtype], dev.index, stream)
        out = (probs, idx, dest, valid)
        if stats:
            f = st.view(torch.float32)
            out += ({"prob_sum": f[:e], "primary_count": st[e:2 * e],
                     "z_sq_sum": f[2 * e], "aux_loss": f[2 * e + 1],
                     "z_loss": f[2 * e + 2]},)
    if err != 0:
        raise RuntimeError(f"topk_router kernel launch failed: "
                           f"cudaError {err}")
    build.LAUNCHES[NAME] += 1
    return out


def _run(logits, k, capacity, stats, aux_loss_weight, z_loss_weight):
    _check(logits, k)
    if capacity is not None and capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if logits.device.type == "cpu":
        if capacity is None:
            return topk_router_ref(logits, k)
        return route_plan_ref(logits.detach(), k, capacity, stats=stats,
                              aux_loss_weight=aux_loss_weight,
                              z_loss_weight=z_loss_weight)
    return _launch(logits, k, capacity, stats, aux_loss_weight,
                   z_loss_weight)


class _Router(torch.autograd.Function):
    """Probabilities with the gradient of softmax -> gather (-> renorm);
    every other output is non-differentiable."""

    @staticmethod
    def forward(ctx, logits, k, capacity, stats, aux_loss_weight,
                z_loss_weight):
        out = _run(logits, k, capacity, stats, aux_loss_weight,
                   z_loss_weight)
        ctx.save_for_backward(logits, out[1])
        if stats:
            out = (*out[:4], *(out[4][key] for key in _STAT_KEYS))
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(ctx, g_probs, *_):
        logits, idx = ctx.saved_tensors
        with torch.enable_grad():
            x = logits.detach().requires_grad_(True)
            top = torch.softmax(x.float(), dim=-1).gather(-1, idx.long())
            if idx.shape[1] > 1:
                top = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9)
            (g,) = torch.autograd.grad(top, x, g_probs)
        return g, None, None, None, None, None


def topk_router(logits: torch.Tensor, k: int):
    """logits ``[T, E]`` (fp32 or bf16) -> (probs ``[T, k]`` fp32, idx
    ``[T, k]`` int32): softmax over E, top-k with ties to the lowest
    index, renormalised when k > 1."""
    if logits.requires_grad:
        return _Router.apply(logits, k, None, False, 1.0, 1.0)
    return _run(logits, k, None, False, 1.0, 1.0)


_STAT_KEYS = ("prob_sum", "primary_count", "z_sq_sum", "aux_loss", "z_loss")


def route_plan(logits: torch.Tensor, k: int, capacity: int, *,
               stats: bool = False, aux_loss_weight: float = 1.0,
               z_loss_weight: float = 1.0):
    """logits ``[T, E]`` (fp32 or bf16) -> (probs ``[T, k]`` fp32, idx
    ``[T, k]`` int32, dest ``[T*k]`` int32, valid ``[T*k]`` bool[,
    stats]) in one launch: ``topk_router``'s top-k, then the dispatch
    plan of ``moe.dispatch.dispatch_plan`` for ``capacity`` (route j of
    token t goes to ``e*C + r``, r its rank among the routes to expert e
    in flat order, or to ``E*C`` when ``r >= C``). With ``stats=True`` a
    dict: ``prob_sum`` ``[E]`` fp32, ``primary_count`` ``[E]`` int32,
    ``z_sq_sum``, and ``aux_loss`` and ``z_loss`` as ``moe.router.route``
    builds them with the two weights (0-d fp32 tensors)."""
    if logits.requires_grad:
        out = _Router.apply(logits, k, capacity, stats, aux_loss_weight,
                            z_loss_weight)
        return (*out[:4], dict(zip(_STAT_KEYS, out[4:]))) if stats else out
    return _run(logits, k, capacity, stats, aux_loss_weight, z_loss_weight)
