"""Entry point of the grouped expert FFN kernel.

``grouped_ffn(x, w_up, w_gate, w_down, act)`` launches the hand-written
CUDA kernel (``csrc/grouped_ffn.cu``) on CUDA tensors or raises, and
takes the plain version (``ref.py``) on CPU tensors; it never falls back
from one to the other.

In bf16 the kernel runs in two phases: h = act(x w_up) (gated:
act(x w_gate) * (x w_up)) into a transient ``[E, C, H]`` T_M buffer in
x's dtype, then out = h w_down. The wrapper allocates that buffer (with
the per-expert flags) as one ``torch.empty`` workspace, and it is freed
when the call returns: 3 MB at moe-gpt3-s's decode capacity against 604
MB of weights. fp32 keeps T_M on chip.

In bf16 an expert whose rows of x are all zero (an expert no token was
dispatched to) reads none of its weights, and its output rows are
written as exactly 0, which is what the plain version gives (fp32
computes them, as products of zeros). That rests on every activation in
``_ACT_IDS`` mapping 0 to 0; the wrapper raises for one that does not.

The gradient is the JAX package's custom VJP (``ops.py:43-60`` there):
the forward saves x and the weights, never T_M; the backward rebuilds
T_M from x with PyTorch products in fp32 and differentiates them. The
JAX package has no backward kernel either: it leaves those products to
XLA, as the port leaves them to PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped_ffn.ref import ACTS, grouped_ffn_ref

NAME = "grouped_ffn"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_IDS = {"silu": 0, "gelu": 1, "relu": 2}
# the activations whose act(0) is 0: the kernel's zero-expert skip is exact
# only for these
_ZERO_TO_ZERO = {a for a in _ACT_IDS
                 if float(ACTS[a](torch.zeros(()))) == 0.0}
_SMEM_LIMIT = {}              # device index -> opt-in shared memory bytes


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.grouped_ffn.argtypes is None:
        lib.grouped_ffn.argtypes = ([ctypes.c_void_p] * 6
                                    + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.grouped_ffn.restype = ctypes.c_int
        lib.grouped_ffn_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.grouped_ffn_smem_bytes.restype = ctypes.c_size_t
        lib.grouped_ffn_smem_limit.argtypes = [ctypes.c_int]
        lib.grouped_ffn_smem_limit.restype = ctypes.c_size_t
        lib.grouped_ffn_max_m.argtypes = []
        lib.grouped_ffn_max_m.restype = ctypes.c_int
        lib.grouped_ffn_workspace_bytes.argtypes = [ctypes.c_int] * 4
        lib.grouped_ffn_workspace_bytes.restype = ctypes.c_size_t
    return lib


def _launch(x, w_up, w_gate, w_down, act: str):
    e, c, m = x.shape
    h = w_up.shape[-1]
    tensors = [t for t in (x, w_up, w_gate, w_down) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise ValueError(f"kernel takes float32 or bfloat16 inputs of one "
                         f"dtype, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("kernel inputs must be 16-byte aligned")
    if act not in _ZERO_TO_ZERO:
        raise ValueError(f"activation {act!r} does not map 0 to 0: the "
                         f"kernel's zero-expert skip would be wrong")
    lib = _bind(build.load("grouped_ffn"))
    if m % 16 or h % 16 or m > lib.grouped_ffn_max_m():
        raise ValueError(f"the kernel takes M and H multiples of 16 and M "
                         f"<= {lib.grouped_ffn_max_m()}, got M={m}, H={h}")
    dtype = _DTYPES[x.dtype]
    smem = lib.grouped_ffn_smem_bytes(c, m, h, int(w_gate is not None),
                                      dtype)
    dev = x.device.index
    if dev not in _SMEM_LIMIT:
        _SMEM_LIMIT[dev] = lib.grouped_ffn_smem_limit(dev)
    if smem > _SMEM_LIMIT[dev]:
        raise ValueError(f"grouped_ffn needs {smem} bytes of shared memory "
                         f"at C={c}, M={m}, above the card's "
                         f"{_SMEM_LIMIT[dev]}")
    out = torch.empty_like(x)
    work = torch.empty(lib.grouped_ffn_workspace_bytes(e, c, h, dtype),
                       dtype=torch.uint8, device=x.device)
    err = lib.grouped_ffn(
        x.data_ptr(), w_up.data_ptr(),
        None if w_gate is None else w_gate.data_ptr(), w_down.data_ptr(),
        out.data_ptr(), work.data_ptr(), e, c, m, h, _ACT_IDS[act], dtype,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_ffn kernel launch failed: "
                           f"cudaError {err}")
    build.LAUNCHES[NAME] += 1
    return out


def _forward(x, w_up, w_gate, w_down, act: str):
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.dim() != 3 or w_up.shape != (x.shape[0], x.shape[2],
                                      w_up.shape[-1]):
        raise ValueError(f"x [E, C, M] and w_up [E, M, H] do not fit: "
                         f"{tuple(x.shape)}, {tuple(w_up.shape)}")
    e, _, m = x.shape
    h = w_up.shape[-1]
    if w_down.shape != (e, h, m) or (w_gate is not None
                                     and w_gate.shape != w_up.shape):
        raise ValueError("w_down must be [E, H, M] and w_gate as w_up")
    if x.device.type == "cpu":
        return grouped_ffn_ref(x, w_up, w_gate, w_down, act)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped_ffn kernel for device {x.device}")
    return _launch(x, w_up, w_gate, w_down, act)


class _GroupedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_up, w_gate, w_down, act):
        ctx.act = act
        ctx.gated = w_gate is not None
        ctx.save_for_backward(x, w_up, w_gate, w_down)
        return _forward(x, w_up, w_gate, w_down, act)

    @staticmethod
    def backward(ctx, g):
        x, w_up, w_gate, w_down = ctx.saved_tensors
        ins = [t.detach().requires_grad_(True)
               for t in (x, w_up, w_gate, w_down) if t is not None]
        with torch.enable_grad():
            wg = ins[2] if ctx.gated else None
            out = grouped_ffn_ref(ins[0], ins[1], wg, ins[-1], ctx.act,
                                  round_hidden=False)
            grads = torch.autograd.grad(out, ins, g)
        if ctx.gated:
            return (*grads, None)
        return grads[0], grads[1], None, grads[2], None


def grouped_ffn(x, w_up, w_gate, w_down, act: str = "silu"):
    """x ``[E, C, M]``; w_up/w_gate ``[E, M, H]`` (w_gate None when not
    gated); w_down ``[E, H, M]`` -> ``[E, C, M]`` in x's dtype."""
    return _GroupedFFN.apply(x, w_up, w_gate, w_down, act)
