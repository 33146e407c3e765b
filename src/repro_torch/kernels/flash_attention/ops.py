"""``[B, S, H, D]``-layout entry point of the flash-attention kernel.

``flash_attention(q, k, v, causal=, window=)`` launches the hand-written
CUDA kernel (``csrc/flash_attention.cu``) on CUDA tensors or raises, and
takes the plain version (``ref.py``) on CPU tensors; it never falls back
from one to the other. In bf16 the kernel keeps each warp's scores,
probabilities and running output in registers (``mma.sync`` tensor-core
products, head dims 16 to 192 in steps of 16, and 256: MLA's expanded
prefill runs 192, gemma3 256); fp32 runs on the CUDA cores, any multiple
of 16 whose tiles fit the device's shared memory.

The gradient: the forward saves q, k and v (not the output or the
scores); the backward recomputes attention through the plain version in
PyTorch and differentiates it. That recompute materialises the fp32
``[B, Kv, G, Sq, Sk]`` scores and probabilities for one layer at a time
(268 MB each at moe-gpt3-s's 8 x 1024 training batch), where the JAX
package differentiates its blockwise jnp attention with checkpointed
tiles; a backward kernel is later work (ROADMAP.md Queue 2).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

NAME = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = {}              # device index -> opt-in shared memory bytes


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.flash_attention.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
        lib.flash_attention_smem_limit.argtypes = [ctypes.c_int]
        lib.flash_attention_smem_limit.restype = ctypes.c_size_t
        lib.flash_attention_takes_d.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_takes_d.restype = ctypes.c_int
    return lib


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads rows of D with 16-byte copies: a unit last stride,
    the other strides and the base 16-byte aligned. A tensor that is not
    (a slice at an odd offset) is copied once to a contiguous one."""
    vec = 16 // t.element_size()
    if (t.stride(-1) == 1 and all(s % vec == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


def _launch(q, k, v, causal: bool, window: int):
    b, sq, hq, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must be on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d % 16:
        raise ValueError(f"the kernel takes head dims that are multiples "
                         f"of 16, got {d}")
    lib = _bind(build.load("flash_attention"))
    dtype = _DTYPES[q.dtype]
    if not lib.flash_attention_takes_d(d, dtype):
        raise ValueError(f"the {q.dtype} kernel takes head dims 16 to 192 "
                         f"in steps of 16, and 256; got {d}")
    smem = lib.flash_attention_smem_bytes(d, dtype)
    dev = q.device.index
    if dev not in _SMEM_LIMIT:
        _SMEM_LIMIT[dev] = lib.flash_attention_smem_limit(dev)
    if smem > _SMEM_LIMIT[dev]:
        raise ValueError(f"flash_attention needs {smem} bytes of shared "
                         f"memory at D={d}, above the card's "
                         f"{_SMEM_LIMIT[dev]}")
    q, k, v = (_kernel_ready(t) for t in (q, k, v))
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hq // kv, sq, sk, d, ctypes.addressof(strides), d ** -0.5,
        int(causal), window, dtype,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    build.LAUNCHES[NAME] += 1
    return out


def _forward(q, k, v, causal: bool, window: int):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be [B, Sq, Hq, D] and k, v [B, Sk, Kv, D]")
    if (k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]
            or q.shape[2] % k.shape[2]):
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    return _launch(q, k, v, causal, window)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = flash_attention_ref(*ins, causal=ctx.causal,
                                      window=ctx.window)
            grads = torch.autograd.grad(out, ins, g)
        return (*grads, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q ``[B, Sq, Hq, D]``; k/v ``[B, Sk, Kv, D]`` -> ``[B, Sq, Hq, D]``
    in q's dtype; GQA through ``h // (Hq // Kv)``, no repeat."""
    return _FlashAttention.apply(q, k, v, causal, window)
