"""``[B, 1, Hq, D]``-layout entry point of the paged-decode kernel.

On CUDA tensors ``paged_decode_attention`` launches the hand-written
kernel (``csrc/paged_decode.cu``) or raises; on CPU tensors it takes the
plain version (``ref.py``). It never falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import \
    paged_decode_attention_ref

NAME = "paged_decode_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = {}              # device index -> opt-in shared memory bytes


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/paged_decode.cu`` once."""
    if lib.paged_decode_attention.argtypes is None:
        lib.paged_decode_attention.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.paged_decode_attention.restype = ctypes.c_int
        lib.paged_decode_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.paged_decode_smem_bytes.restype = ctypes.c_size_t
        lib.paged_decode_smem_limit.argtypes = [ctypes.c_int]
        lib.paged_decode_smem_limit.restype = ctypes.c_size_t
    return lib


def paged_decode_attention(q, k_pool, v_pool, page_table, lens, *,
                           window: int = 0):
    """q ``[B, 1, Hq, D]``; pools ``[P, ps, Kv, D]``; page_table ``[B,
    NP]`` int32; lens ``[B]`` int32 — valid cache entries per slot
    including the token scattered this step (each >= 1; page ids in
    ``[0, P)``). Returns ``[B, 1, Hq, D]`` in q's dtype."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged decode is single-query: q must be "
                         f"[B, 1, Hq, D], got {tuple(q.shape)}")
    b, _, hq, d = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("pools must both be [P, ps, Kv, D]")
    _, ps, kv, dk = k_pool.shape
    if dk != d or hq % kv:
        raise ValueError(f"q heads {hq} / dim {d} do not fit pools "
                         f"{tuple(k_pool.shape)}")
    g = hq // kv
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError("page_table must be [B, NP]")
    np_ = page_table.shape[1]
    if q.device.type == "cpu":
        out = paged_decode_attention_ref(q.reshape(b, kv, g, d), k_pool,
                                         v_pool, page_table, lens,
                                         window=window)
        return out.reshape(b, 1, hq, d)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")

    tensors = (q, k_pool, v_pool, page_table, lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 q and pools "
                         f"of one dtype, got {q.dtype}, {k_pool.dtype}, "
                         f"{v_pool.dtype}")
    if page_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError("page_table and lens must be int32")
    if lens.shape != (b,):
        raise ValueError(f"lens must be [B]={b}, got {tuple(lens.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned")
    lib = _bind(build.load("paged_decode"))
    dtype = _DTYPES[q.dtype]
    smem = lib.paged_decode_smem_bytes(g, d, ps, np_, window, dtype)
    if smem == 0:
        raise ValueError(f"the kernel does not take {g} query heads per KV "
                         f"head with head_dim {d} in {q.dtype} (limits: "
                         f"kMaxG, kMaxChunks in csrc/paged_decode.cu)")
    dev = q.device.index                # a CUDA tensor's device has one
    if dev not in _SMEM_LIMIT:
        _SMEM_LIMIT[dev] = lib.paged_decode_smem_limit(dev)
    limit = _SMEM_LIMIT[dev]
    if smem > limit:
        raise ValueError(f"paged decode needs {smem} bytes of shared "
                         f"memory, above the card's {limit}-byte limit")

    out = torch.empty((b, kv, g, d), dtype=q.dtype, device=q.device)
    err = lib.paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, kv, g, d, ps, np_, window, d ** -0.5, dtype,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged decode kernel launch failed: "
                           f"cudaError {err}")
    build.LAUNCHES[NAME] += 1
    return out.reshape(b, 1, hq, d)
