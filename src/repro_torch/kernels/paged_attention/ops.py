"""``[B, 1, H, D]``-layout entry points of the paged-decode kernels.

On CUDA tensors ``paged_decode_attention`` (GQA) and ``paged_mla_decode``
(MLA's absorbed latent attention) launch their hand-written kernels
(``csrc/paged_decode.cu``, ``csrc/paged_mla_decode.cu``) or raise; on CPU
tensors they take the plain versions (``ref.py``). Neither falls back
from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import (
    paged_decode_attention_ref, paged_mla_decode_ref)

NAME = "paged_decode_attention"
MLA_NAME = "paged_mla_decode"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = {}              # device index -> opt-in shared memory bytes
_SMS = {}                     # device index -> streaming multiprocessors


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


def _bind_mla(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/paged_mla_decode.cu`` once."""
    if lib.paged_mla_decode.argtypes is None:
        lib.paged_mla_decode.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.paged_mla_decode.restype = ctypes.c_int
        lib.paged_mla_decode_splits.argtypes = [ctypes.c_int] * 4
        lib.paged_mla_decode_splits.restype = ctypes.c_int
        lib.paged_mla_decode_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.paged_mla_decode_smem_bytes.restype = ctypes.c_size_t
        lib.paged_mla_decode_smem_limit.argtypes = [ctypes.c_int]
        lib.paged_mla_decode_smem_limit.restype = ctypes.c_size_t
    return lib


def paged_mla_decode(q_abs, q_rope, ckv_pool, kr_pool, page_table, lens, *,
                     scale: float):
    """q_abs ``[B, 1, H, R]`` (the latent-absorbed query); q_rope ``[B, 1,
    H, E]``; ckv_pool ``[P, ps, R]``; kr_pool ``[P, ps, E]``; page_table
    ``[B, NP]`` int32; lens ``[B]`` int32 — the slot's decode position:
    keys at ``t <= lens`` are visible, this step's token included (the
    GQA kernel is called with ``lens + 1`` and ``t < lens + 1``). Returns
    the latent context ``[B, 1, H, R]`` float32; the caller casts it to
    the compute dtype before ``w_uv``."""
    if q_abs.dim() != 4 or q_abs.shape[1] != 1:
        raise ValueError(f"paged MLA decode is single-query: q_abs must be "
                         f"[B, 1, H, R], got {tuple(q_abs.shape)}")
    b, _, h, r = q_abs.shape
    if q_rope.dim() != 4 or q_rope.shape[:3] != (b, 1, h):
        raise ValueError(f"q_rope must be [B, 1, H, E] beside q_abs "
                         f"{tuple(q_abs.shape)}, got {tuple(q_rope.shape)}")
    e = q_rope.shape[3]
    if ckv_pool.dim() != 3 or ckv_pool.shape[2] != r \
            or kr_pool.shape != ckv_pool.shape[:2] + (e,):
        raise ValueError(f"pools must be [P, ps, R] and [P, ps, E], got "
                         f"{tuple(ckv_pool.shape)}, {tuple(kr_pool.shape)}")
    ps = ckv_pool.shape[1]
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError("page_table must be [B, NP]")
    np_ = page_table.shape[1]
    qa, qr = q_abs[:, 0], q_rope[:, 0]
    if q_abs.device.type == "cpu":
        return paged_mla_decode_ref(qa, qr, ckv_pool, kr_pool, page_table,
                                    lens, scale=scale)[:, None]
    if q_abs.device.type != "cuda":
        raise ValueError(f"no paged MLA decode kernel for device "
                         f"{q_abs.device}")

    tensors = (qa, qr, ckv_pool, kr_pool, page_table, lens)
    if any(t.device != q_abs.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if qa.dtype not in _DTYPES or any(t.dtype != qa.dtype
                                      for t in tensors[1:4]):
        raise ValueError(f"kernel takes float32 or bfloat16 queries and "
                         f"pools of one dtype, got "
                         f"{[t.dtype for t in tensors[:4]]}")
    if page_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError("page_table and lens must be int32")
    if lens.shape != (b,):
        raise ValueError(f"lens must be [B]={b}, got {tuple(lens.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors[:4]):
        raise ValueError("queries and pools must be 16-byte aligned")
    lib = _bind_mla(build.load("paged_mla_decode"))
    dtype = _DTYPES[qa.dtype]
    smem = lib.paged_mla_decode_smem_bytes(h, r, e, dtype)
    if smem == 0:
        raise ValueError(f"the kernel does not take H={h}, R={r}, E={e} "
                         f"(limits in csrc/paged_mla_decode.cu)")
    dev = q_abs.device.index
    if dev not in _SMS:
        _SMEM_LIMIT[dev] = lib.paged_mla_decode_smem_limit(dev)
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    if smem > _SMEM_LIMIT[dev]:
        raise ValueError(f"paged MLA decode needs {smem} bytes of shared "
                         f"memory, above the card's {_SMEM_LIMIT[dev]}")
    splits = lib.paged_mla_decode_splits(b, ps, np_, _SMS[dev])
    out = torch.empty((b, h, r), dtype=torch.float32, device=q_abs.device)
    ws = (torch.empty(b * splits * h * (r + 2), dtype=torch.float32,
                      device=q_abs.device) if splits > 1 else None)
    err = lib.paged_mla_decode(
        qa.data_ptr(), qr.data_ptr(), ckv_pool.data_ptr(),
        kr_pool.data_ptr(), page_table.data_ptr(), lens.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        b, h, r, e, ps, np_, splits, scale, dtype,
        torch.cuda.current_stream(q_abs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged MLA decode kernel launch failed: "
                           f"cudaError {err}")
    build.LAUNCHES[MLA_NAME] += 1
    return out[:, None]
