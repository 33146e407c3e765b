"""``[B, 1, H, D]``-layout entry points of the paged-decode kernels.

On CUDA tensors ``paged_decode_attention`` (GQA) and ``paged_mla_decode``
(MLA's absorbed latent attention) launch their hand-written kernels
(``csrc/paged_decode.cu``, ``csrc/paged_mla_decode.cu``) or raise; on CPU
tensors they take the plain versions (``ref.py``). Neither falls back
from one to the other.

Both kernels split each slot's keys over several blocks
(``paged_decode_splits``, ``paged_mla_decode_splits``) and use a fixed
amount of shared memory per shape, whatever the context length. With
more than one split the wrapper allocates a float32 workspace for the
blocks' partial contexts and softmax statistics (GQA: B * Kv * splits *
G * (D + 2) floats; MLA: B * splits * H * (R + 2)); the GQA kernel also
takes a buffer of int32 counters kept per stream, which the kernel's
merge leaves at 0. ``build.LAUNCHES`` counts one per call, also where the
MLA kernel's merge takes a second CUDA launch.
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
_SPLITS = {}       # (kernel, shape, device) -> split count
_COUNTERS = {}     # (device, stream) -> zeroed int32 counters
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)   # the GQA kernel's variants


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/paged_decode.cu`` once."""
    if lib.paged_decode_attention.argtypes is None:
        lib.paged_decode_attention.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.paged_decode_attention.restype = ctypes.c_int
        lib.paged_decode_splits.argtypes = [ctypes.c_int] * 9
        lib.paged_decode_splits.restype = ctypes.c_int
        lib.paged_decode_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.paged_decode_smem_bytes.restype = ctypes.c_int
    return lib


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters at 0 for the GQA kernel's merge of
    its splits on the current stream. A kernel's last block resets each counter
    it used, so the buffer stays zero between launches and is made once
    per stream (larger when a launch needs more)."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 256), dtype=torch.int32,
                                           device=device)
    return buf


def paged_decode_splits(q, k_pool, page_table, *, window: int = 0) -> int:
    """The split count the GQA kernel takes for these inputs (CUDA
    tensors): each slot's keys in whole pages over ``splits`` blocks per
    KV head. 0 when the kernel does not take the shape."""
    b, _, hq, d = q.shape
    _, ps, kv, _ = k_pool.shape
    np_ = page_table.shape[1]
    dev = q.device.index
    key = (NAME, b, kv, hq // kv, d, ps, np_, window, q.dtype, dev)
    if key not in _SPLITS:
        lib = _bind(build.load("paged_decode"))
        _SPLITS[key] = lib.paged_decode_splits(b, kv, hq // kv, d, ps, np_,
                                               window, _DTYPES[q.dtype], dev)
    return _SPLITS[key]


def _refusal(lib, q, g: int, d: int) -> str:
    """Why ``paged_decode_splits`` found no launch: no variant takes (G,
    D), or the variant's shared memory is above the device's opt-in
    limit (its opt-in fails), or the device query failed."""
    smem = lib.paged_decode_smem_bytes(g, d, _DTYPES[q.dtype])
    if smem < 0:
        return (f"the kernel does not take {g} query heads per KV head with "
                f"head_dim {d} (G <= 8; D one of "
                f"{', '.join(map(str, HEAD_DIMS))}: csrc/paged_decode.cu)")
    props = torch.cuda.get_device_properties(q.device)
    limit = props.shared_memory_per_block_optin
    return (f"paged decode at G={g}, D={d}, {q.dtype} found no launch on "
            f"{q.device}: the variant takes {smem} bytes of shared memory a "
            f"block against the device's opt-in limit of {limit}, or the "
            f"device query failed")


def paged_decode_attention(q, k_pool, v_pool, page_table, lens, *,
                           window: int = 0):
    """q ``[B, 1, Hq, D]``; pools ``[P, ps, Kv, D]``; page_table ``[B,
    NP]`` int32; lens ``[B]`` int32 — valid cache entries per slot
    including the token scattered this step (each >= 1; page ids in
    ``[0, P)``). Returns ``[B, 1, Hq, D]`` in q's dtype. On the card:
    Hq / Kv <= 8 and D one of ``HEAD_DIMS`` (16, 32, 64, 80, 96, 128,
    256), any context length, the variant's shared memory within the
    device's opt-in limit; workspace and counters as the module says."""
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
    splits = paged_decode_splits(q, k_pool, page_table, window=window)
    lib = _bind(build.load("paged_decode"))
    if splits == 0:
        raise ValueError(_refusal(lib, q, g, d))
    out = torch.empty((b, kv, g, d), dtype=q.dtype, device=q.device)
    ws = cnt = None
    if splits > 1:
        ws = torch.empty(b * kv * splits * g * (d + 2), dtype=torch.float32,
                         device=q.device)
        cnt = _counters(q.device, b * kv)
    err = lib.paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if cnt is None else cnt.data_ptr(),
        b, kv, g, d, ps, np_, window, splits, d ** -0.5, _DTYPES[q.dtype],
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
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
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.paged_mla_decode.restype = ctypes.c_int
        lib.paged_mla_decode_splits.argtypes = [ctypes.c_int] * 8
        lib.paged_mla_decode_splits.restype = ctypes.c_int
    return lib


def paged_mla_decode_splits(q_abs, q_rope, ckv_pool, page_table) -> int:
    """The split count the MLA kernel takes for these inputs (CUDA
    tensors): each slot's table in whole 32-token tiles over ``splits``
    blocks. 0 when the kernel does not take the shape."""
    b, _, h, r = q_abs.shape
    e = q_rope.shape[3]
    ps, np_ = ckv_pool.shape[1], page_table.shape[1]
    dev = q_abs.device.index
    key = (MLA_NAME, b, h, r, e, ps, np_, q_abs.dtype, dev)
    if key not in _SPLITS:
        lib = _bind_mla(build.load("paged_mla_decode"))
        _SPLITS[key] = lib.paged_mla_decode_splits(
            b, h, r, e, ps, np_, _DTYPES[q_abs.dtype], dev)
    return _SPLITS[key]


def paged_mla_decode(q_abs, q_rope, ckv_pool, kr_pool, page_table, lens, *,
                     scale: float):
    """q_abs ``[B, 1, H, R]`` (the latent-absorbed query); q_rope ``[B, 1,
    H, E]``; ckv_pool ``[P, ps, R]``; kr_pool ``[P, ps, E]``; page_table
    ``[B, NP]`` int32; lens ``[B]`` int32 — the slot's decode position:
    keys at ``t <= lens`` are visible, this step's token included (the
    GQA kernel is called with ``lens + 1`` and ``t < lens + 1``). Returns
    the latent context ``[B, 1, H, R]`` float32; the caller casts it to
    the compute dtype before ``w_uv``. On the card: H <= 16, R a multiple
    of 16 up to 512, E a multiple of 8 up to 128, any context length;
    workspace as the module says."""
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
    splits = paged_mla_decode_splits(q_abs, q_rope, ckv_pool, page_table)
    if splits == 0:
        raise ValueError(f"the kernel does not take H={h}, R={r}, E={e} "
                         f"(H <= 16; R a multiple of 16 up to 512; E a "
                         f"multiple of 8 up to 128: "
                         f"csrc/paged_mla_decode.cu)")
    lib = _bind_mla(build.load("paged_mla_decode"))
    out = torch.empty((b, h, r), dtype=torch.float32, device=q_abs.device)
    ws = (torch.empty(b * splits * h * (r + 2), dtype=torch.float32,
                      device=q_abs.device) if splits > 1 else None)
    err = lib.paged_mla_decode(
        qa.data_ptr(), qr.data_ptr(), ckv_pool.data_ptr(),
        kr_pool.data_ptr(), page_table.data_ptr(), lens.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        b, h, r, e, ps, np_, splits, scale, _DTYPES[qa.dtype],
        q_abs.device.index,
        torch.cuda.current_stream(q_abs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged MLA decode kernel launch failed: "
                           f"cudaError {err}")
    build.LAUNCHES[MLA_NAME] += 1
    return out[:, None]
