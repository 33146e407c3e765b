"""The attention kernels' variants for the GQA decoders' head dims, on the
card: paged decode at D 80 (h2o-danube-1.8b) and D 256 (gemma3-12b) for
G 1, 2, 4 and 8, with and without a window, and flash attention at D 80
and D 256, causal and windowed, with GQA, each held against its plain
version (fp32 within 1e-5, bf16 within ``ref.tolerance``); and the
wrappers' errors for D 80 / D 256 shapes no variant covers. This file
imports neither ``jax`` nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_gqa_cuda.py

Elsewhere it skips: a CUDA kernel has no CPU mode.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from test_torch_paged_attention_cuda import _setup


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _long_setup(rng, b, kv, g, d, ps, np_, lens):
    """Pools of ``b`` slots, each owning its own ``np_`` pages after the
    garbage sink page 0, and q: contexts long enough to split."""
    pools = []
    for _ in range(2):
        pool = rng.standard_normal((1 + b * np_, ps, kv, d))
        pool[0] = 3.0e4
        pools.append(pool.astype(np.float32))
    pt = (1 + np.arange(b * np_, dtype=np.int32)).reshape(b, np_)
    q = rng.standard_normal((b, 1, kv * g, d)).astype(np.float32)
    return q, pools[0], pools[1], pt, np.asarray(lens, np.int32)


def _paged_check(arrs, dtype, window):
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_decode_attention_ref)
    from repro_torch.kernels.paged_attention.ref import tolerance
    q, kp, vp, pt, lens = (torch.from_numpy(a).cuda() for a in arrs)
    dt = getattr(torch, dtype)
    q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
    b, _, hq, d = q.shape
    kv = kp.shape[2]
    build.reset_launches()
    out = paged_decode_attention(q, kp, vp, pt, lens, window=window)
    ref = paged_decode_attention_ref(q.reshape(b, kv, hq // kv, d), kp, vp,
                                     pt, lens, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["paged_decode_attention"] == 1
    assert out.dtype == dt and out.shape == q.shape
    err = (out.float().reshape(ref.shape) - ref.float()).abs().max().item()
    assert err <= tolerance(ref), (err, tolerance(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [80, 256])
def test_paged_decode_new_head_dims(d, group, window, dtype):
    """Ragged lens from 1 token to the whole table, sink-filled
    unallocated entries, a slot grown ahead."""
    _cuda()
    rng = np.random.default_rng(d + group + window)
    arrs = _setup(rng, [1, 20, 7, 13], [0, 0, 1, 0], kv_heads=2,
                  group=group, d=d)
    _paged_check(arrs, dtype, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,group,window", [(80, 4, 4096), (80, 4, 0),
                                            (256, 2, 1024), (256, 2, 0),
                                            (256, 8, 0)])
def test_paged_decode_new_head_dims_split(d, group, window, dtype):
    """Contexts of up to 8,192 tokens in 16-token pages: the keys split
    over blocks and merged in the launch; the engine's windows."""
    _cuda()
    rng = np.random.default_rng(d + group)
    arrs = _long_setup(rng, 4, 2, group, d, 16, 512,
                       [8192, 5000, 1025, 4097])
    _paged_check(arrs, dtype, window)


FLASH = [  # b, sq, hq, kv, d, window
    (2, 200, 8, 2, 80, 0),        # danube: G 4
    (1, 300, 8, 2, 80, 64),
    (2, 200, 4, 2, 256, 0),       # gemma3: G 2
    (1, 300, 4, 2, 256, 64),
    (1, 1024, 4, 2, 256, 0),      # a whole prefill chunk's worth of tiles
    (1, 33, 2, 1, 256, 0),        # a ragged tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,hq,kv,d,window", FLASH)
def test_flash_new_head_dims(b, sq, hq, kv, d, window, dtype):
    _cuda()
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ref import tolerance
    gen = torch.Generator(device="cuda").manual_seed(sq + d + window)
    q, k, v = (torch.randn((b, sq, h, d), generator=gen,
                           device="cuda").to(dtype) for h in (hq, kv, kv))
    build.reset_launches()
    out = flash_attention(q, k, v, causal=True, window=window)
    ref = flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == 1
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs()
    tol = tolerance(q, k, v, ref, causal=True, window=window)
    assert (err <= tol).all(), (err / tol).max().item()


@pytest.mark.cuda
def test_wrappers_refuse_uncovered_shapes():
    """G 16 has no paged decode variant at D 80 or D 256, and bf16 flash
    attention has none between D 192 and D 256 or above it."""
    _cuda()
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    for d in (80, 256):
        q, kp, vp, pt, lens = (torch.from_numpy(a).cuda() for a in _setup(
            np.random.default_rng(0), [5, 9], [0, 0], kv_heads=1, group=16,
            d=d))
        with pytest.raises(ValueError, match="does not take 16 query heads"):
            paged_decode_attention(q, kp, vp, pt, lens)
    for d in (240, 272):
        q = torch.zeros((1, 16, 2, d), dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="192 in steps of 16, and 256"):
            flash_attention(q, q, q)
