"""The CUDA paged-decode kernel against its plain version, on the card.

The pools, page table and q are laid out as the serving allocator lays
them out (``_setup``, shared with ``test_torch_paged_attention.py``). The
kernel is held within ``ref.tolerance``: 1e-5 in fp32, one bf16 rounding
of the largest output in bf16. This file imports neither ``jax`` nor the
JAX package, so on a machine with an H100 and ``nvcc`` it runs without
them (``--noconftest`` skips the suite's JAX set-up):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_paged_attention_cuda.py \\
        tests/test_torch_engine_cuda.py

Elsewhere it skips: the kernel has no CPU mode.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 paged_decode_attention_ref)
from repro_torch.kernels.paged_attention.ref import tolerance

PS = 4           # page size
NP = 5           # page-table width (pages per slot)
GARBAGE = 3.0e4  # sink-page fill; finite but loud if it ever leaks


def _setup(rng, lens, extra_pages, *, kv_heads=2, group=3, d=8):
    """Pools, page table and q as the serving allocator lays them out:
    page 0 is the garbage-filled sink, each slot owns ``pages_for(len) +
    extra`` distinct pages, unallocated entries point at the sink."""
    b = len(lens)
    num_pages = 1 + sum(-(-l // PS) + e for l, e in zip(lens, extra_pages))
    pools = []
    for _ in range(2):
        pool = rng.standard_normal((num_pages, PS, kv_heads, d))
        pool[0] = GARBAGE
        pools.append(pool.astype(np.float32))
    pt = np.zeros((b, NP), np.int32)
    nxt = 1
    for i, (l, e) in enumerate(zip(lens, extra_pages)):
        n = -(-l // PS) + e
        pt[i, :n] = np.arange(nxt, nxt + n)
        nxt += n
    q = rng.standard_normal((b, 1, kv_heads * group, d)).astype(np.float32)
    return q, pools[0], pools[1], pt, np.asarray(lens, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 6])
def test_cuda_kernel_matches_plain(dtype, window):
    """On the card: the CUDA kernel against its plain version, launch
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    q, kp, vp, pt, lens = _setup(rng, [1, NP * PS, 7, 13], [1, 0, 2, 0],
                                 kv_heads=2, group=4, d=96)
    tdt = getattr(torch, dtype)
    q_, kp_, vp_ = (torch.from_numpy(a).to("cuda", tdt) for a in (q, kp, vp))
    pt_, lens_ = torch.from_numpy(pt).cuda(), torch.from_numpy(lens).cuda()
    build.reset_launches()
    out = paged_decode_attention(q_, kp_, vp_, pt_, lens_, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["paged_decode_attention"] == 1
    b, _, hq, d = q.shape
    plain = paged_decode_attention_ref(
        q_.reshape(b, 2, hq // 2, d), kp_, vp_, pt_, lens_,
        window=window).reshape(b, 1, hq, d)
    torch.testing.assert_close(out.float(), plain.float(), rtol=0,
                               atol=tolerance(plain))


def _pools(rng, lens, extra, *, kv, g, d, ps, np_, fill=GARBAGE):
    """numpy (q [B, 1, Kv*G, D], k_pool, v_pool [P, ps, Kv, D], page_table
    [B, NP], lens [B]) as the serving allocator lays them out, with page 0
    (the sink), each slot's grown-ahead pages and the positions past its
    length in its last page set to ``fill``."""
    owned = [-(-n // ps) + e for n, e in zip(lens, extra)]
    assert all(o <= np_ for o in owned)
    pages = 1 + sum(owned)
    pools = [rng.standard_normal((pages, ps, kv, d)).astype(np.float32)
             for _ in range(2)]
    pt = np.zeros((len(lens), np_), np.int32)
    nxt = 1
    for i, (n, o) in enumerate(zip(lens, owned)):
        pt[i, :o] = np.arange(nxt, nxt + o)
        used = -(-n // ps)
        for pool in pools:
            pool[nxt + used:nxt + o] = fill
            if used and n % ps:
                pool[nxt + used - 1, n % ps:] = fill
        nxt += o
    for pool in pools:
        pool[0] = fill
    q = rng.standard_normal((len(lens), 1, kv * g, d)).astype(np.float32)
    return q, pools[0], pools[1], pt, np.asarray(lens, np.int32)


def _check(arrs, dtype, window, *, clean=None):
    """Kernel against the plain version within ``tolerance``, one counted
    launch; ``clean`` (the same inputs without NaNs) feeds the plain
    version where the pools hold NaN outside the visible range."""
    q, kp, vp, pt, lens = arrs
    b, _, hq, d = q.shape
    kv = kp.shape[2]
    tdt = getattr(torch, dtype)
    dev = [torch.from_numpy(a).to("cuda", tdt) for a in (q, kp, vp)]
    pt_, lens_ = torch.from_numpy(pt).cuda(), torch.from_numpy(lens).cuda()
    build.reset_launches()
    out = paged_decode_attention(*dev, pt_, lens_, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["paged_decode_attention"] == 1
    ref_in = dev if clean is None else [
        torch.from_numpy(a).to("cuda", tdt) for a in clean[:3]]
    plain = paged_decode_attention_ref(
        ref_in[0].reshape(b, kv, hq // kv, d), ref_in[1], ref_in[2], pt_,
        lens_, window=window).reshape(b, 1, hq, d)
    assert out.shape == q.shape and out.dtype == tdt
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), plain.float(), rtol=0,
                               atol=tolerance(plain))
    return dev


def _tokens_per_split(q, kp, pt, window):
    from repro_torch.kernels.paged_attention.ops import paged_decode_splits
    splits = paged_decode_splits(q, kp, pt, window=window)
    ps, np_ = kp.shape[1], pt.shape[1]
    span = min(window, np_ * ps) if window > 0 else np_ * ps
    return splits, -(-(-(-span // ps)) // splits) * ps


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,d", [(1, 64), (1, 96), (1, 128), (4, 64),
                                 (4, 96), (4, 128), (8, 64), (8, 96),
                                 (8, 128), (2, 16), (3, 32)])
def test_cuda_group_and_head_dim(dtype, g, d):
    """G 1/4/8 at D 64/96/128 (and the reduced configs' G 2, D 16; a G
    that is no power of two): ragged lens from 1 token to the full table,
    grown-ahead pages."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(g * 1000 + d)
    _check(_pools(rng, [1, 512, 37, 200, 16, 17], [2, 0, 1, 0, 1, 3],
                  kv=2, g=g, d=d, ps=16, np_=32), dtype, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 100])
def test_cuda_split_and_page_edges(dtype, window):
    """lens of 1, on a page edge and one either side, on a split edge and
    one either side, and the full table; windows that cross a split edge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    ps, np_, kv, g, d = 16, 64, 2, 4, 128
    probe = _pools(np.random.default_rng(0), [1], [0], kv=kv, g=g, d=d,
                   ps=ps, np_=np_)
    tdt = getattr(torch, dtype)
    q0 = torch.zeros((8, 1, kv * g, d), dtype=tdt, device="cuda")
    k0 = torch.from_numpy(probe[1]).to("cuda", tdt)
    pt0 = torch.zeros((8, np_), dtype=torch.int32, device="cuda")
    splits, tps = _tokens_per_split(q0, k0, pt0, window)
    assert splits > 1, "the case must split the keys"
    full = ps * np_
    lens = [1, ps - 1, ps, ps + 1, tps - 1, tps, min(tps + 1, full), full]
    rng = np.random.default_rng(window)
    _check(_pools(rng, lens, [0] * len(lens), kv=kv, g=g, d=d, ps=ps,
                  np_=np_), dtype, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 700])
def test_cuda_long_table_one_slot(dtype, window):
    """One slot, one KV head, a 4096-token table: many splits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(11)
    _check(_pools(rng, [4001], [1], kv=1, g=4, d=128, ps=16, np_=256),
           dtype, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 6, 100])
def test_cuda_nan_sink_and_stale_pages(dtype, window):
    """NaN in the sink page, the grown-ahead pages and the tail of each
    slot's last page: the output stays finite and within the limit of the
    plain version on the same inputs with those positions at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    lens, extra = [1, 37, 512, 200, 16], [2, 1, 0, 1, 3]
    kw = dict(kv=2, g=4, d=96, ps=16, np_=32)
    arrs = _pools(np.random.default_rng(7), lens, extra, fill=np.nan, **kw)
    clean = _pools(np.random.default_rng(7), lens, extra, fill=0.0, **kw)
    _check(arrs, dtype, window, clean=clean)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_capacity_g8_d128_16k_tokens(dtype):
    """G 8, D 128 and 16,384 tokens a slot: the kernel's shared memory
    does not grow with the context, so it takes the case (a [G, tokens]
    fp32 score row would need 512 KB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(16384)
    _check(_pools(rng, [16384, 9000], [0, 2], kv=2, g=8, d=128, ps=16,
                  np_=1024), dtype, 0)
