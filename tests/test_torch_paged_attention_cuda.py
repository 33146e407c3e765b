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
