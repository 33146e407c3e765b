"""The CUDA paged MLA decode kernel and the widened expert-FFN kernel
against their plain versions, and reduced DeepSeek-V2-Lite served
through them, on the card.

The latent pools, page table and queries are laid out as the serving
allocator lays them out (``_setup_mla``, shared with
``test_torch_mla.py``): page 0 is a garbage-filled sink, slots own
``pages_for(lens + 1)`` pages plus grown-ahead ones holding stale
garbage, and ``lens`` runs from 0 (only the token just written is
visible) to the table's last position. The MLA kernel is held within
``ref.tolerance_mla`` and the expert FFN at M = 2048 within its
``ref.tolerance``. This file imports neither ``jax`` nor the JAX package,
so on a machine with an H100 and ``nvcc`` it runs without them
(``--noconftest`` skips the suite's JAX set-up):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_paged_mla_cuda.py

Elsewhere it skips: the kernels have no CPU mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import build

GARBAGE = 3.0e4  # sink / stale page fill; finite but loud if it leaks


def _setup_mla(rng, lens, extra_pages, *, heads, rank, rope, ps, np_,
               q_scale=1.0, fill=GARBAGE):
    """(q_abs [B, 1, H, R], q_rope [B, 1, H, E], ckv_pool [P, ps, R],
    kr_pool [P, ps, E], page_table [B, NP] int32, lens [B] int32) as
    numpy: slot b holds ``pages_for(lens[b] + 1) + extra_pages[b]``
    distinct pages; the sink (page 0), the extra pages and the positions
    past ``lens`` in the last used page hold ``fill`` (``GARBAGE``);
    unallocated entries point at the sink."""
    b = len(lens)
    owned = [-(-(n + 1) // ps) + e for n, e in zip(lens, extra_pages)]
    assert all(o <= np_ for o in owned)
    pages = 1 + sum(owned)
    ckv = rng.standard_normal((pages, ps, rank)).astype(np.float32)
    kr = rng.standard_normal((pages, ps, rope)).astype(np.float32)
    pt = np.zeros((b, np_), np.int32)
    nxt = 1
    for i, (n, o) in enumerate(zip(lens, owned)):
        pt[i, :o] = np.arange(nxt, nxt + o)
        used = -(-(n + 1) // ps)
        for pool in (ckv, kr):
            pool[nxt + used:nxt + o] = fill
            pool[nxt + used - 1, (n + 1) - (used - 1) * ps:] = fill
        nxt += o
    ckv[0] = fill
    kr[0] = fill
    q_abs = (rng.standard_normal((b, 1, heads, rank)) * q_scale)
    q_rope = (rng.standard_normal((b, 1, heads, rope)) * q_scale)
    return (q_abs.astype(np.float32), q_rope.astype(np.float32), ckv, kr, pt,
            np.asarray(lens, np.int32))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,rank,rope,ps,np_,lens,extra", [
    # DeepSeek-V2-Lite's widths: 16 heads, latent 512, rotary 64
    (16, 512, 64, 16, 8, [0, 127, 37, 64, 16], [0, 0, 2, 1, 0]),
    # many splits: one slot, a long table
    (16, 512, 64, 16, 64, [1000], [1]),
    # fewer heads, a depth below one WMMA step, tiles across pages of 4
    (4, 16, 8, 4, 5, [0, 19, 7, 13], [1, 0, 2, 0]),
])
def test_mla_kernel_matches_plain(dtype, heads, rank, rope, ps, np_, lens,
                                  extra):
    _cuda()
    from repro_torch.kernels.paged_attention import (paged_mla_decode,
                                                     paged_mla_decode_ref)
    from repro_torch.kernels.paged_attention.ref import tolerance_mla
    rng = np.random.default_rng(len(lens) + rank)
    arrs = _setup_mla(rng, lens, extra, heads=heads, rank=rank, rope=rope,
                      ps=ps, np_=np_)
    qa, qr, cp, kp = (torch.from_numpy(a).to("cuda", dtype)
                      for a in arrs[:4])
    pt, ln = (torch.from_numpy(a).cuda() for a in arrs[4:])
    scale = (rank // 4 + rope) ** -0.5
    build.reset_launches()
    out = paged_mla_decode(qa, qr, cp, kp, pt, ln, scale=scale)
    torch.cuda.synchronize()
    assert build.LAUNCHES["paged_mla_decode"] == 1
    ref = paged_mla_decode_ref(qa[:, 0], qr[:, 0], cp, kp, pt, ln,
                               scale=scale)[:, None]
    assert out.dtype == torch.float32 and out.shape == qa.shape
    assert torch.isfinite(out).all()
    tol = tolerance_mla(qa[:, 0], qr[:, 0], cp, kp, pt, ln, scale=scale)
    assert (out - ref).abs().max().item() <= tol


def _check_mla(arrs, dtype, *, clean=None):
    """The MLA kernel against its plain version within ``tolerance_mla``,
    one counted launch; ``clean`` (the same inputs without NaNs) feeds
    the plain version and the limit where the pools hold NaN outside the
    visible range. Returns the worst error's share of the limit."""
    from repro_torch.kernels.paged_attention import (paged_mla_decode,
                                                     paged_mla_decode_ref)
    from repro_torch.kernels.paged_attention.ref import tolerance_mla
    rank, rope = arrs[0].shape[-1], arrs[1].shape[-1]
    scale = (rank // 4 + rope) ** -0.5

    def on_card(a):
        qa, qr, cp, kp = (torch.from_numpy(x).to("cuda", dtype)
                          for x in a[:4])
        return qa, qr, cp, kp, *(torch.from_numpy(x).cuda() for x in a[4:])
    qa, qr, cp, kp, pt, ln = on_card(arrs)
    build.reset_launches()
    out = paged_mla_decode(qa, qr, cp, kp, pt, ln, scale=scale)
    torch.cuda.synchronize()
    assert build.LAUNCHES["paged_mla_decode"] == 1
    if clean is not None:
        qa, qr, cp, kp, pt, ln = on_card(clean)
    ref = paged_mla_decode_ref(qa[:, 0], qr[:, 0], cp, kp, pt, ln,
                               scale=scale)[:, None]
    assert out.dtype == torch.float32 and out.shape == qa.shape
    assert torch.isfinite(out).all()
    tol = tolerance_mla(qa[:, 0], qr[:, 0], cp, kp, pt, ln, scale=scale)
    err = (out - ref).abs().max().item()
    assert err <= tol
    return err / tol


def _mla_splits(b, heads, rank, rope, ps, np_, dtype):
    from repro_torch.kernels.paged_attention.ops import \
        paged_mla_decode_splits
    qa = torch.zeros((b, 1, heads, rank), dtype=dtype, device="cuda")
    qr = torch.zeros((b, 1, heads, rope), dtype=dtype, device="cuda")
    cp = torch.zeros((1, ps, rank), dtype=dtype, device="cuda")
    pt = torch.zeros((b, np_), dtype=torch.int32, device="cuda")
    splits = paged_mla_decode_splits(qa, qr, cp, pt)
    t = ps * np_
    return splits, -(-(-(-t // splits)) // 32) * 32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,rank,rope", [(16, 512, 64), (4, 16, 8)])
def test_mla_split_and_tile_edges(dtype, heads, rank, rope):
    """Positions 0, on a tile edge and either side, on a split edge and
    either side, and the table's last."""
    _cuda()
    ps, np_ = 16, 32
    splits, tps = _mla_splits(9, heads, rank, rope, ps, np_, dtype)
    assert splits > 1, "the case must split the keys"
    full = ps * np_ - 1
    lens = [0, 30, 31, 32, tps - 2, tps - 1, tps, full - 1, full]
    rng = np.random.default_rng(rank)
    _check_mla(_setup_mla(rng, lens, [0] * len(lens), heads=heads, rank=rank,
                          rope=rope, ps=ps, np_=np_), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 5, 8, 15])
def test_mla_fewer_heads(dtype, heads):
    """H < 16 at DeepSeek-V2-Lite's widths: the missing heads' rows are
    zero and never written."""
    _cuda()
    rng = np.random.default_rng(heads)
    _check_mla(_setup_mla(rng, [0, 511, 37, 200], [1, 0, 2, 0],
                          heads=heads, rank=512, rope=64, ps=16, np_=32),
               dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_one_slot_16k(dtype):
    """B 1 x 16,384 positions: many splits of one slot."""
    _cuda()
    rng = np.random.default_rng(16384)
    _check_mla(_setup_mla(rng, [16383], [0], heads=16, rank=512, rope=64,
                          ps=16, np_=1024), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_nan_sink_and_stale_pages(dtype):
    """NaN in the sink page, grown-ahead pages and the positions past
    each slot's length: the output stays finite and within the limit of
    the plain version on the same inputs with those positions at 0."""
    _cuda()
    lens, extra = [0, 511, 37, 200, 15, 16], [2, 0, 1, 0, 1, 3]
    kw = dict(heads=16, rank=512, rope=64, ps=16, np_=32)
    arrs = _setup_mla(np.random.default_rng(3), lens, extra, fill=np.nan,
                      **kw)
    clean = _setup_mla(np.random.default_rng(3), lens, extra, fill=0.0,
                       **kw)
    _check_mla(arrs, dtype, clean=clean)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,m,h", [
    (8, 8, 2048, 1408),     # DeepSeek-V2-Lite's experts, decode capacity
    (2, 40, 1536, 256),     # 16-row tiles, ragged C
])
def test_grouped_ffn_takes_m_2048(dtype, e, c, m, h):
    _cuda()
    from repro_torch.kernels.grouped_ffn import grouped_ffn, grouped_ffn_ref
    from repro_torch.kernels.grouped_ffn.ref import tolerance

    def randn(shape, seed, scale=1.0):
        x = np.random.default_rng(seed).standard_normal(shape) * scale
        return torch.from_numpy(x.astype(np.float32)).cuda().to(dtype)
    x = randn((e, c, m), 1)
    wu, wg = randn((e, m, h), 2, m ** -0.5), randn((e, m, h), 3, m ** -0.5)
    wd = randn((e, h, m), 4, h ** -0.5)
    build.reset_launches()
    out = grouped_ffn(x, wu, wg, wd, "silu")
    ref = grouped_ffn_ref(x, wu, wg, wd, "silu")
    torch.cuda.synchronize()
    assert build.LAUNCHES["grouped_ffn"] == 1
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tolerance(ref)


@pytest.mark.cuda
def test_reduced_deepseek_kernel_and_gather_give_equal_tokens():
    """Reduced DeepSeek-V2-Lite in fp32 on the card: greedy tokens equal
    through the MLA kernel and through the gathered einsums, with one
    kernel launch per attention layer of every decode step."""
    _cuda()
    from repro_torch.configs import get_config
    from repro_torch.serve import Engine, EngineOptions
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (13, 5, 30)]
    tokens = {}
    for kern in ("kernel", "gather"):
        eng = Engine(cfg, options=EngineOptions(
            page_size=4, max_slots=2, max_seq_len=64, chunk=16,
            attn_kernel=kern), seed=0)
        reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        build.reset_launches()
        eng.run_until_idle()
        tokens[kern] = [list(r.output) for r in reqs]
        want = eng.stats()["decode_steps"] * cfg.num_layers \
            if kern == "kernel" else 0
        assert build.LAUNCHES["paged_mla_decode"] == want
    assert tokens["kernel"] == tokens["gather"]
    assert all(len(t) == 10 for t in tokens["kernel"])
