"""The prefix cache on the card: shared pages read through several
page-table rows, copy-on-write between replays of the captured decode
step, and an engine with the cache on.

* Both paged decode kernels (``paged_decode.cu``, GQA;
  ``paged_mla_decode.cu``, MLA) on page tables whose rows share physical
  pages, as the prefix trie binds them (a common prefix, whole rows
  alike, a shared page partly covered), against their plain versions
  within the unchanged ``ref.tolerance`` / ``ref.tolerance_mla``.
* ``copy_pages`` between two replays of a captured ``DecodeStep``: every
  written page of every decoding slot is copied to a fresh page, the
  host table re-mapped and the old pages overwritten with garbage; the
  replay after the copy must read the copies (its logits equal an eager
  step's on the same inputs before the copy) and the pools keep their
  addresses.
* An engine with ``prefix_cache="on"``: captured and eager greedy tokens
  equal in fp32, and equal to the cache off, on reduced moe-gpt3-s and
  DeepSeek-V2-Lite at capacity factor 8.0 (no token dropped).

This file imports neither ``jax`` nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_prefix_cuda.py

Elsewhere it skips: a CUDA kernel has no CPU mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import build

GARBAGE = 3.0e4          # sink / stale page fill; finite but loud
ARCHES = ("moe-gpt3-s", "deepseek-v2-lite-16b")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _aliased_table(lens, ps, np_, shared_pages):
    """A page table whose rows share physical pages as the trie binds
    them: every row starts with the same ``shared_pages`` pages (capped
    at what it covers), rows 0 and 1 are alike, and the rest own fresh
    pages for their tails. Returns (table [B, NP] int32, pages used)."""
    b = len(lens)
    table = np.zeros((b, np_), np.int32)
    nxt = 1 + shared_pages
    common = np.arange(1, 1 + shared_pages)
    for i, n in enumerate(lens):
        used = -(-(n + 1) // ps)
        assert used <= np_
        k = min(used, shared_pages)
        table[i, :k] = common[:k]
        if i == 1 and lens[1] == lens[0]:
            table[1] = table[0]
            continue
        table[i, k:used] = np.arange(nxt, nxt + used - k)
        nxt += used - k
    return table, nxt


GQA_CASES = [
    # the moe-gpt3-s engine's shape: 8 slots, D 96, pages of 16
    dict(kv=4, g=3, d=96, ps=16, np_=32, shared=16,
         lens=[300, 300, 255, 256, 257, 40, 511, 16]),
    # small pages, a shared page partly covered by a short row
    dict(kv=2, g=4, d=64, ps=4, np_=8, shared=3, lens=[9, 9, 5, 30, 2]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(GQA_CASES)))
def test_gqa_decode_over_shared_pages(dtype, case):
    _cuda()
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_decode_attention_ref)
    from repro_torch.kernels.paged_attention.ref import tolerance
    c = GQA_CASES[case]
    rng = np.random.default_rng(case)
    table, pages = _aliased_table(c["lens"], c["ps"], c["np_"],
                                  c["shared"])
    b, kv, g, d = len(c["lens"]), c["kv"], c["g"], c["d"]
    pools = [rng.standard_normal((pages, c["ps"], kv, d)).astype(np.float32)
             for _ in range(2)]
    for pool in pools:
        pool[0] = GARBAGE
    q = rng.standard_normal((b, 1, kv * g, d)).astype(np.float32)
    q_, kp, vp = (torch.from_numpy(a).to("cuda", dtype) for a in
                  (q, *pools))
    pt = torch.from_numpy(table).cuda()
    # the kernel's lens count the position being decoded (t < lens)
    lens = torch.as_tensor(np.asarray(c["lens"]) + 1, dtype=torch.int32,
                           device="cuda")
    build.reset_launches()
    out = paged_decode_attention(q_, kp, vp, pt, lens)
    torch.cuda.synchronize()
    assert build.LAUNCHES["paged_decode_attention"] == 1
    plain = paged_decode_attention_ref(
        q_.reshape(b, kv, g, d), kp, vp, pt, lens).reshape(b, 1, kv * g, d)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), plain.float(), rtol=0,
                               atol=tolerance(plain))
    # rows 0 and 1 read the same pages with the same q rows: equal output
    q_[1] = q_[0]
    out = paged_decode_attention(q_, kp, vp, pt, lens)
    assert torch.equal(out[0], out[1])


MLA_CASES = [
    # DeepSeek-V2-Lite's engine shape: 16 heads, latent 512, rotary 64
    dict(heads=16, rank=512, rope=64, ps=16, np_=32, shared=16,
         lens=[300, 300, 255, 256, 257, 40, 510, 15]),
    dict(heads=4, rank=16, rope=8, ps=4, np_=8, shared=3,
         lens=[9, 9, 5, 30, 2]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(MLA_CASES)))
def test_mla_decode_over_shared_pages(dtype, case):
    _cuda()
    from repro_torch.kernels.paged_attention import (paged_mla_decode,
                                                     paged_mla_decode_ref)
    from repro_torch.kernels.paged_attention.ref import tolerance_mla
    c = MLA_CASES[case]
    rng = np.random.default_rng(10 + case)
    table, pages = _aliased_table(c["lens"], c["ps"], c["np_"],
                                  c["shared"])
    b, h = len(c["lens"]), c["heads"]
    ckv = rng.standard_normal((pages, c["ps"], c["rank"])).astype(np.float32)
    kr = rng.standard_normal((pages, c["ps"], c["rope"])).astype(np.float32)
    ckv[0], kr[0] = GARBAGE, GARBAGE
    qa = rng.standard_normal((b, 1, h, c["rank"])).astype(np.float32)
    qr = rng.standard_normal((b, 1, h, c["rope"])).astype(np.float32)
    qa_, qr_, cp, kp = (torch.from_numpy(a).to("cuda", dtype)
                        for a in (qa, qr, ckv, kr))
    pt = torch.from_numpy(table).cuda()
    # the MLA kernel's lens are the position being decoded (t <= lens)
    ln = torch.as_tensor(c["lens"], dtype=torch.int32, device="cuda")
    scale = (c["rank"] // 4 + c["rope"]) ** -0.5
    build.reset_launches()
    out = paged_mla_decode(qa_, qr_, cp, kp, pt, ln, scale=scale)
    torch.cuda.synchronize()
    assert build.LAUNCHES["paged_mla_decode"] == 1
    ref = paged_mla_decode_ref(qa_[:, 0], qr_[:, 0], cp, kp, pt, ln,
                               scale=scale)[:, None]
    assert torch.isfinite(out).all()
    tol = tolerance_mla(qa_[:, 0], qr_[:, 0], cp, kp, pt, ln, scale=scale)
    assert (out - ref).abs().max().item() <= tol


def _cfg(arch):
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    return dataclasses.replace(
        cfg, compute_dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _engine(arch, params=None, **opts):
    from repro_torch.serve import Engine, EngineOptions
    kw = dict(page_size=4, max_slots=4, max_seq_len=64, chunk=16,
              min_bucket=8, adaptive=False)
    kw.update(opts)
    return Engine(_cfg(arch), params, options=EngineOptions(
        device="cuda", **kw), seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHES)
def test_copy_pages_between_replays(arch):
    """The replay after a copy reads the copy: its logits equal an eager
    step's on the same inputs, taken before the copy."""
    _cuda()
    from repro_torch.models import kv_cache
    from repro_torch.models.module import leaves
    from repro_torch.serve import RequestState
    from repro_torch.serve.decode_step import DecodeStep
    engine = _engine(arch, prefix_cache="on")
    engine.warmup()
    kv, sched = engine.kv, engine.scheduler
    rng = np.random.default_rng(3)
    reqs = [engine.submit(rng.integers(0, engine.cfg.vocab_size, size=n),
                          max_new_tokens=20) for n in (13, 9, 22)]
    while any(r.state != RequestState.DECODE for r in reqs) \
            or min(len(r.output) for r in reqs) < 3:
        engine.step()
    eager = DecodeStep(engine.params, kv, engine.cfg,
                       attn_kernel=engine.attn_kernel, graph=False)
    tokens = np.zeros((kv.max_slots, 1), np.int64)
    active = np.zeros((kv.max_slots,), bool)
    for s in sched.decode_slots():
        tokens[s, 0] = sched.running[s].output[-1]
        active[s] = True
        # as the engine's decode does: the step's position gets its page
        # (else its write goes to the sink, beside the idle slots')
        assert engine._ensure(s, int(kv.lens[s]) + 1)
    want = eager(tokens, active).clone()
    ptrs = [t.data_ptr() for t in leaves(kv.pools)]
    src, dst = [], []
    for s in sched.decode_slots():
        for i, page in enumerate(kv._slot_pages[s]):
            fresh = kv._take_page(kv.shard_of_slot(s))
            assert fresh is not None
            src.append(page)
            dst.append(fresh)
            kv._slot_pages[s][i] = fresh
            kv.page_table[s, i] = fresh
    assert kv_cache.copy_pages(kv.pools, src, dst) is kv.pools
    idx = torch.as_tensor(src, dtype=torch.long, device="cuda")
    for t in leaves(kv.pools):
        t.index_fill_(0, idx, GARBAGE)          # queued after the copy
    for page in src:
        kv._release_page(page)
    kv.check_integrity()
    replays = engine._decode.replays
    got = engine._decode(tokens, active).clone()
    assert engine._decode.replays == replays + 1
    assert torch.isfinite(got).all()
    tol = 1e-5 * (1.0 + want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    assert [t.data_ptr() for t in leaves(kv.pools)] == ptrs
    engine.run_until_idle()


def _waves(vocab, seed=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, size=16).astype(np.int32)
    w1 = [np.concatenate([shared, rng.integers(1, vocab, size=k)
                          .astype(np.int32)]) for k in (3, 5)]
    w2 = [shared.copy(), shared.copy(),
          np.concatenate([shared, rng.integers(1, vocab, size=2)
                          .astype(np.int32)])]
    return [w1, w2]


def _serve(engine, waves):
    engine.warmup()
    outs = []
    for wave in waves:
        reqs = [engine.submit(p, max_new_tokens=6) for p in wave]
        engine.run_until_idle()
        outs.extend(list(r.output) for r in reqs)
    engine.kv.check_integrity()
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHES)
def test_engine_with_prefix_cache_captured_equals_eager(arch):
    _cuda()
    captured = _engine(arch, prefix_cache="on")
    waves = _waves(captured.cfg.vocab_size)
    got = _serve(captured, waves)
    s = captured.stats()
    assert s["decode_captures"] == 1
    assert s["decode_replays"] == s["decode_steps"]
    assert s["prefix_hits"] >= 3 and s["prefix_cow_copies"] >= 1
    eager = _engine(arch, captured.params, prefix_cache="on",
                    decode_graph=False)
    off = _engine(arch, captured.params, prefix_cache="off")
    assert got == _serve(eager, waves) == _serve(off, waves)
