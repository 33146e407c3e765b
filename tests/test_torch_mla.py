"""DeepSeek-V2-Lite's attention path, the port against the JAX package:
RoPE, the paged MLA decode kernel's plain version, MLA attention over
paged latent pools (decode and chunked prefill), the latent pools, the
shared experts of the pipelined MoE and the streamed compute-dtype init.

The same numpy inputs, made from a seed, go through each JAX function
and its counterpart in ``repro_torch`` on the CPU, in fp32, held within
atol 1e-5 (rtol 1e-5 where values grow): the two frameworks sum in
another order. The JAX MLA kernel runs in interpret mode. On this CPU
the interpret-mode kernel is not bit-equal to the JAX gather path (the
JAX package's own exactness tier fails there), so the port is held to a
tolerance, not to bit-equality.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import pipeline_moe as jpipe
from repro.kernels.paged_attention import kernel as jkernel
from repro.kernels.paged_attention import ref as jref
from repro.models.layers import attention as jattn
from repro.models.layers import rope as jrope
from repro_torch.configs import get_config
from repro_torch.core import pipeline_moe as tpipe
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (paged_mla_decode,
                                                 paged_mla_decode_ref)
from repro_torch.kernels.paged_attention.ref import tolerance_mla
from repro_torch.models import kv_cache, lm, module
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import rope as trope
from test_torch_paged_mla_cuda import GARBAGE, _setup_mla

ATOL = 1e-5
ARCH = "deepseek-v2-lite-16b"


def _close(a, b, rtol=0.0, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), rtol=rtol,
                               atol=atol)


def _cfgs():
    return jax_config(ARCH).reduced(), get_config(ARCH).reduced()


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim", [8, 64])
def test_rope_matches_jax_up_to_position_4095(head_dim):
    x = np.random.default_rng(head_dim).standard_normal(
        (1, 4096, 2, head_dim)).astype(np.float32)
    pos = np.arange(4096, dtype=np.int32)[None]
    want = jax.jit(jrope.apply_rope)(jnp.asarray(x), jnp.asarray(pos))
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    jit_freqs = jax.jit(lambda: jrope._freqs(head_dim, 10_000.0))()
    np.testing.assert_array_equal(np.asarray(jit_freqs),
                                  trope._freqs(head_dim, 10_000.0).numpy())
    _close(want, got)


# ---------------------------------------------------------------------------
# The MLA decode kernel's plain version
# ---------------------------------------------------------------------------

# lens 0 (only the token just written) and NP * ps - 1 (the whole table),
# grown-ahead pages, a garbage sink
MLA_CASE = dict(lens=[0, 19, 7, 13, 2], extra=[1, 0, 2, 0, 0], heads=4,
                rank=16, rope=8, ps=4, np_=5)
SCALE = (16 + 8) ** -0.5


@pytest.fixture(scope="module")
def mla_inputs():
    c = MLA_CASE
    arrs = _setup_mla(np.random.default_rng(11), c["lens"], c["extra"],
                      heads=c["heads"], rank=c["rank"], rope=c["rope"],
                      ps=c["ps"], np_=c["np_"])
    qa, qr, cp, kp, pt, ln = arrs
    jargs = (jnp.asarray(qa[:, 0]), jnp.asarray(qr[:, 0]), jnp.asarray(cp),
             jnp.asarray(kp), jnp.asarray(pt), jnp.asarray(ln))
    kern = jax.jit(functools.partial(jkernel.paged_mla_decode_kernel,
                                     scale=SCALE, interpret=True))(*jargs)
    ref = jax.jit(functools.partial(jref.paged_mla_decode_ref,
                                    scale=SCALE))(*jargs)
    return arrs, np.asarray(kern), np.asarray(ref)


def test_plain_mla_matches_jax_kernel_and_ref(mla_inputs):
    arrs, kern, ref = mla_inputs
    qa, qr, cp, kp, pt, ln = (torch.from_numpy(a) for a in arrs)
    build.reset_launches()
    port = paged_mla_decode(qa, qr, cp, kp, pt, ln, scale=SCALE)
    plain = paged_mla_decode_ref(qa[:, 0], qr[:, 0], cp, kp, pt, ln,
                                 scale=SCALE)
    assert port.shape == qa.shape and port.dtype == torch.float32
    assert torch.equal(port[:, 0], plain)     # the CPU takes the plain one
    assert build.LAUNCHES["paged_mla_decode"] == 0
    assert np.isfinite(port.numpy()).all()
    _close(kern, port[:, 0])
    _close(ref, plain)


def test_mla_wrapper_rejects_multi_query_and_misfit_pools(mla_inputs):
    arrs, _, _ = mla_inputs
    qa, qr, cp, kp, pt, ln = (torch.from_numpy(a) for a in arrs)
    with pytest.raises(ValueError, match="single-query"):
        paged_mla_decode(qa.expand(-1, 2, -1, -1), qr, cp, kp, pt, ln,
                         scale=SCALE)
    with pytest.raises(ValueError, match=r"\[P, ps, R\]"):
        paged_mla_decode(qa, qr, cp[..., :8], kp, pt, ln, scale=SCALE)


def _mla_f64(qa, qr, cp, kp, pt, ln, scale, *, visible=lambda t, n: t <= n):
    """The function in float64 with numpy, one slot at a time."""
    b, h, r = qa.shape
    out = np.zeros((b, h, r))
    for i in range(b):
        ckv = cp[pt[i]].reshape(-1, r).astype(np.float64)
        kr = kp[pt[i]].reshape(-1, kp.shape[-1]).astype(np.float64)
        keep = visible(np.arange(ckv.shape[0]), ln[i])
        s = (qa[i].astype(np.float64) @ ckv[keep].T
             + qr[i].astype(np.float64) @ kr[keep].T) * scale
        p = np.exp(s - s.max(-1, keepdims=True))
        out[i] = (p / p.sum(-1, keepdims=True)) @ ckv[keep]
    return out


def test_mla_tolerance_admits_fp32_and_refuses_a_wrong_mask(mla_inputs):
    """``tolerance_mla`` admits the fp32 plain version against a float64
    computation of the same function, at unit-scale and at 8x inputs,
    and refuses the GQA kernel's mask (t < lens, which drops the token
    just written) and the wrong scale (R^-0.5)."""
    arrs, _, _ = mla_inputs
    qa, qr, cp, kp, pt, ln = arrs
    for mul in (1.0, 8.0):
        t = [torch.from_numpy(a) for a in (qa[:, 0] * mul, qr[:, 0] * mul,
                                           cp, kp, pt, ln)]
        plain = paged_mla_decode_ref(*t, scale=SCALE).numpy()
        tol = tolerance_mla(*t, scale=SCALE)
        exact = _mla_f64(qa[:, 0] * mul, qr[:, 0] * mul, cp, kp, pt, ln,
                         SCALE)
        assert np.abs(plain - exact).max() <= tol
    t = [torch.from_numpy(a) for a in (qa[:, 0], qr[:, 0], cp, kp, pt, ln)]
    tol = tolerance_mla(*t, scale=SCALE)
    assert tol < 1e-3
    exact = _mla_f64(qa[:, 0], qr[:, 0], cp, kp, pt, ln, SCALE)
    shifted = _mla_f64(qa[:, 0], qr[:, 0], cp, kp, pt, np.maximum(ln, 1),
                       SCALE, visible=lambda t, n: t < n)
    assert np.abs(shifted - exact).max() > tol
    wrong = _mla_f64(qa[:, 0], qr[:, 0], cp, kp, pt, ln, 16 ** -0.5)
    assert np.abs(wrong - exact).max() > tol
    assert np.abs(cp).max() == GARBAGE           # the sink is loud


# ---------------------------------------------------------------------------
# MLA attention over paged latent pools
# ---------------------------------------------------------------------------

def _attn_params(cfg, rng):
    def draw(s):
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) * fan_in ** -0.5).astype(
            np.float32)
    return {k: draw(s) for k, s in tattn.specs(cfg).items()}


def _pools(cfg, rng, pages, ps):
    m = cfg.attn.mla
    return {"ckv_pool": rng.standard_normal(
                (pages, ps, m.kv_lora_rank)).astype(np.float32),
            "kr_pool": rng.standard_normal(
                (pages, ps, m.rope_head_dim)).astype(np.float32)}


def _run_both(jcfg, tcfg, params, x, pools, shared, positions, mode,
              attn_kernel="gather"):
    def jfn(p, x_, c):
        c = dict(c, attn_kernel="gather")
        return jattn.apply(p, x_, cfg=jcfg, positions=c.pop("positions"),
                           mode=mode, cache=c)
    jcache = dict({k: jnp.asarray(v) for k, v in pools.items()},
                  **{k: jnp.asarray(v) for k, v in shared.items()},
                  positions=jnp.asarray(positions))
    jout, jnew = jax.jit(jfn)({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(x), jcache)
    tcache = dict({k: torch.from_numpy(v.copy()) for k, v in pools.items()},
                  **{k: torch.from_numpy(v) for k, v in shared.items()},
                  attn_kernel=attn_kernel)
    tout, tnew = tattn.apply({k: torch.from_numpy(v)
                              for k, v in params.items()},
                             torch.from_numpy(x), cfg=tcfg,
                             positions=torch.from_numpy(positions),
                             mode=mode, cache=tcache)
    return jout, jnew, tout, tnew


@pytest.mark.parametrize("attn_kernel", ["gather", "kernel"])
def test_mla_paged_decode_matches_jax(attn_kernel):
    """Three slots, one inactive (its write goes to the sink); "kernel"
    on CPU tensors runs the kernel's plain version."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(3)
    params = _attn_params(tcfg, rng)
    ps, np_ = 4, 5
    pools = _pools(tcfg, rng, 12, ps)
    pt = np.array([[1, 2, 3, 0, 0], [4, 5, 6, 7, 8], [9, 10, 0, 0, 0]],
                  np.int32)
    lens = np.array([9, 19, 4], np.int32)
    shared = {"page_table": pt, "lens": lens,
              "write_valid": np.array([[True], [True], [False]]),
              "write_sink": np.zeros(3, np.int32)}
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    jout, jnew, tout, tnew = _run_both(
        jcfg, tcfg, params, x, pools, shared, lens[:, None], "decode",
        attn_kernel)
    _close(jout, tout)
    for k in ("ckv_pool", "kr_pool"):
        _close(jnew[k], tnew[k])


def test_mla_paged_prefill_chunk_matches_jax():
    """A 6-token chunk at offset 5, its last two positions padding."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(4)
    params = _attn_params(tcfg, rng)
    pools = _pools(tcfg, rng, 6, 4)
    shared = {"page_table": np.array([[2, 3, 4, 0, 0]], np.int32),
              "lens": np.array([5], np.int32),
              "write_valid": (np.arange(6) < 4)[None],
              "write_sink": np.zeros(1, np.int32)}
    x = rng.standard_normal((1, 6, tcfg.d_model)).astype(np.float32)
    positions = (5 + np.arange(6, dtype=np.int32))[None]
    jout, jnew, tout, tnew = _run_both(jcfg, tcfg, params, x, pools, shared,
                                       positions, "prefill")
    _close(np.asarray(jout)[:, :4], tout[:, :4])
    for k in ("ckv_pool", "kr_pool"):
        _close(jnew[k], tnew[k])


def test_mla_without_pools_raises():
    _, tcfg = _cfgs()
    params = {k: torch.zeros(s.shape)
              for k, s in tattn.specs(tcfg).items()}
    with pytest.raises(NotImplementedError, match="_apply_mla"):
        tattn.apply(params, torch.zeros((1, 4, tcfg.d_model)), cfg=tcfg,
                    positions=torch.arange(4)[None], mode="train")


def test_latent_pools_are_mla_sized_and_trailing_dim_generic():
    """One attention layer's MLA pools hold (R + E) values a token: 1,152
    bytes in bf16 at full width; the page allocator counts them like
    K/V pools, and the scatter/gather pair round-trips 2-D latents."""
    cfg = get_config(ARCH)
    role = cfg.layer_roles()[0]
    pools = kv_cache.paged_layer_pool(cfg, role, 3, 16, device="meta")
    assert pools["ckv_pool"].shape == (3, 16, 512)
    assert pools["kr_pool"].shape == (3, 16, 64)
    assert kv_cache.tree_bytes([{"l0": pools}]) == 3 * 16 * 1152
    from repro_torch.serve.paged_kv import PagedKVCache
    _, tcfg = _cfgs()
    kv = PagedKVCache(tcfg, num_pages=5, page_size=4, max_slots=2,
                      max_pages_per_seq=2, dtype=torch.float32)
    m = tcfg.attn.mla
    per_token = tcfg.num_layers * (m.kv_lora_rank + m.rope_head_dim) * 4
    assert kv.page_bytes == 4 * per_token
    pool = kv.pools[0]["l0"]["ckv_pool"]
    vals = torch.arange(2 * 3 * m.kv_lora_rank, dtype=torch.float32
                        ).reshape(2, 3, m.kv_lora_rank)
    pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([[3, 4, 5], [0, 1, 2]])
    kv_cache.scatter_pages(pool, pt, pos, vals)
    got = kv_cache.gather_pages(pool, pt)
    for b in range(2):
        assert torch.equal(got[b, pos[b]], vals[b])


# ---------------------------------------------------------------------------
# Shared experts in the pipelined MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_pipelined_moe_with_shared_experts_matches_jax(mode):
    """Reduced DeepSeek-V2-Lite: 4 experts, top-2, one shared expert,
    gated silu, n = 2 chunks in prefill."""
    jcfg, tcfg = _cfgs()
    m = tcfg.moe
    assert m.num_shared_experts == 1 and m.top_k == 2 and tcfg.gated_ffn
    rng = np.random.default_rng(9)
    d = tcfg.d_model

    def w(*shape):
        return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(
            np.float32)
    p = {"router": {"w_gate": w(d, m.num_experts) * 5.0},
         "experts": {"w_up": w(m.num_experts, d, m.d_expert),
                     "w_gate": w(m.num_experts, d, m.d_expert),
                     "w_down": w(m.num_experts, m.d_expert, d)},
         "shared": {"w_up": w(d, m.d_shared), "w_gate": w(d, m.d_shared),
                    "w_down": w(m.d_shared, d)}}
    x = rng.standard_normal((16, d)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    oj, aj = jax.jit(lambda p_, x_: jpipe.pipelined_moe(
        p_, x_, cfg=jcfg, mode=mode))(jp, jnp.asarray(x))
    tp = {g: {k: torch.from_numpy(v) for k, v in d_.items()}
          for g, d_ in p.items()}
    ot, at = tpipe.pipelined_moe(tp, torch.from_numpy(x), cfg=tcfg,
                                 mode=mode)
    _close(oj, ot, rtol=1e-5)
    for key in ("aux_loss", "z_loss"):
        _close(aj[key], at[key], rtol=1e-5)
    no_shared = dict(tp, shared={k: torch.zeros_like(v)
                                 for k, v in tp["shared"].items()})
    ot0, _ = tpipe.pipelined_moe(no_shared, torch.from_numpy(x), cfg=tcfg,
                                 mode=mode)
    assert (ot - ot0).abs().max() > 1e-2        # the shared path counts


# ---------------------------------------------------------------------------
# The streamed init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_init_equals_cast_of_fp32_init(dtype):
    """``lm.init_compute`` is ``compute_params(init(...))`` bit for bit:
    the same draws in the same order, each cast at once; the router gate
    stays fp32."""
    _, cfg = _cfgs()
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    want = lm.compute_params(lm.init(cfg, 3, device="cpu"), cfg)
    got = lm.init_compute(cfg, 3, device="cpu")
    wl, gl = module.leaves(want), module.leaves(got)
    assert len(wl) == len(gl) == len(module.leaves(lm.specs_tree(cfg)))
    for a, b in zip(wl, gl):
        assert a.dtype == b.dtype and torch.equal(a, b)
    gate = got["periods"][0]["l0"]["moe"]["router"]["w_gate"]
    assert gate.dtype == torch.float32
    assert got["embed"]["tok"].dtype == getattr(torch, dtype)
