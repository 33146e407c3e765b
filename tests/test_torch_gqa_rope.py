"""RoPE, GQA attention, the serving check, the loss and the two attention
kernels' plain versions at the GQA decoders' head dims: the port against
the JAX package on the CPU, fp32.

* RoPE: the frequencies bit-equal to jitted JAX's at head dims 80, 128
  and 256 and thetas 10k, 500k and 1M (llama3 500k, danube and gemma3's
  local layers 10k, qwen1.5 and gemma3's global layers 1M); the rotated
  values within 1e-6 up to position 8191 (the two libraries' cos / sin
  differ by an ulp).
* ``attention.apply`` of one layer of each reduced config (gemma3: a
  local and a global one), prefill of 40 tokens into a dense cache (past
  the window of 32) and 3 decode steps, within 2e-5.
* ``serving_support`` equal to JAX's, kind and reason, for all 13 JAX
  configs (the port's copy of each ``ArchConfig``), and the engine's
  refusals.
* ``loss_fn`` and its gradients at reduced llama3-8b within rtol 1e-4.
* The plain paged decode and flash attention against the JAX package's
  Pallas kernels in interpret mode and their references at head dims 80
  and 256 (GQA groups 4 and 2, windowed and not).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.data import SyntheticTokens as JaxTokens
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_ref as jflash_ref
from repro.kernels.paged_attention import (paged_decode_attention as
                                           jax_paged,
                                           paged_decode_attention_ref as
                                           jpaged_ref)
from repro.models import api as japi
from repro.models import kv_cache as jkv
from repro.models import lm as jlm
from repro.models.layers import attention as jattn
from repro.models.layers import rope as jrope
from repro_torch import configs as tconfigs
from repro_torch.convert import from_jax
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.paged_attention import paged_decode_attention_ref
from repro_torch.models import api, kv_cache
from repro_torch.models import lm as tlm
from repro_torch.models.layers import attention, rope
from repro_torch.models.module import leaves
from repro_torch.serve import Engine, EngineOptions
from test_torch_paged_attention_cuda import _setup
import torch_gqa_harness as H

ATTN_TOL = 2e-5


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [10_000.0, 500_000.0, 1_000_000.0])
@pytest.mark.parametrize("head_dim", [80, 128, 256])
def test_rope_bit_equal_to_jitted_jax(head_dim, theta):
    want = jax.jit(lambda: jrope._freqs(head_dim, theta))()
    np.testing.assert_array_equal(np.asarray(want),
                                  rope._freqs(head_dim, theta).numpy())
    x = np.random.default_rng(head_dim).standard_normal(
        (1, 8192, 1, head_dim)).astype(np.float32)
    pos = np.arange(8192, dtype=np.int32)[None]
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jax.jit(functools.partial(jrope.apply_rope, theta=theta))(
        jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# attention.apply, dense prefill and decode
# ---------------------------------------------------------------------------

LAYERS = [(arch, 0) for arch in H.GQA_ARCHS] + [("gemma3-12b", 5)]


@pytest.mark.parametrize("arch,layer", LAYERS)
def test_attention_prefill_and_decode_match_jax(arch, layer):
    jcfg, cfg = H.configs(arch)
    role = cfg.layer_roles()[layer]
    pnp = H.np_params(jcfg, 0)["periods"][f"l{layer}"]["mixer"]
    pnp = {k: v[0] for k, v in pnp.items()}              # period 0
    rng = np.random.default_rng(layer + 3)
    b, s, steps = 2, 40, 3
    x = rng.standard_normal((b, s + steps, cfg.d_model)).astype(np.float32)
    g = role["global_attn"]

    jp = {k: jnp.asarray(v) for k, v in pnp.items()}
    jcache = jkv.layer_cache(jcfg, role, b, H.MAX_LEN, jnp.float32)
    jcache = jax.tree_util.tree_map(jnp.zeros_like, jcache)
    run = jax.jit(lambda p, x, pos, c, mode: jattn.apply(
        p, x, cfg=jcfg, positions=pos, is_global=g, mode=mode, cache=c),
        static_argnums=4)
    pos = np.broadcast_to(np.arange(s), (b, s))
    want = [run(jp, x[:, :s], pos, jcache, "prefill")]
    jcache = want[0][1]
    for t in range(steps):
        want.append(run(jp, x[:, s + t:s + t + 1], None, jcache, "decode"))
        jcache = want[-1][1]

    tp = {k: torch.from_numpy(v) for k, v in pnp.items()}
    cache = kv_cache.layer_cache(cfg, role, b, H.MAX_LEN, torch.float32,
                                 "cpu")
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out, cache = attention.apply(tp, xt[:, :s], cfg=cfg,
                                     positions=torch.from_numpy(pos.copy()),
                                     is_global=g, mode="prefill",
                                     cache=cache)
        got = [out]
        for t in range(steps):
            p = torch.full((b, 1), s + t, dtype=torch.long)
            out, cache = attention.apply(tp, xt[:, s + t:s + t + 1],
                                         cfg=cfg, positions=p, is_global=g,
                                         mode="decode", cache=cache)
            got.append(out)
    for w, o in zip(want, got):
        np.testing.assert_allclose(o.numpy(), np.asarray(w[0]), rtol=0,
                                   atol=ATTN_TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=0, atol=ATTN_TOL)


def test_mrope_raises_naming_the_roadmap():
    _, cfg = H.configs("llama3-8b")
    cfg = dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                            mrope=True))
    q = torch.zeros((1, 2, cfg.attn.num_heads, cfg.head_dim))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        attention._rope_qk(q, q, cfg, torch.zeros((1, 2)), is_global=True)


# ---------------------------------------------------------------------------
# serving_support and the engine's check
# ---------------------------------------------------------------------------

def _port_config(jcfg):
    """The port's ``ArchConfig`` with ``jcfg``'s fields (the two packages'
    dataclasses are field for field the same)."""
    kinds = {"attn": tconfigs.AttentionConfig, "moe": tconfigs.MoEConfig,
             "mamba": tconfigs.MambaConfig, "xlstm": tconfigs.XLSTMConfig,
             "encoder": tconfigs.EncoderConfig}
    fields = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if f.name in kinds and v is not None:
            sub = {g.name: getattr(v, g.name) for g in dataclasses.fields(v)}
            if f.name == "attn" and v.mla is not None:
                sub["mla"] = tconfigs.MLAConfig(**dataclasses.asdict(v.mla))
            v = kinds[f.name](**sub)
        fields[f.name] = v
    return tconfigs.ArchConfig(**fields)


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_serving_support_equals_jax(arch):
    jcfg = JAX_ARCHS[arch]
    cfg = _port_config(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert api.serving_support(cfg) == japi.serving_support(jcfg)
    kind, why = japi.serving_support(jcfg)
    if kind == "paged":
        assert api.check_servable(cfg) == "paged"
        return
    match = "ROADMAP.md" if kind is not None else why
    with pytest.raises(NotImplementedError, match=match):
        Engine(cfg, None, options=EngineOptions(device="cpu"))


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_get_model_follows_jax(arch):
    """Where the JAX package dispatches to its decoder-only ``lm``, the
    port's ``get_model`` gives its own ``lm``; the encoder-decoder model
    it does not have yet raises, naming ROADMAP.md."""
    jcfg = JAX_ARCHS[arch]
    cfg = _port_config(jcfg)
    if japi.get_model(jcfg) is jlm:
        assert api.get_model(cfg) is tlm
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        api.get_model(cfg)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

def test_loss_and_gradients_match_jax_at_llama3():
    jcfg, cfg = H.configs("llama3-8b")
    pnp = H.np_params(jcfg, 0)
    batch = JaxTokens(jcfg, batch=2, seq=40, seed=0).batch_at(0)
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, pnp),
            jax.tree_util.tree_map(jnp.asarray, batch))
    tparams = from_jax(pnp, device="cpu")
    flat = [p.requires_grad_(True) for p in leaves(tparams)]
    lt, _ = tlm.loss_fn(tparams, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, cfg)
    gt = torch.autograd.grad(lt, flat)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4)
    want = leaves(from_jax(jax.tree_util.tree_map(np.asarray, gj),
                           device="cpu"))
    assert len(want) == len(gt)
    for a, b in zip(want, gt):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the kernels' plain versions at head dims 80 and 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("d,group", [(80, 4), (256, 2)])
def test_plain_paged_decode_matches_jax_kernel(d, group, window):
    q, kp, vp, pt, lens = _setup(np.random.default_rng(d + window),
                                 [1, 20, 7, 13], [0, 0, 1, 0], group=group,
                                 d=d)
    b, _, hq, _ = q.shape
    kv = kp.shape[2]
    jargs = [jnp.asarray(a) for a in (q, kp, vp, pt, lens)]
    kern = jax.jit(functools.partial(jax_paged, window=window))(*jargs)
    ref = jax.jit(functools.partial(jpaged_ref, window=window))(
        jargs[0].reshape(b, kv, group, d), *jargs[1:])
    plain = paged_decode_attention_ref(
        torch.from_numpy(q).reshape(b, kv, group, d),
        *(torch.from_numpy(a) for a in (kp, vp, pt, lens)), window=window)
    got = plain.reshape(b, 1, hq, d).numpy()
    np.testing.assert_allclose(got, np.asarray(kern), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(ref).reshape(got.shape),
                               rtol=0, atol=1e-6)


def _flat(a):      # [B, S, H, D] -> [B*H, S, D], the JAX kernel's layout
    b, s, h, d = a.shape
    return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(b * h, s, d)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("d,kv", [(80, 2), (256, 1)])
def test_plain_flash_matches_jax_kernel(d, kv, window):
    b, s, hq = 1, 64, kv * 2
    r = np.random.default_rng(d + window)
    q, k, v = (r.standard_normal((b, s, h, d)).astype(np.float32)
               for h in (hq, kv, kv))
    out = flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                              causal=True, window=window).numpy()
    kern = jax_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                     window=window, block_q=32, block_k=32)
    g = hq // kv
    ref = jflash_ref(_flat(q), _flat(np.repeat(k, g, axis=2)),
                     _flat(np.repeat(v, g, axis=2)), causal=True,
                     window=window)
    ref = np.asarray(ref).reshape(b, hq, s, d).transpose(0, 2, 1, 3)
    for want in (np.asarray(kern), ref):
        np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)
