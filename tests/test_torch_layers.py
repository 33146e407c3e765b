"""Layers and paged KV primitives: the port against the JAX package.

The same numpy inputs, made from a seed, go through each JAX function
and its counterpart in ``repro_torch`` on the CPU, in fp32. Floats are
held within rtol = atol = 1e-5: the two frameworks sum in a different
order, so bit-equality is not expected. Integer outputs (expert indices,
dispatch destinations) must be equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import kv_cache as jkv
from repro.models.layers import attention as jattn
from repro.models.layers import embedding as jemb
from repro.models.layers import ffn as jffn
from repro.models.layers import norm as jnorm
from repro_torch.configs import get_config
from repro_torch.models import kv_cache as tkv
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import embedding as temb
from repro_torch.models.layers import ffn as tffn
from repro_torch.models.layers import norm as tnorm

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(),
                               **(tol or TOL))


def _cfgs():
    return jax_config("moe-gpt3-s").reduced(), \
        get_config("moe-gpt3-s").reduced()


# ---------------------------------------------------------------------------
# norm / embedding / ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm(kind):
    r = _rng(0)
    x = r.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": r.standard_normal(64).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = r.standard_normal(64).astype(np.float32)
    _close(jnorm.apply(_j(p), jnp.asarray(x), kind),
           tnorm.apply(_t(p), torch.from_numpy(x), kind))


def test_embedding_and_logits():
    jcfg, tcfg = _cfgs()
    r = _rng(1)
    p = {"tok": r.standard_normal((256, 64)).astype(np.float32),
         "pos": r.standard_normal((4096, 64)).astype(np.float32),
         "head": r.standard_normal((64, 256)).astype(np.float32)}
    tok = r.integers(0, 256, (2, 7))
    pos = r.integers(0, 4096, (2, 7))
    xj = jemb.embed(_j(p), jnp.asarray(tok), jcfg, positions=jnp.asarray(pos),
                    dtype=jnp.float32)
    xt = temb.embed(_t(p), torch.from_numpy(tok), tcfg,
                    positions=torch.from_numpy(pos), dtype=torch.float32)
    _close(xj, xt)
    _close(jemb.logits(_j(p), xj, jcfg), temb.logits(_t(p), xt, tcfg))
    # tied head (gemma-style scaling)
    jt = dataclasses.replace(jcfg, tie_embeddings=True)
    tt = dataclasses.replace(tcfg, tie_embeddings=True)
    xj = jemb.embed(_j(p), jnp.asarray(tok), jt, dtype=jnp.float32)
    xt = temb.embed(_t(p), torch.from_numpy(tok), tt, dtype=torch.float32)
    _close(xj, xt)
    _close(jemb.logits(_j(p), xj, jt), temb.logits(_t(p), xt, tt))


@pytest.mark.parametrize("gated,act", [(False, "gelu"), (True, "silu")])
def test_ffn(gated, act):
    r = _rng(2)
    p = {"w_up": r.standard_normal((64, 96)).astype(np.float32) * 0.1,
         "w_down": r.standard_normal((96, 64)).astype(np.float32) * 0.1}
    if gated:
        p["w_gate"] = r.standard_normal((64, 96)).astype(np.float32) * 0.1
    x = r.standard_normal((2, 5, 64)).astype(np.float32)
    _close(jffn.apply(_j(p), jnp.asarray(x), act=act, gated=gated),
           tffn.apply(_t(p), torch.from_numpy(x), act=act, gated=gated))


# ---------------------------------------------------------------------------
# paged KV primitives and attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_row_sink", [False, True])
def test_scatter_then_gather_pages(per_row_sink):
    r = _rng(3)
    ps, npg, pages = 4, 3, 8
    pool = r.standard_normal((pages, ps, 2, 8)).astype(np.float32)
    pool[0] = 3.0e4                                   # garbage sink page
    pt = np.array([[1, 2, 3], [4, 5, 0]], np.int32)   # row 1: sink tail
    pos = np.array([[0, 5, 9, 12], [1, 2, 7, 11]], np.int32)
    vals = r.standard_normal((2, 4, 2, 8)).astype(np.float32)
    valid = np.array([[1, 1, 0, 1], [1, 1, 1, 1]], bool)
    sink = np.array([0, 0], np.int32) if per_row_sink else 0
    out_j = jax.jit(jkv.scatter_pages)(
        jnp.asarray(pool), jnp.asarray(pt), jnp.asarray(pos),
        jnp.asarray(vals), jnp.asarray(valid), sink=jnp.asarray(sink))
    out_t = tkv.scatter_pages(torch.from_numpy(pool.copy()),
                              torch.from_numpy(pt), torch.from_numpy(pos),
                              torch.from_numpy(vals),
                              torch.from_numpy(valid),
                              sink=torch.from_numpy(np.asarray(sink)))
    # the sink takes several masked writes in an undefined order; every
    # real page must agree exactly
    np.testing.assert_array_equal(np.asarray(out_j)[1:], out_t.numpy()[1:])
    np.testing.assert_array_equal(
        np.asarray(jkv.gather_pages(out_j, jnp.asarray(pt)))[0],
        tkv.gather_pages(out_t, torch.from_numpy(pt)).numpy()[0])


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("q_offset,sq,sk,blocks", [
    (0, 12, 12, 512), (7, 9, 24, 512), (3, 10, 20, 4)])
def test_flash_attention_with_offset(window, q_offset, sq, sk, blocks):
    r = _rng(4)
    q = r.standard_normal((1, sq, 4, 16)).astype(np.float32)
    k = r.standard_normal((1, sk, 2, 16)).astype(np.float32)
    v = r.standard_normal((1, sk, 2, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, q_block=blocks, kv_block=blocks)
    oj = jax.jit(functools.partial(jattn.flash_attention, **kw))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=q_offset)
    ot = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               q_offset=torch.tensor(q_offset), **kw)
    _close(oj, ot)


@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention(window):
    r = _rng(5)
    q = r.standard_normal((3, 1, 4, 16)).astype(np.float32)
    k = r.standard_normal((3, 20, 2, 16)).astype(np.float32)
    v = r.standard_normal((3, 20, 2, 16)).astype(np.float32)
    lens = np.array([1, 20, 9], np.int32)
    _close(jax.jit(functools.partial(jattn.decode_attention,
                                     window=window))(
               jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               jnp.asarray(lens)),
           tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  torch.from_numpy(lens), window=window))
