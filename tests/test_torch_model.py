"""The reduced moe-gpt3-s LM over paged KV: the port against the JAX
package, with the same converted weights.

Weights go JAX ``lm.init`` -> numpy -> ``repro_torch.convert`` -> port.
Two sequences are chunk-prefilled (bucket-padded, pad writes masked into
the sink) and then decoded together with one inactive slot. Logits are
held within atol 1e-4 (values of order 1 through 4 layers whose sums run
in another order) and the pools within 1e-5. ``capacity_factor=8`` keeps
expert capacity from dropping tokens, as in ``test_paged_attention.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro.models import module
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import lm as tlm

PS, NP = 4, 6
PAGES = 1 + 3 * NP


def np_params(cfg, seed):
    """Random weights for the JAX spec tree, drawn with numpy (fast: no
    per-leaf JAX compile), at the JAX initializers' scales."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if s.init == "zeros":
            return np.zeros(s.shape, np.float32)
        if s.init == "ones":
            return np.ones(s.shape, np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        scale = s.scale or (1.0 if s.init == "embed" else fan_in ** -0.5)
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map(draw, jlm.specs_tree(cfg),
                                  is_leaf=module.is_spec)


def _cfg(get):
    cfg = get("moe-gpt3-s").reduced()
    return dataclasses.replace(
        cfg, compute_dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX reference, built once: params, two prefills, one decode."""
    cfg = _cfg(jax_config)
    params = jax.tree_util.tree_map(jnp.asarray, np_params(cfg, 0))
    rng = np.random.default_rng(0)
    pt = np.zeros((3, NP), np.int32)
    pt[0, :4] = [1, 2, 3, 4]
    pt[1, :3] = [7, 8, 9]
    chunks = [(0, rng.integers(0, 256, 11)), (1, rng.integers(0, 256, 7))]
    pools = jlm.init_paged_cache(cfg, PAGES, PS, dtype=jnp.float32)
    prefill = jax.jit(functools.partial(jlm.prefill_chunk_paged, cfg=cfg))
    lens = np.zeros((3,), np.int32)
    prefill_logits = []
    for slot, toks in chunks:
        bucket = 16
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(toks)] = toks
        logits, pools = prefill(params, pools, jnp.asarray(pt[slot:slot + 1]),
                                jnp.asarray(lens[slot:slot + 1]),
                                jnp.asarray(padded),
                                jnp.asarray(len(toks), jnp.int32))
        prefill_logits.append(np.asarray(logits))
        lens[slot] += len(toks)
    dec_tokens = np.array([[5], [9], [0]], np.int32)
    active = np.array([True, True, False])
    decode = jax.jit(functools.partial(jlm.decode_step_paged, cfg=cfg))
    dec_logits, pools = decode(params, pools, jnp.asarray(pt),
                               jnp.asarray(lens), jnp.asarray(dec_tokens),
                               active=jnp.asarray(active))
    return dict(params=jax.tree_util.tree_map(np.asarray, params), pt=pt,
                chunks=chunks, prefill_logits=prefill_logits,
                dec_tokens=dec_tokens, active=active,
                dec_logits=np.asarray(dec_logits),
                pools=jax.tree_util.tree_map(np.asarray, pools))


@pytest.mark.parametrize("attn_kernel", ["gather", "kernel", None])
def test_prefill_then_decode_matches_jax(jax_run, attn_kernel):
    """``None`` resolves by device: the gather path for CPU tensors."""
    cfg = _cfg(get_config)
    params = convert.from_jax(jax_run["params"], device="cpu")
    pt = jax_run["pt"]
    pools = tlm.init_paged_cache(cfg, PAGES, PS, dtype=torch.float32)
    lens = np.zeros((3,), np.int32)
    for (slot, toks), want in zip(jax_run["chunks"],
                                  jax_run["prefill_logits"]):
        bucket = 16
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(toks)] = toks
        logits, pools = tlm.prefill_chunk_paged(
            params, pools, torch.from_numpy(pt[slot:slot + 1]),
            torch.from_numpy(lens[slot:slot + 1].copy()),
            torch.from_numpy(padded), len(toks), cfg)
        np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=1e-4)
        lens[slot] += len(toks)
    logits, pools = tlm.decode_step_paged(
        params, pools, torch.from_numpy(pt), torch.from_numpy(lens),
        torch.from_numpy(jax_run["dec_tokens"].astype(np.int64)), cfg,
        active=torch.from_numpy(jax_run["active"]),
        attn_kernel=attn_kernel)
    # the inactive slot's row reads sink garbage: only live rows compare
    np.testing.assert_allclose(logits.numpy()[:2],
                               jax_run["dec_logits"][:2], rtol=0, atol=1e-4)
    for p, period in enumerate(pools):
        for layer, leaves in period.items():
            for name, pool in leaves.items():
                want = jax_run["pools"][layer][name][p]
                # page 0 is the sink: it takes masked writes in an
                # undefined order
                np.testing.assert_allclose(pool.numpy()[1:], want[1:],
                                           rtol=0, atol=1e-5)


@pytest.mark.parametrize("attn_kernel", ["auto", "pallas", ""])
def test_decode_rejects_an_unknown_attn_kernel(jax_run, attn_kernel):
    """Only ``"kernel"`` and ``"gather"`` (or None) pick a decode path;
    anything else raises instead of quietly taking the gather path."""
    cfg = _cfg(get_config)
    params = convert.from_jax(jax_run["params"], device="cpu")
    pools = tlm.init_paged_cache(cfg, PAGES, PS, dtype=torch.float32)
    with pytest.raises(ValueError, match="attn_kernel"):
        tlm.decode_step_paged(
            params, pools, torch.from_numpy(jax_run["pt"]),
            torch.ones((3,), dtype=torch.int32),
            torch.zeros((3, 1), dtype=torch.int64), cfg,
            attn_kernel=attn_kernel)


def test_convert_defaults_to_cuda_and_raises_without_it(jax_run,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.from_jax(jax_run["params"])


def test_converted_tree_has_the_port_layout(jax_run):
    cfg = _cfg(get_config)
    params = convert.from_jax(jax_run["params"], device="cpu")
    assert len(params["periods"]) == cfg.num_periods
    spec = tlm.specs_tree(cfg)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)
    assert shapes(params) == shapes(spec)
    assert sum(t.numel() for t in _leaves(params)) == \
        tlm.count_params(cfg)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_port_init_is_seeded_and_keeps_the_router_fp32():
    cfg = dataclasses.replace(_cfg(get_config), compute_dtype="bfloat16")
    a = tlm.init(cfg, 3, device="cpu")
    b = tlm.init(cfg, 3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    cp = tlm.compute_params(a, cfg)
    moe = cp["periods"][0]["l1"]["moe"]
    assert moe["router"]["w_gate"].dtype == torch.float32
    assert moe["experts"]["w_up"].dtype == torch.bfloat16
    assert cp["embed"]["tok"].dtype == torch.bfloat16
