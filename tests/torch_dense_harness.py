"""Shared body of ``test_torch_dense.py`` and ``test_torch_dense_mla.py``:
the JAX package's dense-cache path (``lm.prefill``, ``lm.decode_step``,
``dense_greedy_reference``) run once per variant on numpy-drawn weights,
and the checks that hold the port's counterparts to it on the CPU, fp32.

A variant is reduced moe-gpt3-s or reduced DeepSeek-V2-Lite at capacity
factor 8.0 (no token is dropped, so a batch does not change a request's
tokens), optionally with a sliding window. Each variant's JAX side takes
~10 s on the CPU, most of it the eager JAX oracle, so a test file holds
one variant.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models import kv_cache as jkv
from repro.models import lm as jlm
from repro.models import module
from repro.serve.trace import dense_greedy_reference as jax_oracle
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import kv_cache, lm
from repro_torch.serve import Engine, EngineOptions, dense_greedy_reference

BATCH, PROMPT_LEN, MAX_LEN, STEPS = 2, 13, 24, 8
# the JAX oracle decodes eagerly (~1 s a token here), so it runs one
# prompt; the port's engine is held to the port's oracle on all three
ORACLE_PROMPTS, ORACLE_NEW, JAX_ORACLE_NEW = (11, 6, 9), 10, 6
LOGITS_TOL, CACHE_TOL = 1e-4, 1e-5
ENGINE_OPTS = dict(page_size=4, max_slots=2, max_seq_len=32, chunk=16,
                   min_bucket=8, adaptive=False)


def config(get, arch: str, window: int = 0):
    cfg = get(arch).reduced()
    cfg = dataclasses.replace(
        cfg, compute_dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    if window:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, window=window))
    return cfg


def np_params(cfg, seed):
    """Weights for the JAX spec tree drawn with numpy at the JAX
    initializers' scales (no per-leaf JAX compile)."""
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


def _np_cache(cache):
    return jax.tree_util.tree_map(np.asarray, cache)


def reference(arch: str, window: int = 0) -> dict:
    """The JAX side of one variant: prefill logits and cache, ``STEPS``
    jitted decode steps fed their own greedy tokens (each step's logits,
    the cache after the last), ``cache_bytes`` and the oracle's tokens."""
    cfg = config(jax_config, arch, window)
    params_np = np_params(cfg, 0)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(BATCH, PROMPT_LEN),
                        dtype=np.int32)
    logits, cache = jlm.prefill(params, {"tokens": toks}, cfg,
                                max_len=MAX_LEN, dtype=jnp.float32)
    out = {"arch": arch, "window": window, "params": params_np,
           "tokens": toks, "prefill": np.asarray(logits),
           "prefill_cache": _np_cache(cache),
           "cache_bytes": jkv.cache_bytes(cache)}
    step = jax.jit(lambda p, c, t: jlm.decode_step(p, c, t, cfg))
    feed = np.asarray(jnp.argmax(logits[:, -1], -1))[:, None].astype(
        np.int32)
    feeds, steps = [], []
    for _ in range(STEPS):
        feeds.append(feed)
        lg, cache = step(params, cache, feed)
        steps.append(np.asarray(lg))
        feed = np.asarray(jnp.argmax(lg, -1))[:, None].astype(np.int32)
    out.update(feeds=feeds, steps=steps, decode_cache=_np_cache(cache))
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in ORACLE_PROMPTS]
    out["prompts"] = prompts
    out["oracle"] = jax_oracle(params, cfg, prompts[0], JAX_ORACLE_NEW)
    return out


def port(ref):
    """(cfg, params) of the port for a reference's variant, on the CPU."""
    cfg = config(get_config, ref["arch"], ref["window"])
    return cfg, convert.from_jax(ref["params"], device="cpu")


def _long(x):
    return torch.from_numpy(np.asarray(x)).long()


def check_cache(got: dict, want: dict) -> None:
    """The port's per-period cache list against JAX's stacked tree."""
    assert got["pos"] == int(want["pos"])
    for lk, layer in want["layers"].items():
        for name, stacked in layer.items():
            mine = [period[lk][name] for period in got["layers"]]
            if name == "len":
                assert mine == [int(x) for x in stacked]
                continue
            mine = torch.stack(mine).numpy()
            assert mine.shape == stacked.shape, (name, mine.shape)
            np.testing.assert_allclose(mine, stacked, rtol=0,
                                       atol=CACHE_TOL)


def check_prefill(ref) -> None:
    cfg, params = port(ref)
    with torch.no_grad():
        logits, cache = lm.prefill(params, _long(ref["tokens"]), cfg,
                                   max_len=MAX_LEN, dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), ref["prefill"], rtol=0,
                               atol=LOGITS_TOL)
    check_cache(cache, ref["prefill_cache"])
    assert kv_cache.cache_bytes(cache) == ref["cache_bytes"]


def check_decode(ref) -> None:
    cfg, params = port(ref)
    with torch.no_grad():
        _, cache = lm.prefill(params, _long(ref["tokens"]), cfg,
                              max_len=MAX_LEN, dtype=torch.float32)
        for feed, want in zip(ref["feeds"], ref["steps"]):
            logits, cache = lm.decode_step(params, cache, _long(feed), cfg)
            np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                                       atol=LOGITS_TOL)
    check_cache(cache, ref["decode_cache"])


def check_oracle(ref) -> None:
    cfg, params = port(ref)
    got = dense_greedy_reference(params, cfg, ref["prompts"][0],
                                 JAX_ORACLE_NEW)
    assert got == ref["oracle"]


def check_engine(ref) -> None:
    """The port's paged, batched engine against the port's oracle."""
    cfg, params = port(ref)
    eng = Engine(cfg, params, options=EngineOptions(device="cpu",
                                                    **ENGINE_OPTS))
    reqs = [eng.submit(p, max_new_tokens=ORACLE_NEW, arrival_s=0.0)
            for p in ref["prompts"]]
    eng.run_until_idle()
    want = [dense_greedy_reference(params, cfg, p, ORACLE_NEW)
            for p in ref["prompts"]]
    assert [list(r.output) for r in reqs] == want
