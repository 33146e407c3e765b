"""Shared body of the GQA + RoPE tests (``test_torch_gqa_rope.py``,
``test_torch_engine_gqa.py``, ``test_torch_engine_gemma3.py``): the four
dense decoders at their reduced sizes (gemma3's reduction has 12 layers,
two periods of five local layers and a global one, window 32), weights
drawn with numpy at the JAX initializers' scales and carried across by
``convert.from_jax``, the JAX package's dense path and token oracle as
the reference, fp32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro.serve.trace import dense_greedy_reference as jax_oracle
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serve import Engine, EngineOptions, dense_greedy_reference
from torch_dense_harness import np_params

GQA_ARCHS = ("llama3-8b", "h2o-danube-1.8b", "gemma3-12b", "qwen1.5-110b")
BATCH, PROMPT_LEN, MAX_LEN, STEPS = 2, 40, 48, 4   # the prompt > window 32
LOGITS_TOL = 1e-4
# the engine's requests: one prompt past the window, one inside it
ORACLE_PROMPTS, ORACLE_NEW = (37, 9), 6
JAX_ORACLE_NEW = 4       # the JAX oracle decodes eagerly: the long prompt
ENGINE_OPTS = dict(page_size=4, max_slots=2, max_seq_len=48, chunk=16,
                   min_bucket=8, adaptive=False)


def configs(arch: str):
    """(JAX config, port config), both reduced."""
    return jax_config(arch).reduced(), get_config(arch).reduced()


def _long(x):
    return torch.from_numpy(np.asarray(x)).long()


def reference(arch: str, *, oracle: bool = True) -> dict:
    """The JAX side of one config: prefill logits of a ``PROMPT_LEN``
    prompt (past the window), ``STEPS`` jitted decode steps fed their own
    greedy tokens, and ``dense_greedy_reference``'s tokens for the long
    engine prompt."""
    jcfg, _ = configs(arch)
    params_np = np_params(jcfg, 0)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, size=(BATCH, PROMPT_LEN),
                        dtype=np.int32)
    logits, cache = jax.jit(lambda p, t: jlm.prefill(
        p, {"tokens": t}, jcfg, max_len=MAX_LEN, dtype=jnp.float32))(
            params, toks)
    out = {"arch": arch, "params": params_np, "tokens": toks,
           "prefill": np.asarray(logits)}
    step = jax.jit(lambda p, c, t: jlm.decode_step(p, c, t, jcfg))
    feed = np.asarray(jnp.argmax(logits[:, -1], -1))[:, None].astype(
        np.int32)
    feeds, steps = [], []
    for _ in range(STEPS):
        feeds.append(feed)
        lg, cache = step(params, cache, feed)
        steps.append(np.asarray(lg))
        feed = np.asarray(jnp.argmax(lg, -1))[:, None].astype(np.int32)
    out.update(feeds=feeds, steps=steps)
    out["prompts"] = [rng.integers(0, jcfg.vocab_size, size=n,
                                   dtype=np.int32) for n in ORACLE_PROMPTS]
    if oracle:
        out["oracle"] = jax_oracle(params, jcfg, out["prompts"][0],
                                   JAX_ORACLE_NEW)
    return out


def port(ref):
    """(cfg, params) of the port for a reference's config, on the CPU."""
    _, cfg = configs(ref["arch"])
    return cfg, convert.from_jax(ref["params"], device="cpu")


def check_logits(ref) -> None:
    """Prefill logits, then each decode step's, within ``LOGITS_TOL``."""
    cfg, params = port(ref)
    with torch.no_grad():
        logits, cache = lm.prefill(params, _long(ref["tokens"]), cfg,
                                   max_len=MAX_LEN, dtype=torch.float32)
        np.testing.assert_allclose(logits.numpy(), ref["prefill"], rtol=0,
                                   atol=LOGITS_TOL)
        for feed, want in zip(ref["feeds"], ref["steps"]):
            logits, cache = lm.decode_step(params, cache, _long(feed), cfg)
            np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                                       atol=LOGITS_TOL)


def check_engine(ref) -> None:
    """The port's paged engine: its greedy tokens equal the port's oracle
    on every prompt, and the JAX oracle's on the long one (which crosses
    the window); the port's oracle equals the JAX oracle there too."""
    cfg, params = port(ref)
    eng = Engine(cfg, params, options=EngineOptions(device="cpu",
                                                    **ENGINE_OPTS))
    reqs = [eng.submit(p, max_new_tokens=ORACLE_NEW, arrival_s=0.0)
            for p in ref["prompts"]]
    eng.run_until_idle()
    got = [list(r.output) for r in reqs]
    want = [dense_greedy_reference(params, cfg, p, ORACLE_NEW)
            for p in ref["prompts"]]
    assert got == want
    assert got[0][:JAX_ORACLE_NEW] == ref["oracle"]
    assert want[0][:JAX_ORACLE_NEW] == ref["oracle"]
