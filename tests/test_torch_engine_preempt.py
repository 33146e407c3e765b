"""The slice as a whole through recompute preemption: the port's
``Engine`` against the JAX ``Engine`` on reduced moe-gpt3-s, with the
same converted weights and a page pool small enough that decode growth
preempts, which must happen on both sides. Greedy tokens must be
exactly equal. Both engines pad prefill chunks to the same power-of-two
buckets and feed inactive decode slots token 0; those tokens take expert
capacity, so they must match for the routing, and hence the tokens, to
match. ``test_torch_engine.py`` covers full-budget admission.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro.models import module
from repro.serve import Engine as JaxEngine
from repro.serve import EngineOptions as JaxOptions
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.serve import Engine, EngineOptions

PROMPT_LENS = (13, 7, 10)
MAX_NEW = 12
OPTS = dict(page_size=4, max_slots=2, max_seq_len=32, chunk=16,
            min_bucket=8)
SMALL_POOL = 10          # sink + 9 pages: decode growth must preempt


def _cfg(get):
    cfg = get("moe-gpt3-s").reduced()
    return dataclasses.replace(
        cfg, compute_dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _np_params(cfg, seed):
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


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=n, dtype=np.int32)
            for n in PROMPT_LENS]


def _run(engine, prompts):
    reqs = [engine.submit(p, max_new_tokens=MAX_NEW, arrival_s=0.0)
            for p in prompts]
    engine.run_until_idle()
    return [list(r.output) for r in reqs]


@pytest.fixture(scope="module")
def reference():
    """JAX engine tokens (preempt='recompute'), built once."""
    cfg = _cfg(jax_config)
    params_np = _np_params(cfg, 0)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    prompts = _prompts(cfg.vocab_size)
    eng = JaxEngine(cfg, params, options=JaxOptions(
        attn_kernel="gather", adaptive=False, preempt='recompute',
        num_pages=SMALL_POOL, **OPTS))
    return {"params": params_np, "prompts": prompts,
            "tokens": _run(eng, prompts),
            "preempts": eng.stats()["preempt_recompute"]}


def _port_engine(reference, preempt, pages, attn_kernel="auto"):
    params = convert.from_jax(reference["params"], device="cpu")
    return Engine(_cfg(get_config), params, options=EngineOptions(
        preempt=preempt, num_pages=pages, device="cpu",
        attn_kernel=attn_kernel, adaptive=False, **OPTS))


def test_greedy_tokens_equal_jax_engine_through_preemption(reference):
    eng = _port_engine(reference, "recompute", SMALL_POOL)
    got = _run(eng, reference["prompts"])
    stats = eng.stats()
    assert got == reference["tokens"]
    assert all(len(t) == MAX_NEW for t in got)
    assert reference["preempts"] >= 1 and stats["preempt_recompute"] >= 1
    assert stats["resumes"] == stats["preempt_recompute"]


def test_kernel_option_on_cpu_gives_the_same_tokens(reference):
    """``attn_kernel="kernel"`` on CPU tensors takes the kernel's plain
    version; the tokens are the gather path's."""
    eng = _port_engine(reference, "recompute", SMALL_POOL, "kernel")
    assert eng.attn_kernel == "kernel"
    assert _run(eng, reference["prompts"]) == reference["tokens"]
