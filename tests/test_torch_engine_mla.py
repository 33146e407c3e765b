"""The slice as a whole: the port's ``Engine`` against the JAX ``Engine``
on reduced DeepSeek-V2-Lite (MLA latent pools, RoPE, top-2 routing over 4
experts with one shared expert), with the same converted weights, with
full-budget admission and through recompute preemption.

Greedy tokens must be exactly equal. Both engines run their gather
decode path with adaptive resolution off; on the CPU the port's
``attn_kernel="kernel"`` takes the MLA kernel's plain version and must
give the same tokens. The launcher serves the same architecture at the
reduced size.
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
from repro_torch.launch import serve as launcher
from repro_torch.serve import Engine, EngineOptions

ARCH = "deepseek-v2-lite-16b"
PROMPT_LENS = (13, 7, 10)
MAX_NEW = 12
OPTS = dict(page_size=4, max_slots=2, max_seq_len=32, chunk=16,
            min_bucket=8)
SMALL_POOL = 10          # sink + 9 pages: decode growth must preempt


def _cfg(get):
    cfg = get(ARCH).reduced()
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


def _run(engine, prompts):
    reqs = [engine.submit(p, max_new_tokens=MAX_NEW, arrival_s=0.0)
            for p in prompts]
    engine.run_until_idle()
    return [list(r.output) for r in reqs]


@pytest.fixture(scope="module")
def reference():
    """JAX engine tokens with full-budget admission and through
    preemption, built once."""
    cfg = _cfg(jax_config)
    params_np = _np_params(cfg, 0)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in PROMPT_LENS]
    out = {"params": params_np, "prompts": prompts}
    for preempt, pages in (("never", 0), ("recompute", SMALL_POOL)):
        eng = JaxEngine(cfg, params, options=JaxOptions(
            attn_kernel="gather", adaptive=False, preempt=preempt,
            num_pages=pages, **OPTS))
        out[preempt] = _run(eng, prompts)
        out[preempt + "_preempts"] = eng.stats()["preempt_recompute"]
    return out


def _port_engine(reference, preempt, pages, attn_kernel="auto"):
    params = convert.from_jax(reference["params"], device="cpu")
    return Engine(_cfg(get_config), params, options=EngineOptions(
        preempt=preempt, num_pages=pages, device="cpu",
        attn_kernel=attn_kernel, adaptive=False, **OPTS))


@pytest.mark.parametrize("attn_kernel", ["auto", "kernel"])
def test_greedy_tokens_equal_jax_engine(reference, attn_kernel):
    eng = _port_engine(reference, "never", 0, attn_kernel)
    got = _run(eng, reference["prompts"])
    assert got == reference["never"]
    assert all(len(t) == MAX_NEW for t in got)
    assert reference["never_preempts"] == 0
    assert eng.stats()["preempt_recompute"] == 0


def test_greedy_tokens_equal_jax_engine_through_preemption(reference):
    eng = _port_engine(reference, "recompute", SMALL_POOL)
    got = _run(eng, reference["prompts"])
    stats = eng.stats()
    assert got == reference["recompute"]
    assert reference["recompute_preempts"] >= 1
    assert stats["preempt_recompute"] >= 1
    assert stats["resumes"] == stats["preempt_recompute"]


def test_launcher_serves_deepseek_on_the_cpu():
    stats = launcher.main(["--engine", "--arch", ARCH, "--reduced",
                           "--device", "cpu", "--requests", "3",
                           "--prompt-len", "5:20", "--gen", "4",
                           "--seed", "1"])
    assert stats["arch"] == ARCH + "-reduced"
    assert stats["requests_done"] == 3
    assert stats["tokens_generated"] == 12
