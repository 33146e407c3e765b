"""The slice as a whole: the port's continuous-batching ``Engine`` against
the JAX ``Engine`` on reduced moe-gpt3-s, with the same converted weights
and full-budget admission (``preempt="never"``).

Greedy tokens must be exactly equal. The JAX engine runs its gather
decode path with adaptive resolution off, so both engines prefill with
the config's ``num_partitions``, pad chunks to the same power-of-two
buckets and feed inactive decode slots token 0 — the pad and inactive
tokens take expert capacity, so these must match for the routing, and
hence the tokens, to match. Within the port, a sampled request must emit
the same tokens alone as batched with others (and through preemption).
``test_torch_engine_preempt.py`` covers recompute preemption.
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
from repro_torch.serve import Engine, EngineOptions, SamplingParams

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


def _run(engine, prompts, sampling=None):
    reqs = [engine.submit(p, max_new_tokens=MAX_NEW, arrival_s=0.0,
                          **({"sampling": sampling[i]} if sampling else {}))
            for i, p in enumerate(prompts)]
    engine.run_until_idle()
    return [list(r.output) for r in reqs]


@pytest.fixture(scope="module")
def reference():
    """JAX engine tokens (preempt='never'), built once."""
    cfg = _cfg(jax_config)
    params_np = _np_params(cfg, 0)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    prompts = _prompts(cfg.vocab_size)
    eng = JaxEngine(cfg, params, options=JaxOptions(
        attn_kernel="gather", adaptive=False, preempt='never',
        num_pages=0, **OPTS))
    return {"params": params_np, "prompts": prompts,
            "tokens": _run(eng, prompts),
            "preempts": eng.stats()["preempt_recompute"]}


def _port_engine(reference, preempt, pages, attn_kernel="auto"):
    params = convert.from_jax(reference["params"], device="cpu")
    return Engine(_cfg(get_config), params, options=EngineOptions(
        preempt=preempt, num_pages=pages, device="cpu",
        attn_kernel=attn_kernel, adaptive=False, **OPTS))


def test_greedy_tokens_equal_jax_engine(reference):
    eng = _port_engine(reference, "never", 0)
    got = _run(eng, reference["prompts"])
    stats = eng.stats()
    assert got == reference["tokens"]
    assert all(len(t) == MAX_NEW for t in got)
    assert stats["attn_kernel"] == "gather"          # auto on the CPU
    assert reference["preempts"] == 0 and stats["preempt_recompute"] == 0


def test_sampled_request_is_independent_of_batching(reference):
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=5)
    prompts = reference["prompts"]
    alone = _port_engine(reference, "never", 0)
    solo = _run(alone, prompts[1:2], sampling=[sp])[0]
    batched = _port_engine(reference, "recompute", SMALL_POOL)
    mixed = _run(batched, prompts,
                 sampling=[SamplingParams(), sp,
                           SamplingParams(temperature=1.0, seed=9)])
    assert batched.stats()["preempt_recompute"] >= 1
    assert mixed[1] == solo
    assert len(solo) == MAX_NEW


def test_engine_rejects_params_on_another_device(reference):
    params = convert.from_jax(reference["params"], device="meta")
    with pytest.raises(ValueError, match="engine's device"):
        Engine(_cfg(get_config), params,
               options=EngineOptions(device="cpu", **OPTS))


def test_launcher_serves_seeded_requests_on_the_cpu():
    """The launcher's command line, as documented, at the reduced size:
    every request finishes with its budget."""
    stats = launcher.main(["--engine", "--arch", "moe-gpt3-s", "--reduced",
                           "--device", "cpu", "--requests", "3",
                           "--prompt-len", "5:20", "--gen", "4",
                           "--seed", "1"])
    assert stats["requests_done"] == 3
    assert stats["tokens_generated"] == 12
    assert stats["attn_kernel"] == "gather"
