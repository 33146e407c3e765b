"""The prefix cache through the whole engine: the port's ``Engine`` with
``prefix_cache="on"`` against the JAX ``Engine`` with the same option,
on reduced moe-gpt3-s (K/V pools) and reduced DeepSeek-V2-Lite (MLA
latent pools), with the same converted weights.

The traffic is ``_waves`` of ``tests/test_prefix_cache.py``: a cold
wave publishes a 16-token prefix, a warm wave resubmits it whole (a
mid-page hit, so a copy-on-write) and continues it. The capacity factor
is 8.0, so no token is dropped however a hit changes the chunks and the
decode batches; greedy tokens must then be equal with the cache on and
off, and equal to the JAX engine's, and every ``prefix_*`` stat must
equal the JAX engine's. The forced preemption storm
(``storm_every=3``) runs under ``"auto"`` (offload allowed, both modes
chosen by cost) and under ``"offload"``, where victims share pages with
the survivors: tokens, preemptions by mode and the prefix stats equal
the JAX engine's storm, and the tokens equal the storm's with the cache
off. Each JAX engine is built once a model; the storm engines take the
first moe-gpt3-s engine's compiled steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.core.types import GPU_A100 as JAX_A100
from repro.serve import Engine as JaxEngine
from repro.serve import EngineOptions as JaxOptions
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.types import GPU_A100
from repro_torch.serve import Engine, EngineOptions

import test_torch_engine_mla as mla
import test_torch_engine_preempt as gpt
from test_prefix_cache import _waves

ARCHS = {"moe-gpt3-s": gpt, "deepseek-v2-lite-16b": mla}
OPTS = dict(page_size=4, max_slots=4, max_seq_len=64, chunk=16,
            min_bucket=8, adaptive=False)
STORM = dict(storm_every=3, hw_a100=True, preempt_mfu=0.03,
             allow_offload=True)
MAX_NEW = 6
PREFIX_STATS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
                "prefix_hit_rate", "prefix_cow_copies", "prefix_cow_bytes",
                "prefix_evicted_pages", "prefix_cached_pages",
                "prefix_shared_pages")
COUNTS = ("preempt_recompute", "preempt_offload", "resumes",
          "swap_out_bytes", "swap_in_bytes", "requests_done")


def _options(make, a100, prefix, preempt="auto", **extra):
    if extra.pop("hw_a100", False):
        extra["hw"] = a100
    return make(prefix_cache=prefix, preempt=preempt, **extra, **OPTS)


def _serve(eng, waves):
    outs = []
    for wave in waves:
        reqs = [eng.submit(np.asarray(p, np.int32), max_new_tokens=MAX_NEW,
                           arrival_s=0.0) for p in wave]
        eng.run_until_idle()
        outs.extend(list(r.output) for r in reqs)
    eng.kv.check_integrity()
    return outs


def _jax_run(cfg, params, waves, compiled=None, **opts):
    eng = JaxEngine(cfg, params, options=_options(
        lambda **kw: JaxOptions(attn_kernel="gather", **kw), JAX_A100, "on",
        **opts))
    if compiled is not None:
        eng._decode_fn, eng._prefill_fns = compiled
    out = _serve(eng, waves)
    return dict(tokens=out, stats=eng.stats()), (eng._decode_fn,
                                                 eng._prefill_fns)


@pytest.fixture(scope="module")
def reference():
    """Per model, the JAX engine's tokens and stats on the waves with the
    cache on; for moe-gpt3-s also its storms under "auto" and
    "offload"."""
    out = {}
    for arch, mod in ARCHS.items():
        cfg = mod._cfg(jax_config)
        params_np = mod._np_params(cfg, 0)
        params = jax.tree_util.tree_map(jnp.asarray, params_np)
        waves = _waves(cfg.vocab_size)
        out[arch], compiled = _jax_run(cfg, params, waves)
        out[arch]["params"], out[arch]["waves"] = params_np, waves
        if arch == "moe-gpt3-s":
            storm_waves = _waves(cfg.vocab_size, seed=11)
            out["storm_waves"] = storm_waves
            for preempt in ("auto", "offload"):
                out["storm", preempt], _ = _jax_run(
                    cfg, params, storm_waves, compiled, preempt=preempt,
                    **STORM)
    return out


def _port_run(reference, arch, waves, prefix, **opts):
    mod = ARCHS[arch]
    params = convert.from_jax(reference[arch]["params"], device="cpu")
    eng = Engine(mod._cfg(get_config), params, options=_options(
        lambda **kw: EngineOptions(device="cpu", attn_kernel="gather", **kw),
        GPU_A100, prefix, **opts))
    return _serve(eng, waves), eng.stats()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefix_on_matches_jax_and_off(reference, arch):
    ref = reference[arch]
    on, stats = _port_run(reference, arch, ref["waves"], "on")
    off, off_stats = _port_run(reference, arch, ref["waves"], "off")
    assert on == ref["tokens"]
    assert off == on
    assert {k: stats[k] for k in PREFIX_STATS} == \
        {k: ref["stats"][k] for k in PREFIX_STATS}
    assert stats["prefix_hits"] >= 3 and stats["prefix_hit_tokens"] >= 30
    assert stats["prefix_cow_copies"] >= 1
    assert off_stats["prefix_hits"] == off_stats["prefix_cow_copies"] == 0
    # the warm wave skips its cached prefix: fewer tokens prefilled
    assert stats["prefill_tokens"] + stats["prefix_hit_tokens"] == \
        off_stats["prefill_tokens"]


@pytest.mark.parametrize("preempt", ["auto", "offload"])
def test_preemption_storm_matches_jax(reference, preempt):
    ref = reference["storm", preempt]
    waves = reference["storm_waves"]
    on, stats = _port_run(reference, "moe-gpt3-s", waves, "on",
                          preempt=preempt, **STORM)
    off, _ = _port_run(reference, "moe-gpt3-s", waves, "off",
                       preempt=preempt, **STORM)
    assert on == ref["tokens"] == off
    assert {k: stats[k] for k in COUNTS + PREFIX_STATS} == \
        {k: ref["stats"][k] for k in COUNTS + PREFIX_STATS}
    assert stats["preempt_recompute"] + stats["preempt_offload"] >= 2
    if preempt == "auto":
        assert stats["preempt_recompute"] >= 1 and \
            stats["preempt_offload"] >= 1
