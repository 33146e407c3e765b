"""``Engine.cancel`` from every stage: the port's engine against the JAX
``Engine`` on the same cancel schedule, on reduced moe-gpt3-s (capacity
factor 8.0, so no token is dropped) with the same converted weights, each
scenario of ``tests/test_cancel.py`` with the prefix cache on and off.

Both engines step in lockstep; the victim is picked on the port when it
reaches its stage (queued, mid-chunk prefill, decoding, preempted by
recompute or by offload), and must be in the same stage on the JAX side
at the same step. After the cancels both drain, and they must agree on
every request's tokens, ``cancelled_by_stage``, the ``on_done`` calls
and the prefix stats; ``check_integrity()`` holds on both; the victim's
slot is back at once, its pages (and host pages) released; the survivors'
tokens equal a run without the cancels; cancelling a finished request
returns False.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.serve import Engine as JaxEngine
from repro.serve import EngineOptions as JaxOptions
from repro.serve import RequestState as JaxState
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.serve import Engine, EngineOptions, RequestState

from test_torch_engine_preempt import _cfg, _np_params

PROMPT_LENS = (13, 29, 7, 21, 5)
MAX_NEW = (6, 4, 8, 5, 7)
OPTS = dict(page_size=4, max_slots=3, max_seq_len=64, chunk=16,
            min_bucket=8, adaptive=False, attn_kernel="gather")
STAGES = ("queued", "prefill", "prefill_publishes", "decode",
          "preempted_recompute", "preempted_offload", "done")


@pytest.fixture(scope="module")
def setup():
    """Weights, prompts, the JAX engines' compiled steps (shared by every
    JAX engine of the file) and the tokens of a run without cancels."""
    cfg = _cfg(jax_config)
    params_np = _np_params(cfg, 0)
    rng = np.random.Generator(np.random.Philox(key=7))
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in PROMPT_LENS]
    out = dict(cfg=cfg, params_np=params_np, prompts=prompts,
               params=jax.tree_util.tree_map(jnp.asarray, params_np),
               compiled={})
    eng = _jax(out, "off")
    reqs = _submit(eng, prompts)
    eng.run_until_idle()
    out["golden"] = [list(r.output) for r in reqs]
    return out


def _jax(setup, prefix, **over):
    eng = JaxEngine(setup["cfg"], setup["params"], options=JaxOptions(
        prefix_cache=prefix, **dict(OPTS, **over)))
    key = over.get("num_pages", 0)
    if key in setup["compiled"]:
        eng._decode_fn, eng._prefill_fns = setup["compiled"][key]
    setup["compiled"][key] = eng._decode_fn, eng._prefill_fns
    return eng


def _port(setup, prefix, **over):
    params = convert.from_jax(setup["params_np"], device="cpu")
    return Engine(_cfg(get_config), params, options=EngineOptions(
        device="cpu", prefix_cache=prefix, **dict(OPTS, **over)))


def _submit(eng, prompts, idx=None, done=None):
    idx = range(len(prompts)) if idx is None else idx
    return [eng.submit(prompts[i], max_new_tokens=MAX_NEW[i], arrival_s=0.0,
                       on_done=None if done is None else
                       (lambda r: done.append(r.rid)))
            for i in idx]


class Pair:
    """A port engine and a JAX engine driven with the same calls."""

    def __init__(self, setup, prefix, **over):
        self.t, self.j = _port(setup, prefix, **over), _jax(setup, prefix,
                                                            **over)
        self.done = {"t": [], "j": []}
        self.reqs = {"t": [], "j": []}

    def submit(self, prompts, idx):
        self.reqs["t"] += _submit(self.t, prompts, idx, self.done["t"])
        self.reqs["j"] += _submit(self.j, prompts, idx, self.done["j"])

    def step_until(self, pred, limit=500):
        """Step both until ``pred(engine, reqs)`` picks a victim index on
        the port; the JAX side must pick the same one."""
        for _ in range(limit):
            self.t.step()
            self.j.step()
            got = pred(self.t, self.reqs["t"])
            if got is not None:
                assert pred(self.j, self.reqs["j"]) == got
                return got
        raise AssertionError("the stage was never reached")

    def cancel(self, i):
        t, j = self.reqs["t"][i], self.reqs["j"][i]
        stage = t.state.value
        assert j.state.value == stage
        slot = t.slot
        assert self.t.cancel(t) and self.j.cancel(j)
        assert t.state == RequestState.CANCELLED
        assert j.state == JaxState.CANCELLED
        assert t.finish_reason == "cancelled" and t.slot == -1
        assert slot not in self.t.scheduler.running
        assert slot not in self.t.scheduler._prefilling
        self.t.kv.check_integrity()
        self.j.kv.check_integrity()
        return stage

    def drain(self):
        self.t.run_until_idle()
        self.j.run_until_idle()
        for eng in (self.t, self.j):
            eng.kv.check_integrity()
            assert not any(eng.kv._slot_pages), "pages leaked"
            assert eng.kv.offloaded_count == 0 and eng.kv.host_bytes == 0
        tokens = [list(r.output) for r in self.reqs["t"]]
        assert tokens == [list(r.output) for r in self.reqs["j"]]
        assert sorted(self.done["t"]) == sorted(self.done["j"])
        assert len(self.done["t"]) == len(set(self.done["t"])) == \
            len(self.reqs["t"])                 # on_done once a request
        ts, js = self.t.stats(), self.j.stats()
        for key in ("requests_done", "requests_cancelled",
                    "cancelled_by_stage", "prefix_hits", "prefix_hit_tokens",
                    "prefix_cow_copies", "prefix_evicted_pages",
                    "preempt_recompute", "preempt_offload"):
            assert ts[key] == js[key], key
        return tokens, ts


def _mid_prefill(eng, reqs):
    return next((i for i, r in enumerate(reqs)
                 if r.state.value == "prefill"
                 and 0 < int(eng.kv.lens[r.slot]) < len(r.prompt)), None)


def _decoding(eng, reqs):
    return next((i for i, r in enumerate(reqs)
                 if r.state.value == "decode" and r.output), None)


def _preempted(eng, reqs):
    return next((i for i, r in enumerate(reqs)
                 if r.state.value == "preempted"), None)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("prefix", ["off", "on"])
def test_cancel_matches_jax(setup, prefix, stage):
    prompts, golden = setup["prompts"], setup["golden"]
    over = {}
    if stage.startswith("preempted"):
        # pool pressure, so requests wait in PREEMPTED for the cancel
        over = dict(num_pages=12, preempt=stage.split("_")[1])
    pair = Pair(setup, prefix, **over)
    victims = []
    if stage == "prefill_publishes":
        long_i = PROMPT_LENS.index(29)          # 2 chunks of 16
        pair.submit(prompts, [long_i])
        pair.step_until(lambda e, rs: 0 if int(e.kv.lens[rs[0].slot])
                        >= e.kv.page_size else None)
        assert pair.cancel(0) == "prefill"
        pair.submit(prompts, [long_i])
        tokens, stats = pair.drain()
        assert tokens[1] == golden[long_i]
        assert stats["cancelled_by_stage"] == {"prefill": 1}
        # the cancelled prefill's full pages were published on the way out
        assert (stats["prefix_hits"] >= 1) == (prefix == "on")
        return
    pair.submit(prompts, range(len(prompts)))
    if stage == "queued":
        assert pair.reqs["t"][3].state == RequestState.QUEUED
        victims.append(3)
    elif stage == "prefill":
        victims.append(pair.step_until(_mid_prefill))
    elif stage == "decode":
        victims.append(pair.step_until(_decoding))
    elif stage == "done":
        pair.drain()
        for i, (t, j) in enumerate(zip(pair.reqs["t"], pair.reqs["j"])):
            assert not pair.t.cancel(t) and not pair.j.cancel(j)
            assert t.state == RequestState.DONE and t.output == golden[i]
        assert pair.t.stats()["requests_cancelled"] == 0
        assert len(pair.done["t"]) == len(prompts)
        return
    else:
        victims.append(pair.step_until(_preempted))
        mode = over["preempt"]
        victim = pair.reqs["t"][victims[0]]
        assert victim.preempt_mode == mode
        held = pair.t.kv.host_bytes
        assert (held > 0) == (mode == "offload")
    want = "preempted" if stage.startswith("preempted") else stage
    for i in victims:
        assert pair.cancel(i) == want
    if stage == "preempted_offload":
        assert pair.t.kv.host_bytes < held
    tokens, stats = pair.drain()
    assert stats["cancelled_by_stage"] == {want: 1}
    for i, out in enumerate(tokens):
        if i in victims:           # a prefix of its uncancelled tokens
            assert out == golden[i][:len(out)]
        else:
            assert out == golden[i]
