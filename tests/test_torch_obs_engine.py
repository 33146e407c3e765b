"""The port's serving telemetry against the JAX engine's, on reduced
moe-gpt3-s in fp32 (capacity factor 8.0) with the same converted
weights, both engines recording into ``Recorder(tracer=Tracer())``:

* over the same seeded preemption storms (a 12-page pool that runs dry
  under recompute; an offload storm every 4 steps with a cancel mid-run)
  every counter and gauge of ``snapshot()`` is equal, and so is each
  histogram's count. Excepted are the timings (histogram sums and
  quantiles) and ``repro_jit_traces_total``, whose port counts are:
  ``body="prefill"`` the prefill step functions built (equal to the JAX
  engine's prefill traces), and no ``body="decode"`` child on the CPU
  (a decode-graph capture happens on the card only), where the JAX
  engine traces its decode step once;
* each request's lifecycle events (``ADMIT``, ``PREFILL``, ``DECODE``
  B/E, ``PREEMPT``, ``RESUME``, ``RETIRE``, ``CANCEL``) come in the same
  order with the same args, the engine's ``engine.step`` / ``prefill``
  / ``decode`` spans and the resolver's spans too, and B/E pairs
  balance per track;
* the tracer on or off gives the same tokens, builds and captures;
* ``MetricsServer`` agrees with ``stats()``.
"""
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.obs import Recorder as JaxRecorder
from repro.obs import Tracer as JaxTracer
from repro.serve import Engine as JaxEngine
from repro.serve import EngineOptions as JaxOptions
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.obs import (PID_ENGINE, PID_REQUESTS, PID_RESOLVER,
                             MetricsServer, Recorder, Tracer)
from repro_torch.serve import Engine, EngineOptions

from test_torch_engine_preempt import _cfg, _np_params

PROMPT_LENS = (13, 29, 7, 21, 5)
MAX_NEW = (6, 4, 8, 5, 7)
OPTS = dict(page_size=4, max_slots=3, max_seq_len=64, chunk=16,
            min_bucket=8, num_pages=12, adaptive=False, attn_kernel="gather")
STORMS = {
    # the pool runs dry: decode growth preempts by recompute
    "recompute": dict(preempt="recompute"),
    # every 4th step preempts by offload; rid 3 is cancelled mid-run
    "offload": dict(preempt="offload", num_pages=0, storm_every=4),
}
CANCEL_AT = 13              # the offload storm cancels rid 3 (decoding)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg(jax_config)
    params_np = _np_params(cfg, 0)
    rng = np.random.Generator(np.random.Philox(key=7))
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in PROMPT_LENS]
    return dict(cfg=cfg, params_np=params_np, prompts=prompts,
                params=jax.tree_util.tree_map(jnp.asarray, params_np),
                runs={})


def _port(setup, obs, **over):
    params = convert.from_jax(setup["params_np"], device="cpu")
    return Engine(_cfg(get_config), params, options=EngineOptions(
        device="cpu", obs=obs, **dict(OPTS, **over)))


def _drive(eng, prompts, storm):
    reqs = [eng.submit(p, max_new_tokens=m, arrival_s=0.0)
            for p, m in zip(prompts, MAX_NEW)]
    if storm == "offload":
        for _ in range(CANCEL_AT):
            eng.step()
        assert eng.cancel(reqs[3])
    eng.run_until_idle()
    return [list(r.output) for r in reqs]


def _run(setup, storm):
    """The storm through both engines, each run once per file."""
    if storm not in setup["runs"]:
        jeng = JaxEngine(setup["cfg"], setup["params"], options=JaxOptions(
            obs=JaxRecorder(tracer=JaxTracer()),
            **dict(OPTS, **STORMS[storm])))
        teng = _port(setup, Recorder(tracer=Tracer()), **STORMS[storm])
        toks = (_drive(teng, setup["prompts"], storm),
                _drive(jeng, setup["prompts"], storm))
        setup["runs"][storm] = teng, jeng, toks
    return setup["runs"][storm]


def _no_timings(snap):
    """Histograms keep their counts only (sums and quantiles are
    timings)."""
    def one(v):
        return v["count"] if isinstance(v, dict) and "count" in v else v
    return {k: ({lk: one(lv) for lk, lv in v.items()}
                if isinstance(v, dict) and "count" not in v else one(v))
            for k, v in snap.items()}


@pytest.mark.parametrize("storm", sorted(STORMS))
def test_snapshot_equals_jax(setup, storm):
    teng, jeng, (ttoks, jtoks) = _run(setup, storm)
    assert ttoks == jtoks
    ts, js = teng.stats(), jeng.stats()         # stats() refreshes gauges
    if storm == "recompute":
        assert ts["preempt_recompute"] > 0
    else:
        assert ts["preempt_offload"] > 0 and ts["requests_cancelled"] == 1
    tsnap = _no_timings(teng.obs.registry.snapshot())
    jsnap = _no_timings(jeng.obs.registry.snapshot())
    # the documented exception: what the port counts as a trace
    tjit, jjit = tsnap.pop("repro_jit_traces_total"), \
        jsnap.pop("repro_jit_traces_total")
    assert tjit == {'body="prefill"': teng.prefill_builds}
    assert jjit == {'body="decode"': jeng.decode_traces,
                    'body="prefill"': jeng.prefill_traces}
    assert teng.prefill_builds == jeng.prefill_traces
    assert jeng.decode_traces == 1 and teng._decode.captures == 0
    assert tsnap == jsnap
    for key in ("queue_waiting", "queue_resuming", "running_slots",
                "free_units_by_shard", "kv_shards", "requests_done",
                "requests_cancelled", "cancelled_by_stage", "resumes",
                "preempt_recompute", "preempt_offload"):
        assert ts[key] == js[key], key
    assert ts["free_units_by_shard"] == {"0": teng.kv.num_pages - 1}
    assert tsnap["repro_requests_done_total"] == ts["requests_done"]


def _tracks(eng):
    """(pid, tid) -> [(ph, name, args)] in export order, the decode and
    prefill builds' ``jit.trace`` instants left out (the documented
    exception)."""
    out = {}
    for e in eng.obs.tracer.export()["traceEvents"]:
        if e["ph"] == "M" or e["name"] == "jit.trace":
            continue
        out.setdefault((e["pid"], e["tid"]), []).append(
            (e["ph"], e["name"], e.get("args", {})))
    return out


@pytest.mark.parametrize("storm", sorted(STORMS))
def test_event_sequences_equal_jax(setup, storm):
    teng, jeng, _ = _run(setup, storm)
    tt, jt = _tracks(teng), _tracks(jeng)
    assert sorted(tt) == sorted(jt)
    for key in sorted(jt):
        assert tt[key] == jt[key], key
    rids = [k[1] for k in tt if k[0] == PID_REQUESTS]
    assert sorted(rids) == list(range(len(PROMPT_LENS)))
    names = [n for k in rids for _, n, _ in tt[(PID_REQUESTS, k)]]
    for name in ("ADMIT", "PREFILL", "DECODE", "PREEMPT", "RESUME"):
        assert name in names, name
    assert names.count("ADMIT") == len(PROMPT_LENS)
    if storm == "offload":                 # rid 3 cancelled in decode
        cancel = [e for e in tt[(PID_REQUESTS, 3)] if e[1] == "CANCEL"]
        assert len(cancel) == 1 and cancel[0][2]["stage"] == "decode"
        assert tt[(PID_REQUESTS, 3)][-2][:2] == ("E", "DECODE")
        assert names.count("RETIRE") == len(PROMPT_LENS) - 1
    steps = [a for _, n, a in tt[(PID_ENGINE, 1)] if n == "engine.step"]
    assert [a["step"] for a in steps] == list(range(teng.step_count))
    assert tt[(PID_RESOLVER, 1)]
    # B/E balanced and nested per track; spans sorted by time
    doc = teng.obs.tracer.export()
    real = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    assert [e["ts"] for e in real] == sorted(e["ts"] for e in real)
    stacks = {}
    for e in real:
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks.setdefault(key, []).append(e["name"])
        elif e["ph"] == "E":
            assert stacks.get(key) and stacks[key].pop() == e["name"]
    assert all(not s for s in stacks.values())
    threads = {(e["pid"], e["tid"]): e["args"]["name"]
               for e in doc["traceEvents"]
               if e["ph"] == "M" and e["name"] == "thread_name"}
    assert threads[(PID_ENGINE, 1)] == "steps"
    assert threads[(PID_RESOLVER, 1)] == "retune"
    assert all(threads[(PID_REQUESTS, r)] == f"req {r}" for r in rids)


def test_tracer_off_same_tokens_and_builds(setup):
    teng, _, (ttoks, _) = _run(setup, "recompute")
    off = _port(setup, None, **STORMS["recompute"])
    assert not off.obs.tracing
    assert _drive(off, setup["prompts"], "recompute") == ttoks
    assert off.prefill_builds == teng.prefill_builds
    assert off._decode.captures == teng._decode.captures
    assert off.step_count == teng.step_count
    assert off.obs.tracer.export()["traceEvents"] == []
    # the default recorder still counts into its registry
    snap = off.obs.registry.snapshot()
    assert snap["repro_jit_traces_total"] == {
        'body="prefill"': off.prefill_builds}
    assert snap["repro_prefill_compiles_total"] == off.prefill_builds


def test_metrics_server_agrees_with_stats(setup):
    teng, _, _ = _run(setup, "recompute")
    server = MetricsServer(teng.obs.registry, port=0,
                           refresh=teng._refresh_gauges).start()
    try:
        text = urllib.request.urlopen(server.url + "/metrics",
                                      timeout=10).read().decode()
    finally:
        server.stop()

    def metric(name):
        for line in text.splitlines():
            if line.startswith(name + " "):
                return float(line.rsplit(" ", 1)[1])
        raise AssertionError(f"{name} not in exposition")

    s = teng.stats()
    assert metric("repro_requests_done_total") == s["requests_done"] == \
        len(PROMPT_LENS)
    assert metric("repro_tokens_generated_total") == \
        s["tokens_generated"] == sum(MAX_NEW)
    assert metric('repro_preempts_total{mode="recompute"}') == \
        s["preempt_recompute"]
    assert metric("repro_waiting_requests") == s["queue_waiting"] == 0
    assert metric("repro_resuming_requests") == s["queue_resuming"] == 0
    assert metric("repro_running_slots") == s["running_slots"] == 0
    assert metric('repro_kv_free_pages{shard="0"}') == \
        s["free_units_by_shard"]["0"] == teng.kv.num_pages - 1
    assert metric('repro_engine_steps_total{kind="decode"}') == \
        s["decode_steps"]
    assert metric("repro_prefill_tokens_total") == s["prefill_tokens"]
    lats = sorted(r.latency_s for r in teng.done)
    assert s["p50_latency_s"] == lats[2]      # nearest rank of 5 samples
