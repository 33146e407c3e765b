"""The HTTP/SSE ingress (``repro_torch.serve.ingress``) against the JAX
engine: SSE streams over real sockets give the JAX engine's greedy
tokens (reduced moe-gpt3-s, fp32, capacity factor 8.0, the same converted
weights), sequentially and concurrently; a client disconnect cancels its
request within one engine step with the allocator's integrity intact;
both shed policies; request validation (400, 413, 404); the ingress's
metric families and its spans; an engine-thread error surfaces at
``stop()``.

Nothing here can hang the suite: every client socket has a timeout,
every ``result()`` and ``stop()`` one too, servers bind port 0 and every
thread is a daemon.
"""
import concurrent.futures
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.serve import Engine as JaxEngine
from repro.serve import EngineOptions as JaxOptions
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.obs import PID_INGRESS, PID_REQUESTS, Recorder, Tracer
from repro_torch.serve import (Engine, EngineOptions, IngressClient,
                               IngressOptions, IngressServer)

from test_torch_engine_preempt import _cfg, _np_params

PROMPT_LENS = (13, 29, 7)
MAX_NEW = (6, 8, 5)
GOLDEN_NEW = (40, 35, 5)        # the JAX run: MAX_NEW's tokens are prefixes
OPTS = dict(page_size=4, max_slots=3, max_seq_len=64, chunk=16,
            min_bucket=8, adaptive=False, attn_kernel="gather")
TIMEOUT = 60.0


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg(jax_config)
    params_np = _np_params(cfg, 0)
    rng = np.random.Generator(np.random.Philox(key=7))
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in PROMPT_LENS]
    jeng = JaxEngine(cfg, jax.tree_util.tree_map(jnp.asarray, params_np),
                     options=JaxOptions(**OPTS))
    reqs = [jeng.submit(p, max_new_tokens=m, arrival_s=0.0)
            for p, m in zip(prompts, GOLDEN_NEW)]
    jeng.run_until_idle()
    golden = [list(r.output) for r in reqs]
    return dict(prompts=prompts, golden=golden,
                refs=[g[:m] for g, m in zip(golden, MAX_NEW)],
                params_np=params_np)


@pytest.fixture(scope="module")
def eng(setup):
    e = Engine(_cfg(get_config),
               convert.from_jax(setup["params_np"], device="cpu"),
               options=EngineOptions(device="cpu",
                                     obs=Recorder(tracer=Tracer()), **OPTS))
    e.warmup()
    return e


class _serve:
    """An IngressServer over the shared engine for one test."""

    def __init__(self, eng, **opts):
        self.srv = IngressServer(eng, options=IngressOptions(**opts))

    def __enter__(self):
        self.srv.start()
        return self.srv, IngressClient(self.srv.host, self.srv.port,
                                       timeout=TIMEOUT)

    def __exit__(self, *exc):
        self.srv.stop(timeout=TIMEOUT)
        assert not self.srv._engine_thread.is_alive()
        assert not self.srv._loop_thread.is_alive()


def _wait(pred, timeout=TIMEOUT):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


@pytest.mark.parametrize("together", [False, True])
def test_sse_tokens_equal_jax(setup, eng, together):
    prompts, refs = setup["prompts"], setup["refs"]
    with _serve(eng) as (_, cli):
        assert cli.healthz()
        if together:                       # three streams at once
            with concurrent.futures.ThreadPoolExecutor(3) as ex:
                futs = [ex.submit(cli.generate, p, max_new_tokens=m)
                        for p, m in zip(prompts, MAX_NEW)]
                results = [f.result(timeout=TIMEOUT) for f in futs]
        else:
            results = [cli.generate(p, max_new_tokens=m)
                       for p, m in zip(prompts, MAX_NEW)]
    for res, ref in zip(results, refs):
        assert res.status == 200 and not res.degraded
        assert res.tokens == ref
        assert res.finish_reason == "length"
        assert 0 < res.ttft_s <= res.latency_s
    eng.kv.check_integrity()
    assert eng.kv.free_pages == eng.kv.num_pages - 1
    snap = eng.obs.registry.snapshot()
    assert snap["repro_ingress_requests_total"]['outcome="accepted"'] >= 3


def test_sse_eos_and_sampling_fields(setup, eng):
    prompts, refs = setup["prompts"], setup["refs"]
    with _serve(eng) as (_, cli):
        res = cli.generate(prompts[0], max_new_tokens=MAX_NEW[0],
                           eos_id=refs[0][1])
        assert res.tokens == refs[0][:2] and res.finish_reason == "eos"
        res = cli.generate(prompts[0], max_new_tokens=MAX_NEW[0],
                           stop=[refs[0][2:4]])
        assert res.tokens == refs[0][:4] and res.finish_reason == "stop"
        res = cli.generate(prompts[2], max_new_tokens=4, temperature=0.8,
                           top_k=8, seed=3)
        again = cli.generate(prompts[2], max_new_tokens=4, temperature=0.8,
                             top_k=8, seed=3)
    assert res.status == 200 and len(res.tokens) == 4
    assert res.tokens == again.tokens                 # seeded stream
    assert all(0 <= t < _cfg(get_config).vocab_size for t in res.tokens)


def test_request_validation(setup, eng):
    prompts = setup["prompts"]
    with _serve(eng, max_body_bytes=256) as (srv, cli):
        assert cli.generate([], max_new_tokens=4).status == 400
        # over engine capacity: submit's ValueError becomes a 400
        assert cli.generate(prompts[0],
                            max_new_tokens=100000).status == 400
        assert cli.generate(prompts[0], max_new_tokens=0).status == 400
        # an oversized body is shed before parsing
        assert cli.generate(list(range(300)),
                            max_new_tokens=4).status == 413
        with socket.create_connection((srv.host, srv.port),
                                      TIMEOUT) as sock:
            sock.sendall(b"GET /nope HTTP/1.1\r\nHost: x\r\n\r\n")
            assert b" 404 " in sock.makefile("rb").readline()
        with socket.create_connection((srv.host, srv.port),
                                      TIMEOUT) as sock:
            sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Length: 9\r\n\r\nnot json!")
            assert b" 400 " in sock.makefile("rb").readline()
    snap = eng.obs.registry.snapshot()
    assert snap["repro_ingress_requests_total"]['outcome="bad_request"'] \
        >= 5
    assert not eng.has_work


def _steps_between(eng, rid):
    """engine.step spans that started between the request's DISCONNECT
    (stamped once its cancel is queued) and its CANCEL."""
    ev = eng.obs.tracer.export()["traceEvents"]
    t_disc = next(e["ts"] for e in ev if e["name"] == "DISCONNECT"
                  and e["tid"] == rid)
    t_cancel = next(e["ts"] for e in ev if e["name"] == "CANCEL"
                    and e["pid"] == PID_REQUESTS and e["tid"] == rid)
    return sum(1 for e in ev if e["name"] == "engine.step"
               and t_disc < e["ts"] < t_cancel)


def test_disconnect_cancels_within_a_step(setup, eng):
    prompts, golden = setup["prompts"], setup["golden"]
    before = len(eng.cancelled)
    with _serve(eng) as (_, cli):
        res = cli.generate(prompts[0], max_new_tokens=40,
                           disconnect_after=2)
        assert res.tokens == golden[0][:2]       # exact up to the hang-up
        assert _wait(lambda: len(eng.cancelled) == before + 1)
        assert _wait(lambda: not eng.has_work)
    victim = eng.cancelled[-1]
    assert victim.finish_reason == "cancelled" and victim.slot == -1
    assert len(victim.output) < 40
    assert eng.stats()["cancelled_by_stage"].get("decode", 0) >= 1
    assert _steps_between(eng, victim.rid) <= 1
    eng.kv.check_integrity()
    assert eng.kv.free_pages == eng.kv.num_pages - 1
    assert eng.obs.registry.snapshot()[
        "repro_ingress_disconnects_total"] >= 1


def test_disconnect_before_first_token(setup, eng):
    before = len(eng.cancelled)
    with _serve(eng) as (_, cli):
        res = cli.generate(setup["prompts"][1], max_new_tokens=30,
                           disconnect_after=0)
        assert res.status == 200 and not res.tokens
        assert _wait(lambda: len(eng.cancelled) == before + 1)
        assert _wait(lambda: not eng.has_work)
    eng.kv.check_integrity()
    assert eng.kv.free_pages == eng.kv.num_pages - 1


def test_shed_reject(setup, eng):
    prompts, golden, refs = setup["prompts"], setup["golden"], setup["refs"]
    with _serve(eng, admission_queue=1, shed_policy="reject") as (srv, cli):
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            blocker = ex.submit(cli.generate, prompts[1],
                                max_new_tokens=35)
            assert _wait(lambda: srv._inflight >= 1)
            shed = cli.generate(prompts[0], max_new_tokens=4)
            assert shed.status == 429 and not shed.tokens
            assert shed.retry_after_s >= 1.0
            assert blocker.result(timeout=TIMEOUT).tokens == golden[1]
        # the queue drained: admitted again
        assert cli.generate(prompts[0],
                            max_new_tokens=MAX_NEW[0]).tokens == refs[0]
    snap = eng.obs.registry.snapshot()
    assert snap["repro_ingress_requests_total"]['outcome="rejected"'] >= 1


def test_shed_degrade(setup, eng):
    prompts, refs = setup["prompts"], setup["refs"]
    with _serve(eng, admission_queue=1, shed_policy="degrade",
                degrade_max_new=2) as (srv, cli):
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            blocker = ex.submit(cli.generate, prompts[1],
                                max_new_tokens=35)
            assert _wait(lambda: srv._inflight >= 1)
            res = cli.generate(prompts[0], max_new_tokens=MAX_NEW[0])
            assert res.status == 200 and res.degraded
            assert res.tokens == refs[0][:2]     # clamped, still exact
            assert res.finish_reason == "length"
            blocker.result(timeout=TIMEOUT)
    eng.kv.check_integrity()
    snap = eng.obs.registry.snapshot()
    assert snap["repro_ingress_requests_total"]['outcome="degraded"'] >= 1


def test_many_streams_stress(setup, eng):
    """More streams than cores and a 10 µs switch interval: the
    in-flight count, shared by the asyncio and engine threads, must come
    back to 0 with every stream whole and exact."""
    import sys
    prompt, want = setup["prompts"][2], setup["refs"][2][:3]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _serve(eng, admission_queue=32) as (srv, cli):
            with concurrent.futures.ThreadPoolExecutor(16) as ex:
                futs = [ex.submit(cli.generate, prompt, max_new_tokens=3)
                        for _ in range(16)]
                results = [f.result(timeout=TIMEOUT) for f in futs]
            assert _wait(lambda: srv._inflight == 0 and not eng.has_work)
    finally:
        sys.setswitchinterval(interval)
    assert all(r.status == 200 and r.tokens == want for r in results)
    snap = eng.obs.registry.snapshot()
    assert snap["repro_ingress_inflight_requests"] == 0
    assert snap["repro_ingress_open_streams"] == 0
    eng.kv.check_integrity()
    assert eng.kv.free_pages == eng.kv.num_pages - 1


def test_ingress_spans_and_families(eng):
    """Runs after the streams above (one engine, in file order)."""
    ev = eng.obs.tracer.export()["traceEvents"]
    streams = [e for e in ev
               if e.get("pid") == PID_INGRESS and e["name"] == "STREAM"]
    assert sum(e["ph"] == "B" for e in streams) \
        == sum(e["ph"] == "E" for e in streams) > 0
    names = {e["name"] for e in ev if e.get("pid") == PID_INGRESS}
    assert {"STREAM", "DISCONNECT", "SHED"} <= names
    procs = {e["pid"]: e["args"]["name"] for e in ev
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs[PID_INGRESS] == "ingress"
    snap = eng.obs.registry.snapshot()
    for fam in ("repro_ingress_requests_total",
                "repro_ingress_disconnects_total",
                "repro_ingress_stream_seconds",
                "repro_ingress_inflight_requests",
                "repro_ingress_open_streams"):
        assert fam in snap, fam
    assert snap["repro_ingress_inflight_requests"] == 0
    assert snap["repro_ingress_open_streams"] == 0
    assert snap["repro_ingress_stream_seconds"]["count"] > 0


class _Broken:
    """An engine whose step fails: the error must reach ``stop()``."""
    obs = Recorder()
    has_work = True

    def step(self):
        raise RuntimeError("step failed")


def test_engine_thread_error_surfaces_at_stop():
    srv = IngressServer(_Broken()).start()
    assert _wait(lambda: srv.error is not None, timeout=10)
    with pytest.raises(RuntimeError, match="engine thread"):
        srv.stop(timeout=10)
    srv.stop(timeout=10)                        # idempotent after that
