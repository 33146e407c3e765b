"""``repro_torch.obs`` against ``repro.obs``, with no engine: the same
calls on both registries give the same Prometheus text and the same
snapshot; the nearest-rank ``quantile`` equals the JAX package's and a
definitional reference (hypothesis); the tracers export the same events
(timestamps aside); the ``/metrics`` exporter serves ``render()``,
survives a hang-up in the middle of a write and stops idempotently.
Every socket takes a timeout and every server binds port 0."""
import json
import math
import urllib.error
import urllib.request

import pytest
from hypothesis import given, settings, strategies as st

import repro.obs as jobs
import repro_torch.obs as tobs


def _drive(obs):
    """The same calls on one package's registry."""
    reg = obs.Registry()
    c = reg.counter("repro_test_total", "things done")
    c.inc()
    c.inc(2)
    g = reg.gauge("repro_test_gauge", "a level")
    g.set(3.5)
    g.inc()
    g.dec(0.5)
    h = reg.histogram("repro_test_seconds", "a timing")
    for v in (1, 2, 3, 4, 0.25):
        h.observe(v)
    fam = reg.counter("repro_modes_total", "by mode", labels=("mode",))
    fam.labels(mode="a").inc()
    fam.labels(mode="b").inc(2)
    lh = reg.histogram("repro_step_seconds", "per kind", ["kind"],
                       window=3)
    for i, kind in enumerate(("decode", "prefill", "decode", "decode",
                              "decode")):
        lh.labels(kind=kind).observe(i * 0.5)
    gs = reg.gauge("repro_kv_free_pages", "free", ["shard"])
    gs.labels(shard=0).set(11)
    return reg


def test_registry_render_and_snapshot_equal_jax():
    t, j = _drive(tobs), _drive(jobs)
    assert t.render() == j.render()
    assert t.snapshot() == j.snapshot()
    json.dumps(t.snapshot())
    text = t.render().splitlines()
    assert "repro_test_total 3" in text and "repro_test_gauge 4" in text
    assert 'repro_modes_total{mode="b"} 2' in text
    assert "# TYPE repro_test_seconds summary" in text
    assert 'repro_kv_free_pages{shard="0"} 11' in text
    # the window bounds the quantiles, not the lifetime count and sum
    d = t.get("repro_step_seconds").labels(kind="decode")
    assert d.count == 4 and d.values() == [1.0, 1.5, 2.0]


def test_registration_rules_equal_jax():
    for obs in (tobs, jobs):
        reg = obs.Registry()
        fam = reg.counter("repro_modes_total", "m", labels=("mode",))
        assert reg.counter("repro_modes_total", "m",
                           labels=("mode",)) is fam
        with pytest.raises(AssertionError):
            reg.gauge("repro_modes_total", "m", labels=("mode",))
        with pytest.raises(AssertionError):
            reg.counter("repro_modes_total", "m", labels=("kind",))
        with pytest.raises(AssertionError):
            fam.labels(kind="a")
        with pytest.raises(AssertionError):
            reg.counter("bad name")
        with pytest.raises(AssertionError):
            reg.counter("repro_x_total").inc(-1)


def test_quantile_pinned_examples():
    q = tobs.quantile
    assert q([1.0, 2.0], 50) == 1.0 and q([1.0, 2.0], 100) == 2.0
    assert q([2.0, 1.0], 0) == 1.0 and q([5.0], 99) == 5.0
    assert q([], 50) == 0.0 and q([3, 1, 4, 1, 5], 50) == 3.0
    from repro_torch.serve import engine
    assert engine.quantile is tobs.quantile   # the engine re-exports it


@given(st.lists(st.floats(allow_nan=False, allow_infinity=False, width=32),
                min_size=1, max_size=200),
       st.integers(min_value=0, max_value=100))
@settings(max_examples=200, deadline=None)
def test_quantile_matches_jax_and_reference(xs, p):
    got = tobs.quantile(xs, p)
    assert got == jobs.quantile(xs, p)
    assert got in xs                       # nearest rank never interpolates
    rank = max(1, math.ceil(p / 100.0 * len(xs)))
    assert got == sorted(xs)[rank - 1]


def _trace(obs):
    tr = obs.Tracer()
    tr.thread_name(obs.PID_ENGINE, 1, "steps")
    tr.thread_name(obs.PID_REQUESTS, 3, "req 3")
    with tr.span("engine.step", args={"step": 0}) as sp:
        tr.instant("ADMIT", pid=obs.PID_REQUESTS, tid=3, args={"slot": 0})
        with tr.span("PREFILL", pid=obs.PID_REQUESTS, tid=3,
                     args={"chunk": 8}):
            pass
        tr.begin("DECODE", pid=obs.PID_REQUESTS, tid=3)
        sp["kind"] = "prefill"
    tr.end("DECODE", pid=obs.PID_REQUESTS, tid=3)
    tr.instant("SHED", pid=obs.PID_INGRESS, tid=0,
               args={"policy": "reject"})
    return tr.export()


def _strip(doc):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in doc["traceEvents"]]


def test_tracer_export_equals_jax(tmp_path):
    t, j = _trace(tobs), _trace(jobs)
    assert _strip(t) == _strip(j)
    assert t["displayTimeUnit"] == "ms"
    assert (tobs.PID_ENGINE, tobs.PID_REQUESTS, tobs.PID_RESOLVER,
            tobs.PID_INGRESS) == (jobs.PID_ENGINE, jobs.PID_REQUESTS,
                                  jobs.PID_RESOLVER, jobs.PID_INGRESS)
    tr = tobs.Tracer()
    tr.instant("x")
    tr.write(str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == tr.export()


def test_null_tracer_is_inert():
    t = tobs.NullTracer()
    assert not t.enabled and not tobs.Recorder().tracing
    with t.span("x", args={"k": 1}) as sp:
        sp["late"] = 2
    t.instant("i")
    t.begin("b")
    t.end("b")
    t.thread_name(1, 1, "steps")
    t.write("never-written.json")
    assert t.export()["traceEvents"] == []
    assert tobs.Recorder(tracer=tobs.Tracer()).tracing


def test_metrics_server_serves_render():
    reg = _drive(tobs)
    calls = []
    server = tobs.MetricsServer(reg, port=0,
                                refresh=lambda: calls.append(1)).start()
    try:
        assert server.port > 0
        text = urllib.request.urlopen(server.url + "/metrics",
                                      timeout=10).read().decode()
        assert urllib.request.urlopen(server.url + "/healthz",
                                      timeout=10).read() == b"ok\n"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(server.url + "/nope", timeout=10)
    finally:
        server.stop()
    assert text == reg.render() and calls == [1]


def test_metrics_server_survives_refresh_error_and_midwrite_hangup():
    """A failing refresh still serves (stale gauges beat a dead scrape);
    a scraper that hangs up in the middle of the response does not
    traceback the handler."""
    reg = tobs.Registry()
    reg.counter("repro_x_total", "x").inc()

    def boom():
        raise RuntimeError("refresh failed")
    server = tobs.MetricsServer(reg, port=0, refresh=boom)
    try:
        handler_cls = server._httpd.RequestHandlerClass

        class Gone:
            def write(self, *_):
                raise BrokenPipeError

            def flush(self):
                pass

        h = handler_cls.__new__(handler_cls)
        h.path = "/metrics"
        h.request_version = "HTTP/1.1"
        h.requestline = "GET /metrics HTTP/1.1"
        h.client_address = ("127.0.0.1", 0)
        h.wfile = Gone()
        h.do_GET()                         # must not raise
        h.path = "/healthz"
        h.do_GET()
    finally:
        server.stop()


def test_metrics_server_stop_is_idempotent():
    server = tobs.MetricsServer(tobs.Registry(), port=0).start()
    assert urllib.request.urlopen(server.url + "/healthz",
                                  timeout=10).read() == b"ok\n"
    server.stop()
    server.stop()                          # second shutdown: no-op
    with pytest.raises(OSError):
        urllib.request.urlopen(server.url + "/healthz", timeout=2)
    never = tobs.MetricsServer(tobs.Registry(), port=0)
    never.stop()                           # never started: no hang
    never.stop()
