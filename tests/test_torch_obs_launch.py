"""Telemetry of the resolver, the train controller and both launchers:

* ``Resolver(obs=)`` against the JAX ``Resolver`` over the same token
  sequence and measure function: the same ``repro_retunes_total`` /
  ``repro_candidates_measured_total`` counts and retune-histogram count,
  the same ``resolver.resolve`` spans and ``candidate`` instants (args
  included), and ``retunes`` / ``candidates_measured`` / ``retune_s``
  read back from the registry;
* ``AdaptiveOptions.obs`` reaches the controller's resolver;
* the serve launcher's ``--metrics-port`` / ``--trace-out`` on the seeded
  batch, and the train launcher's, with the ``repro_train_*`` families;
* the serve launcher refuses ingress flags without ``--http-port``.
"""
import json

import pytest

from repro.core import selector as jsel
from repro.obs import Recorder as JaxRecorder
from repro.obs import Tracer as JaxTracer
from repro_torch.core import selector as tsel
from repro_torch.obs import PID_REQUESTS, PID_RESOLVER, Recorder, Tracer

from test_torch_core_models import HW, _cfgs


def _fake_clock(b, n, strategy):
    """A deterministic measure: a U over n, cheapest at n = 4."""
    return b * 1e-6 * (1.0 + abs(n - 4) / 4.0)


def _resolver_events(obs):
    return [(e["ph"], e["name"], e.get("args", {}))
            for e in obs.tracer.export()["traceEvents"]
            if e["ph"] != "M" and e["pid"] == PID_RESOLVER]


def test_resolver_telemetry_equals_jax():
    jcfg, tcfg = _cfgs("moe-gpt3-s", reduced=True)
    jhw, thw = HW["tpu-v5e"]
    jobs, tobs = JaxRecorder(tracer=JaxTracer()), Recorder(tracer=Tracer())
    jr = jsel.Resolver(jcfg, ep_size=8, hw=jhw, measure_fn=_fake_clock,
                       obs=jobs)
    tr = tsel.Resolver(tcfg, ep_size=8, hw=thw, measure_fn=_fake_clock,
                       obs=tobs)
    tokens = [512, 4096, 512, 2048, 4096]
    for i, t in enumerate(tokens):
        a, b = jr.resolve(t, refresh=i == 3), tr.resolve(t, refresh=i == 3)
        assert (a.moe.num_partitions, a.moe.memory_reuse_strategy) == \
            (b.moe.num_partitions, b.moe.memory_reuse_strategy)
    assert _resolver_events(tobs) == _resolver_events(jobs)
    ts, js = tobs.registry.snapshot(), jobs.registry.snapshot()
    assert ts["repro_retunes_total"] == js["repro_retunes_total"] == \
        len(tokens) == tr.retunes
    assert ts["repro_candidates_measured_total"] == \
        js["repro_candidates_measured_total"] == tr.candidates_measured > 0
    assert ts["repro_retune_seconds"]["count"] == len(tokens)
    assert tr.retune_s == ts["repro_retune_seconds"]["sum"] > 0
    names = [n for _, n, _ in _resolver_events(tobs)]
    assert names.count("resolver.resolve") == len(tokens)
    assert names.count("candidate") == tr.candidates_measured


def test_controller_shares_its_recorder():
    from repro_torch.runtime import AdaptiveOptions, TrainOptions
    from repro_torch.runtime.train_loop import AdaptiveController
    cfg = _cfgs("moe-gpt3-s", reduced=True)[1]
    rec = Recorder()
    ctl = AdaptiveController(cfg, TrainOptions(),
                             AdaptiveOptions(obs=rec), device="cpu")
    assert ctl.obs is rec and ctl.resolver.obs is rec
    ctl.resolver.resolve(256)
    assert rec.registry.snapshot()["repro_retunes_total"] == 1
    own = AdaptiveController(cfg, TrainOptions(), device="cpu")
    assert own.obs is not rec and own.resolver.retunes == 0


def _balanced(doc):
    stacks = {}
    for e in doc["traceEvents"]:
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks.setdefault(key, []).append(e["name"])
        elif e["ph"] == "E":
            assert stacks[key].pop() == e["name"]
    return all(not s for s in stacks.values())


def test_serve_launcher_metrics_port_and_trace_out(tmp_path, capsys):
    from repro_torch.launch import serve as launcher
    path = tmp_path / "serve.json"
    stats = launcher.main(["--engine", "--reduced", "--device", "cpu",
                           "--requests", "3", "--prompt-len", "8:20",
                           "--gen", "4", "--num-partitions", "2",
                           "--metrics-port", "0", "--trace-out", str(path)])
    out = capsys.readouterr().out
    assert "metrics: http://127.0.0.1:" in out
    assert f"trace: {path}" in out
    assert stats["requests_done"] == 3 and stats["tokens_generated"] == 12
    assert stats["running_slots"] == 0 and stats["kv_shards"] == 1
    doc = json.loads(path.read_text())
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] != "M"]
    assert names.count("ADMIT") == names.count("RETIRE") == 3
    assert names.count("engine.step") == stats["engine_steps"]
    assert _balanced(doc)
    assert {e["tid"] for e in doc["traceEvents"]
            if e["pid"] == PID_REQUESTS and e["ph"] != "M"} == {0, 1, 2}


def test_train_launcher_metrics_port_and_trace_out(tmp_path, capsys):
    from repro_torch.launch import train as launcher
    path = tmp_path / "train.json"
    hist = launcher.main(["--reduced", "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seq", "16", "--adaptive",
                          "--metrics-port", "0", "--trace-out", str(path)])
    out = capsys.readouterr().out
    assert "metrics: http://127.0.0.1:" in out and f"trace: {path}" in out
    assert len(hist) == 2
    doc = json.loads(path.read_text())
    spans = [e for e in doc["traceEvents"]
             if e["ph"] == "X" and e["name"] == "resolver.resolve"]
    assert spans and spans[0]["args"]["n"] == hist[0]["n"]


def test_train_launcher_families(monkeypatch):
    """The heartbeat's families land in the recorder the launcher makes
    (the one ``--metrics-port`` serves)."""
    import repro_torch.obs as obs_mod
    from repro_torch.launch import train as launcher
    made = []

    class Spy(obs_mod.Recorder):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
    monkeypatch.setattr(obs_mod, "Recorder", Spy)
    hist = launcher.main(["--reduced", "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seq", "16"])
    snap = made[0].registry.snapshot()
    assert snap["repro_train_step"] == 1
    assert snap["repro_train_loss"] == pytest.approx(hist[-1]["loss"])
    assert snap["repro_train_step_seconds"]["count"] == 2


@pytest.mark.parametrize("argv", [["--shed-policy", "degrade"],
                                  ["--admission-queue", "3"],
                                  ["--http-port", "0", "--rate", "5"]])
def test_serve_launcher_flag_rules(argv):
    from repro_torch.launch import serve as launcher
    with pytest.raises(SystemExit):
        launcher.main(["--reduced", "--device", "cpu"] + argv)


def test_serve_launcher_http_port(capsys):
    """``--http-port 0``: the launcher warms up, listens, streams SSE and
    ends on ``stop`` as on ^C, with ``--shed-policy degrade``."""
    import threading

    import numpy as np

    from repro_torch.launch import serve as launcher
    from repro_torch.serve import IngressClient
    stop, got = threading.Event(), {}

    def on_ingress(srv):
        def client():
            try:
                cli = IngressClient(srv.host, srv.port, timeout=60)
                got["health"] = cli.healthz()
                got["res"] = cli.generate(np.arange(1, 12),
                                          max_new_tokens=5)
            finally:
                stop.set()
        threading.Thread(target=client, daemon=True).start()

    stats = launcher.main(["--engine", "--reduced", "--device", "cpu",
                           "--http-port", "0", "--num-partitions", "2",
                           "--shed-policy",
                           "degrade", "--admission-queue", "2"],
                          stop=stop, on_ingress=on_ingress)
    out = capsys.readouterr().out
    assert "ingress: http://127.0.0.1:" in out and "shed=degrade" in out
    assert got["health"] and got["res"].status == 200
    assert len(got["res"].tokens) == 5 and not got["res"].degraded
    assert stats["requests_done"] == 1 and stats["tokens_generated"] == 5
