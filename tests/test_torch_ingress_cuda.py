"""The ingress on the card: the engine is built and warmed up (the decode
step captured) on the main thread, on a stream of its own, then served
from the ingress's engine thread, whose grad mode and current stream
are its own (PyTorch keeps both per thread). Reduced moe-gpt3-s, fp32,
capacity factor 8.0:

* SSE tokens, three streams at once, equal the tokens of the same
  requests served in-process;
* every decode step of the engine thread ran under ``no_grad`` on the
  stream the engine was built on, and replayed the one capture (one
  replay a decode step, one step's launches recorded a replay);
* telemetry on and off record the same launches a replay and the same
  captures, replays and builds.

This file imports neither ``jax`` nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_ingress_cuda.py

Elsewhere it skips: a CUDA kernel has no CPU mode.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

PROMPT_LENS = (13, 29, 7)
MAX_NEW = (9, 12, 6)
OPTS = dict(page_size=4, max_slots=3, max_seq_len=64, chunk=16,
            min_bucket=8, adaptive=False)
TIMEOUT = 120.0


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfg():
    from repro_torch.configs import get_config
    cfg = get_config("moe-gpt3-s").reduced()
    return dataclasses.replace(
        cfg, compute_dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=n, dtype=np.int32)
            for n in PROMPT_LENS]


class _Spy:
    """Wraps the engine's decode step: records the thread state each
    call runs under."""

    def __init__(self, step):
        self.step, self.seen = step, []

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, *a, **k):
        self.seen.append((torch.is_grad_enabled(),
                          torch.cuda.current_stream().cuda_stream))
        return self.step(*a, **k)


def _engine(obs=None, params=None):
    from repro_torch.serve import Engine, EngineOptions
    return Engine(_cfg(), params, options=EngineOptions(
        device="cuda", obs=obs, **OPTS), seed=0)


@pytest.mark.cuda
def test_ingress_thread_serves_the_captured_step():
    _cuda()
    from repro_torch.kernels import build
    from repro_torch.obs import Recorder, Tracer
    from repro_torch.serve import IngressClient, IngressOptions, \
        IngressServer
    build.build()
    prompts = _prompts(_cfg().vocab_size)
    ref = _engine()
    ref.warmup()
    reqs = [ref.submit(p, max_new_tokens=m) for p, m in
            zip(prompts, MAX_NEW)]
    ref.run_until_idle()
    want = [list(r.output) for r in reqs]

    side = torch.cuda.Stream()
    with torch.cuda.stream(side):          # built and warmed up here
        eng = _engine(Recorder(tracer=Tracer()), params=ref.params)
        eng.warmup()
    assert eng._stream.cuda_stream == side.cuda_stream
    spy = eng._decode = _Spy(eng._decode)
    build.reset_launches()
    srv = IngressServer(eng, options=IngressOptions()).start()
    try:
        cli = IngressClient(srv.host, srv.port, timeout=TIMEOUT)
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            futs = [ex.submit(cli.generate, p, max_new_tokens=m)
                    for p, m in zip(prompts, MAX_NEW)]
            got = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        srv.stop(timeout=TIMEOUT)
    assert [r.tokens for r in got] == want
    s = eng.stats()
    assert s["decode_captures"] == 1
    assert s["decode_replays"] == s["decode_steps"] == len(spy.seen)
    assert all(not grad and stream == side.cuda_stream
               for grad, stream in spy.seen)
    per_replay = dict(spy.launches)
    # the decode kernel runs in decode steps only, all of them replays
    assert build.LAUNCHES["paged_decode_attention"] == \
        per_replay["paged_decode_attention"] * s["decode_replays"]
    eng.kv.check_integrity()


@pytest.mark.cuda
def test_tracer_on_off_same_launches():
    _cuda()
    from repro_torch.kernels import build
    from repro_torch.obs import Recorder, Tracer
    build.build()
    prompts = _prompts(_cfg().vocab_size)
    rows = []
    for obs in (None, Recorder(tracer=Tracer()), None):
        eng = _engine(obs)
        eng.warmup()
        build.reset_launches()
        for p, m in zip(prompts, MAX_NEW):
            eng.submit(p, max_new_tokens=m)
        eng.run_until_idle()
        s = eng.stats()
        rows.append((dict(eng._decode.launches), dict(build.LAUNCHES),
                     s["decode_captures"], s["decode_replays"],
                     s["prefill_builds"],
                     [list(r.output) for r in eng.done]))
    assert rows[0] == rows[1] == rows[2]
