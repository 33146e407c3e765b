"""The port's dense-cache path against the JAX package on the CPU, fp32,
at reduced moe-gpt3-s (GQA, learned positions; the windowed variant is
``test_torch_dense_window.py``):

* ``lm.prefill`` logits within 1e-4 and its cache within 1e-5 of JAX's,
  ``cache_bytes`` equal;
* 8 ``lm.decode_step`` logits within 1e-4, fed JAX's greedy tokens, and
  the cache after them within 1e-5;
* ``dense_greedy_reference`` tokens equal to JAX's;
* the port's ``Engine`` tokens equal to the port's oracle (capacity
  factor 8.0);
* the serve launcher's fixed-batch loop (no ``--engine``): its
  ``MPipeMoE prefill:`` and ``request-batch`` lines, the JAX loop's
  per-sequence budgets, and the JAX launcher's flag rules.

The JAX side runs once (``tests/torch_dense_harness.py``).
"""
import numpy as np
import pytest

import torch_dense_harness as H
from repro_torch.launch import serve as launcher

ARCH = "moe-gpt3-s"


@pytest.fixture(scope="module")
def ref():
    return H.reference(ARCH)


def test_prefill_matches_jax(ref):
    H.check_prefill(ref)


def test_decode_steps_match_jax(ref):
    H.check_decode(ref)


def test_dense_greedy_reference_equals_jax(ref):
    H.check_oracle(ref)


def test_engine_equals_dense_oracle(ref):
    H.check_engine(ref)


def test_launcher_fixed_batch_loop(capsys):
    stats = launcher.main(["--reduced", "--device", "cpu", "--batch", "2",
                           "--prompt-len", "6", "--gen", "5",
                           "--requests", "2", "--num-partitions", "2",
                           "--seed", "3"])
    out = capsys.readouterr().out
    assert "MPipeMoE prefill: n=2 strategy=" in out
    assert "request-batch 0: 2 seqs x (6 prompt + <= 5 gen)" in out
    assert "request-batch 1:" in out and "tok/s" in out
    # the JAX loop's per-sequence budgets: Philox(123), 2 to 5 new tokens
    budgets = np.random.Generator(np.random.Philox(key=123))
    want = sum(int(budgets.integers(2, 6, size=2).sum()) for _ in range(2))
    assert stats["tokens_generated"] == want
    assert stats["decode_steps"] >= 1 and stats["p50_decode_step_ms"] > 0


@pytest.mark.parametrize("argv", [["--metrics-port", "0"],
                                  ["--prefix-cache", "on"],
                                  ["--rate", "5"],
                                  ["--prompt-len", "4:8"]])
def test_launcher_fixed_batch_flag_rules(argv):
    with pytest.raises(SystemExit):
        launcher.main(["--reduced", "--device", "cpu"] + argv)
