"""The port's dense-cache path for MLA (``_apply_mla``) against the JAX
package on the CPU, fp32, at reduced DeepSeek-V2-Lite (RoPE, top-2 of 4
experts and a shared one):

* ``lm.prefill`` (the expanded path: flash attention at head dim nope +
  rope, v padded to it) logits within 1e-4, the latent cache within
  1e-5, ``cache_bytes`` equal;
* 8 ``lm.decode_step`` (the absorbed path) logits within 1e-4 and the
  cache after them within 1e-5;
* ``dense_greedy_reference`` tokens equal to JAX's, and the port's
  ``Engine`` tokens (paged latent pools) equal to the port's oracle at
  capacity factor 8.0;
* the fixed-batch loop serves the architecture; MLA training raises.

The JAX side runs once (``tests/torch_dense_harness.py``).
"""
import pytest
import torch

import torch_dense_harness as H
from repro_torch.launch import serve as launcher
from repro_torch.models import lm

ARCH = "deepseek-v2-lite-16b"


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


def test_mla_training_raises(ref):
    cfg, params = H.port(ref)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        lm.forward(params, torch.zeros((1, 4), dtype=torch.long), cfg,
                   mode="train")


def test_launcher_fixed_batch_loop(capsys):
    stats = launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "5", "--gen",
                           "4", "--requests", "1"])
    out = capsys.readouterr().out
    assert "MPipeMoE prefill: n=" in out
    assert "request-batch 0: 2 seqs x (5 prompt + <= 4 gen)" in out
    assert stats["arch"] == f"{ARCH}-reduced"
    assert stats["tokens_generated"] >= 2 * 2
