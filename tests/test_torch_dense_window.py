"""The port's dense-cache path with a sliding window against the JAX
package on the CPU, fp32: reduced moe-gpt3-s with window 8 under a
13-token prompt, so the prefill aligns the ring buffer (``_fill_cache``)
and decode wraps it (``_append_cache``, slot ``pos % window``). As
``test_torch_dense.py``: prefill logits within 1e-4 and cache within
1e-5, 8 decode steps, ``dense_greedy_reference`` tokens equal to JAX's,
the engine equal to the port's oracle.
"""
import pytest

import torch_dense_harness as H

ARCH, WINDOW = "moe-gpt3-s", 8


@pytest.fixture(scope="module")
def ref():
    return H.reference(ARCH, WINDOW)


def test_prefill_matches_jax(ref):
    H.check_prefill(ref)


def test_decode_steps_match_jax(ref):
    H.check_decode(ref)


def test_dense_greedy_reference_equals_jax(ref):
    H.check_oracle(ref)


def test_window_cache_is_a_ring(ref):
    """The windowed layers keep ``window`` slots, not ``max_len``."""
    cfg, _ = H.port(ref)
    layer = H.kv_cache.layer_cache(cfg, cfg.layer_roles()[0], 2, 24,
                                   device="cpu")
    assert layer["k"].shape[1] == WINDOW and layer["len"] == 0


def test_engine_equals_dense_oracle(ref):
    H.check_engine(ref)
