"""The GQA + RoPE decoders through the port's dense path and serving
engine against the JAX package, on the CPU in fp32, at the reduced sizes
of llama3-8b, h2o-danube-1.8b (window 32) and qwen1.5-110b (QKV bias);
gemma3-12b's 12 reduced layers run in ``test_torch_engine_gemma3.py``.

For each config, built once from the JAX package (``torch_gqa_harness``):
``lm.prefill`` of a 40-token prompt (past the window: ``_fill_cache``
aligns the ring) and 4 ``lm.decode_step``s, logits within 1e-4 of JAX's;
the paged engine (4-token pages, 16-token chunks, 2 slots) on a 37- and a
9-token prompt, its greedy tokens equal to the port's
``dense_greedy_reference`` and, on the long prompt, to the JAX package's.
"""
import pytest

import torch_gqa_harness as H

ARCHS = ("llama3-8b", "h2o-danube-1.8b", "qwen1.5-110b")
_REFS = {}


@pytest.fixture(params=ARCHS)
def ref(request):
    if request.param not in _REFS:
        _REFS[request.param] = H.reference(request.param)
    return _REFS[request.param]


def test_dense_path_logits_match_jax(ref):
    H.check_logits(ref)


def test_engine_tokens_equal_both_oracles(ref):
    H.check_engine(ref)
