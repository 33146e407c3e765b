"""gemma3-12b through the port's dense path and serving engine against
the JAX package, on the CPU in fp32, as ``test_torch_engine_gqa.py`` does
for the other GQA decoders. Its reduction has 12 layers: two periods of
five local layers (window 32, RoPE theta 10k) and a global one (theta
1M), tied embeddings scaled by sqrt(d). Its own file, as the JAX oracle
decodes those 12 layers eagerly.
"""
import pytest

import torch_gqa_harness as H


@pytest.fixture(scope="module")
def ref():
    return H.reference("gemma3-12b")


def test_dense_path_logits_match_jax(ref):
    H.check_logits(ref)


def test_engine_tokens_equal_both_oracles(ref):
    H.check_engine(ref)


def test_local_and_global_layers_take_their_thetas():
    from repro_torch.models.layers import rope
    _, cfg = H.configs("gemma3-12b")
    roles = cfg.layer_roles()
    assert [r["global_attn"] for r in roles] == [False] * 5 + [True]
    assert rope.thetas(cfg) == (10_000.0, 1_000_000.0)
