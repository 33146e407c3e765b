"""Parameter gradients of the training loss under S3 and S4, and under
S3 with layer-level remat ("full"), the port against ``jax.grad`` of
the JAX package; the setting and the limits are those of
``test_torch_train_grads.py``, whose ``check`` this file runs."""
import pytest

from test_torch_train_grads import check


@pytest.mark.parametrize("strategy,remat", [("s3", "nothing"),
                                            ("s4", "nothing"),
                                            ("s3", "full")])
def test_gradients_match_jax(strategy, remat):
    check(strategy, remat)
