"""Adafactor, the port against ``repro.optim.adafactor``, on the CPU in
fp32 over the parameter tree of moe-gpt3-s's reduced size (4 layers, 2
periods): 3 updates from seeded numpy gradients, and 1 from a JAX state
carried across by ``convert.from_jax_state``. Parameters within rtol
1e-6, atol 1e-7, and ``vr`` / ``vc`` (stacked in both packages) within
rtol 1e-6 after every update; the cross-period statistics of the 1-D
period leaves (``vc`` the mean over the periods, ``r`` over the mean of
``vr`` across them) and the RMS clip over each whole stacked leaf are
what the 2 periods exercise. The helpers and the rest of the rationale
are in ``test_torch_optim.py``.
"""
import pytest

from test_torch_optim import (make_setup, three_updates,
                              update_from_converted_state)


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def test_three_updates_match_jax(setup):
    three_updates(setup, "adafactor")


def test_update_from_a_converted_jax_state_matches_jax(setup):
    update_from_converted_state(setup, "adafactor")
