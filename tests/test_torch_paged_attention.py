"""Paged-decode attention: the port's plain version against the JAX
package's Pallas kernel (interpret mode on the CPU) and its reference,
and the port's wrapper contract.

Cases follow ``tests/test_paged_attention.py``: ragged lens from 1 token
to the full table, window 0 and 6, unallocated page-table entries that
point at a garbage-filled sink page, and grown-ahead slots holding more
pages than their length needs. fp32 is held within atol 1e-6 (the sums
run in another order); bf16 outputs are compared in fp32 within 1e-2
(one bf16 rounding of values of order 1).

The CUDA kernel itself runs only on the card:
``test_torch_paged_attention_cuda.py`` holds it against the plain version
there and skips elsewhere.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import (paged_decode_attention as
                                           jax_kernel,
                                           paged_decode_attention_ref as
                                           jax_ref)
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 paged_decode_attention_ref)
from repro_torch.kernels.paged_attention.ref import NEG_INF as PORT_NEG_INF
from repro_torch.kernels.paged_attention.ref import tolerance
from repro_torch.models.layers.attention import NEG_INF as ATTN_NEG_INF
from test_torch_paged_attention_cuda import NP, PS, _setup


def _compare(q, kp, vp, pt, lens, window, dtype):
    b, _, hq, d = q.shape
    kv = kp.shape[2]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt) for a in (q, kp, vp)]
    kern = jax.jit(functools.partial(jax_kernel, window=window))(
        *jargs, jnp.asarray(pt), jnp.asarray(lens))
    ref = jax.jit(functools.partial(jax_ref, window=window))(
        jargs[0].reshape(b, kv, hq // kv, d), *jargs[1:], jnp.asarray(pt),
        jnp.asarray(lens))
    targs = [torch.from_numpy(a).to(tdt) for a in (q, kp, vp)]
    port = paged_decode_attention(*targs, torch.from_numpy(pt),
                                  torch.from_numpy(lens), window=window)
    plain = paged_decode_attention_ref(
        targs[0].reshape(b, kv, hq // kv, d), *targs[1:],
        torch.from_numpy(pt), torch.from_numpy(lens), window=window)
    assert port.dtype == tdt and port.shape == q.shape
    atol = 1e-6 if dtype == "float32" else 1e-2
    got = port.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(kern, np.float32),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(
        plain.float().numpy(),
        np.asarray(ref, np.float32), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 6])
def test_plain_matches_jax_kernel_and_ref(dtype, window):
    """Ragged lens (1 token up to the full table), sink-filled
    unallocated entries, garbage sink page."""
    rng = np.random.default_rng(0)
    _compare(*_setup(rng, [1, NP * PS, 7, 13], [0, 0, 0, 0]), window,
             dtype)


@pytest.mark.parametrize("window", [0, 3])
def test_grown_ahead_slots(window):
    """Slots holding more pages than ``pages_for(lens)``: the extra pages
    hold stale garbage that must never reach the output."""
    rng = np.random.default_rng(2)
    _compare(*_setup(rng, [3, 6, 9], [2, 1, 2]), window, "float32")


def test_mask_constant_matches_attention():
    assert PORT_NEG_INF == ATTN_NEG_INF


def test_wrapper_rejects_multi_query():
    rng = np.random.default_rng(3)
    q, kp, vp, pt, lens = _setup(rng, [4], [0])
    q2 = torch.zeros((1, 2, q.shape[2], q.shape[3]))     # S=2: prefill
    with pytest.raises(ValueError, match="single-query"):
        paged_decode_attention(q2, torch.from_numpy(kp),
                               torch.from_numpy(vp), torch.from_numpy(pt),
                               torch.from_numpy(lens))


def test_cpu_tensors_take_the_plain_version_without_launching():
    rng = np.random.default_rng(4)
    q, kp, vp, pt, lens = _setup(rng, [5, 11], [0, 1])
    build.reset_launches()
    out = paged_decode_attention(*(torch.from_numpy(a)
                                   for a in (q, kp, vp, pt, lens)))
    b, _, hq, d = q.shape
    plain = paged_decode_attention_ref(
        torch.from_numpy(q).reshape(b, 2, hq // 2, d),
        torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(pt),
        torch.from_numpy(lens)).reshape(b, 1, hq, d)
    assert torch.equal(out, plain)
    assert build.LAUNCHES["paged_decode_attention"] == 0


def test_bf16_tolerance_admits_one_rounding_flip_only():
    """The bf16 limit covers one unit in the last place at the largest
    output and not four; fp32 keeps 1e-5."""
    ref = torch.tensor([0.75, -0.3, 0.01], dtype=torch.bfloat16)
    tol = tolerance(ref)
    ulp = 2.0 ** -8                       # bf16 spacing in [0.5, 1)
    assert ulp <= tol < 4 * ulp
    assert tolerance(ref.float()) == 1e-5
    assert tolerance(torch.full((2,), 100.0, dtype=torch.bfloat16)) == 2e-2
