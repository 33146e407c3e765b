"""The fused route-and-plan launch against its plain version, on the card.

``route_plan`` (one launch of ``csrc/topk_router.cu``) is held against
``route_plan_ref`` on the same CUDA inputs: indices, destinations, flags
and primary counts equal; probabilities within atol 1e-6 (the two sum the
softmax in another order); the statistics (probability sums, the sum of
logsumexp^2) and the two aux losses within rtol 1e-6 (the kernel sums in
fp64 in a fixed order, the plain version in fp64 too). The cases cover
one block and several (T 1 to 4096), E 8 to 256, k 1 to 8, fp32 and bf16
logits, a capacity tight enough to drop routes, rows where every expert
ties, and launches back to back on one stream and on two, which show that
the kernel's last block leaves its ticket at 0. This file imports neither
``jax`` nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_topk_router_cuda.py

Elsewhere it skips: a CUDA kernel has no CPU mode.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build

STAT_RTOL = 1e-6


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _logits(t, e, seed, dtype=torch.float32, ties=0):
    """Seeded normal logits; the first ``ties`` rows all equal (every
    expert ties) and, below them, rows whose two largest logits tie."""
    x = np.random.default_rng(seed).standard_normal((t, e)).astype(np.float32)
    x[:ties] = 0.25
    two = slice(ties, ties + ties)
    x[two, e - 1] = x[two].max(axis=1) + 1.0
    x[two, e // 2] = x[two, e - 1]
    return torch.from_numpy(x).cuda().to(dtype)


def _check(got, want, e, k):
    p, i, d, v, st = got
    pr, ir, dr, vr, sr = want
    assert torch.equal(i, ir)
    assert torch.equal(d, dr)
    assert torch.equal(v, vr)
    assert (p - pr).abs().max().item() <= 1e-6
    assert torch.equal(st["primary_count"], sr["primary_count"])
    for key in ("prob_sum", "z_sq_sum", "aux_loss", "z_loss"):
        torch.testing.assert_close(st[key], sr[key], rtol=STAT_RTOL, atol=0)
    assert p.dtype == torch.float32 and i.dtype == torch.int32
    assert d.dtype == torch.int32 and v.dtype == torch.bool
    assert st["prob_sum"].shape == (e,) and st["aux_loss"].shape == ()


def _run(x, k, cap, weights=(1e-2, 1e-3)):
    from repro_torch.kernels.topk_router import route_plan, route_plan_ref
    kw = dict(stats=True, aux_loss_weight=weights[0],
              z_loss_weight=weights[1])
    build.reset_launches()
    got = route_plan(x, k, cap, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["topk_router"] == 1
    return got, route_plan_ref(x, k, cap, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 6, 8])
@pytest.mark.parametrize("e", [8, 64, 128, 256])
@pytest.mark.parametrize("t", [1, 8, 16, 64, 1000, 2048, 4096])
def test_route_plan_matches_plain(t, e, k, dtype):
    _cuda()
    from repro_torch.core.pipeline_moe import capacity_for
    x = _logits(t, e, seed=t + e + k, dtype=dtype, ties=t // 8)
    cap = capacity_for(t, k, 1.25, e)
    got, want = _run(x, k, cap)
    _check(got, want, e, k)
    if t >= 8:                       # the all-tie rows take experts 0..k-1
        assert (got[1][: t // 8] == torch.arange(k, device="cuda")).all()


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,k,cap", [
    (8, 64, 6, 1),        # one block: DeepSeek decode, C 1
    (16, 8, 2, 1),        # one block, most routes drop
    (64, 64, 6, 2),       # one block of 32 warps
    (2048, 64, 1, 4),     # several blocks: the training chunk, C 4
    (1000, 8, 2, 10),     # several blocks, ragged last block
    (4096, 256, 8, 3),    # several blocks, widest E and k
])
def test_route_plan_tight_capacity_drops_routes(t, e, k, cap):
    _cuda()
    x = _logits(t, e, seed=7 * t + k, ties=t // 4)
    got, want = _run(x, k, cap)
    _check(got, want, e, k)
    valid = got[3]
    assert not valid.all()
    assert (got[2][~valid] == e * cap).all()
    assert int(valid.sum()) == int(torch.bincount(
        got[1].flatten().long(), minlength=e).clamp(max=cap).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,k", [(2048, 64, 1), (64, 64, 6), (1000, 8, 2)])
def test_back_to_back_launches_on_one_and_two_streams(t, e, k):
    """The ticket resets in the kernel: a second launch on the stream, and
    launches on two streams at once (each with its own workspace), come
    out as the first; the fp64 sums come out bit-equal every time."""
    _cuda()
    from repro_torch.kernels.topk_router import route_plan, route_plan_ref
    xs = [_logits(t, e, seed=s) for s in (1, 2)]
    want = [route_plan_ref(x, k, 8, stats=True) for x in xs]
    build.reset_launches()
    first = [route_plan(x, k, 8, stats=True) for x in xs]   # one stream
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    s1.wait_stream(torch.cuda.current_stream())
    s2.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s1):
        on1 = route_plan(xs[0], k, 8, stats=True)
    with torch.cuda.stream(s2):
        on2 = route_plan(xs[1], k, 8, stats=True)
    torch.cuda.synchronize()
    again = route_plan(xs[0], k, 8, stats=True)
    torch.cuda.synchronize()
    assert build.LAUNCHES["topk_router"] == 5
    for got, ref in ((first[0], want[0]), (first[1], want[1]),
                     (on1, want[0]), (on2, want[1]), (again, want[0])):
        _check(got, ref, e, k)
    for a, b in ((first[0], on1), (first[0], again), (first[1], on2)):
        for key in a[4]:
            assert torch.equal(a[4][key], b[4][key])


@pytest.mark.cuda
@pytest.mark.parametrize("t,k", [(2048, 1), (64, 6)])
def test_route_plan_gradient_and_topk_entry(t, k):
    """The probabilities' gradient is ``topk_router``'s, and the plan-free
    entry point gives route_plan's first two outputs."""
    _cuda()
    from repro_torch.kernels.topk_router import route_plan, topk_router
    x = _logits(t, 64, seed=t)
    w = _logits(t, k, seed=t + 1)
    xa = x.clone().requires_grad_(True)
    pa, ia, da, va = route_plan(xa, k, 8)
    assert pa.requires_grad and not da.requires_grad
    (ga,) = torch.autograd.grad((pa * w).sum(), xa)
    xb = x.clone().requires_grad_(True)
    pb, ib = topk_router(xb, k)
    (gb,) = torch.autograd.grad((pb * w).sum(), xb)
    assert torch.equal(ia, ib) and torch.equal(pa, pb)
    torch.testing.assert_close(ga, gb, rtol=0, atol=0)
