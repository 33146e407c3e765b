"""The grouped expert-FFN kernel against its plain version on the card,
over the shapes of its two-phase bf16 design, and its zero-expert skip.

Each case runs ``grouped_ffn`` on CUDA tensors (one launch) and
``grouped_ffn_ref`` on the same inputs, within ``ref.tolerance`` (1e-5
in fp32; in bf16 one rounding of the largest output). The cases cover
C 1, 8, 40, 100 and 130 (one row, the decode capacity, the training
chunk, a ragged C and one past the 128-row pass), M 64, 768 and 2048 and
H 32, 1408 and 3072, gated and plain. Experts whose rows are all zero
must come out exactly 0 (the kernel reads none of their weights), and a
NaN in an otherwise zero expert must make it count as fed. The training
chunks of moe-bert-l (M 1024, H 4096) and moe-gpt3-xl (M 2048, H 8192)
are held forward and backward in bf16. The expert-parallel shapes (32
experts a rank at mesh (1, 2): ``[32, 2·cap, M]`` after the dispatch
All-to-All, ``[32, cap, M]`` in the replicated decode) are cases too. This file
imports neither ``jax`` nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_grouped_ffn_cuda.py

Elsewhere it skips: a CUDA kernel has no CPU mode.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build

CASES = [  # e, c, m, h, gated, act
    (4, 1, 64, 32, False, "relu"),
    (8, 8, 768, 3072, False, "gelu"),       # moe-gpt3-s decode capacity
    (4, 8, 2048, 1408, True, "silu"),       # DeepSeek-V2-Lite decode
    (4, 40, 768, 3072, True, "silu"),       # training chunk, gated
    (2, 40, 2048, 3072, False, "relu"),
    (4, 100, 2048, 1408, True, "silu"),     # ragged C
    (2, 130, 768, 1408, False, "gelu"),     # two 128-row passes
    (3, 130, 64, 32, True, "gelu"),
    # expert parallelism at mesh (1, 2), 32 experts a rank, as
    # tools/ep_phase.py drives it: moe-gpt3-s's training chunk after the
    # dispatch All-to-All [32, 2 x 16, 768], DeepSeek-V2-Lite's prefill
    # chunk [32, 2 x 48, 2048] and its replicated decode [32, 8, 2048]
    (32, 32, 768, 3072, False, "gelu"),
    (32, 96, 2048, 1408, True, "silu"),
    (32, 8, 2048, 1408, True, "silu"),
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _randn(shape, seed, scale, dtype):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32)).cuda().to(dtype)


def _inputs(e, c, m, h, gated, dtype, seed=0):
    x = _randn((e, c, m), seed + 1, 1.0, dtype)
    wu = _randn((e, m, h), seed + 2, m ** -0.5, dtype)
    wg = _randn((e, m, h), seed + 3, m ** -0.5, dtype) if gated else None
    wd = _randn((e, h, m), seed + 4, h ** -0.5, dtype)
    return x, wu, wg, wd


def _run(x, wu, wg, wd, act):
    from repro_torch.kernels.grouped_ffn import grouped_ffn, grouped_ffn_ref
    build.reset_launches()
    out = grouped_ffn(x, wu, wg, wd, act)
    ref = grouped_ffn_ref(x, wu, wg, wd, act)
    torch.cuda.synchronize()
    assert build.LAUNCHES["grouped_ffn"] == 1
    assert out.dtype == x.dtype and out.shape == x.shape
    return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e,c,m,h,gated,act", CASES)
def test_grouped_kernel_matches_plain(dtype, e, c, m, h, gated, act):
    _cuda()
    from repro_torch.kernels.grouped_ffn.ref import tolerance
    out, ref = _run(*_inputs(e, c, m, h, gated, dtype, seed=c + m), act)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tolerance(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,m,h,gated,act", [(8, 768, 3072, False, "gelu"),
                                             (8, 2048, 1408, True, "silu"),
                                             (40, 768, 3072, False, "gelu")])
def test_idle_experts_come_out_exactly_zero(dtype, c, m, h, gated, act):
    """Half the experts get no rows (all zero, one of them -0.0): their
    output is exactly 0 and the fed ones match the plain version."""
    _cuda()
    from repro_torch.kernels.grouped_ffn.ref import tolerance
    e = 8
    x, wu, wg, wd = _inputs(e, c, m, h, gated, dtype, seed=5)
    x[::2] = 0.0
    x[2] = -0.0
    out, ref = _run(x, wu, wg, wd, act)
    assert (out[::2] == 0).all()
    assert torch.equal(ref[::2].float().abs().sum(), torch.tensor(
        0.0, device="cuda"))
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tolerance(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_nan_row_counts_as_fed(dtype):
    """Expert 1 is zero but for one NaN: its row 3 comes out NaN and its
    other rows 0, as in the plain version; the other experts are
    unaffected."""
    _cuda()
    from repro_torch.kernels.grouped_ffn.ref import tolerance
    x, wu, wg, wd = _inputs(4, 8, 768, 1408, True, dtype, seed=9)
    x[1] = 0.0
    x[1, 3, 5] = float("nan")
    out, ref = _run(x, wu, wg, wd, "silu")
    assert torch.isnan(ref[1, 3].float()).all()
    assert torch.isnan(out[1, 3].float()).all()
    rows = torch.ones(out.shape[:2], dtype=torch.bool, device="cuda")
    rows[1, 3] = False
    assert (out[1][rows[1]] == 0).all()
    fin_out, fin_ref = out[rows].float(), ref[rows]
    assert torch.isfinite(fin_out).all()
    assert (fin_out - fin_ref.float()).abs().max().item() \
        <= tolerance(fin_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("m,h", [(1024, 4096),     # moe-bert-l
                                 (2048, 8192)])    # moe-gpt3-xl
def test_paper_model_training_chunk_forward_and_backward(m, h):
    """One training chunk of the paper's two larger models (E 64, C 40:
    2048 tokens, top-1, capacity factor 1.25) in bf16: the forward within
    ``ref.tolerance``, and the gradients through the wrapper (its
    backward differentiates the plain version with an fp32 hidden, as
    the JAX package's custom VJP does) within ``ref.tolerance`` of each
    gradient of ``grouped_ffn_ref(round_hidden=False)`` on the same
    inputs."""
    _cuda()
    from repro_torch.kernels.grouped_ffn import grouped_ffn, grouped_ffn_ref
    from repro_torch.kernels.grouped_ffn.ref import tolerance
    x, wu, _, wd = _inputs(64, 40, m, h, False, torch.bfloat16, seed=m)
    ins = [t.clone().requires_grad_(True) for t in (x, wu, wd)]
    build.reset_launches()
    out = grouped_ffn(ins[0], ins[1], None, ins[2], "gelu")
    ref = grouped_ffn_ref(x, wu, None, wd, "gelu")
    torch.cuda.synchronize()
    assert build.LAUNCHES["grouped_ffn"] == 1
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tolerance(ref)
    g = _randn(out.shape, 7, 1.0, torch.bfloat16)
    gk = torch.autograd.grad(out, ins, g)
    rin = [t.clone().requires_grad_(True) for t in (x, wu, wd)]
    gr = torch.autograd.grad(grouped_ffn_ref(rin[0], rin[1], None, rin[2],
                                             "gelu", round_hidden=False),
                             rin, g)
    for a, b in zip(gk, gr):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
        assert (a.float() - b.float()).abs().max().item() <= tolerance(b)
