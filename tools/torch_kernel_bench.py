#!/usr/bin/env python3
"""Times the port's flash-attention and expert-FFN kernels on one NVIDIA
card at ``chip_smoke.py``'s shapes, without its serve and train phases:

    python3 tools/torch_kernel_bench.py [--fp32] [--root DIR]

Builds the two kernels, then runs ``chip_smoke.py``'s checks (each
kernel against its plain version within its ``ref.tolerance``, timed
beside its plain version, its bound and, for attention,
``scaled_dot_product_attention``) and prints their ``kernel-case``
lines: the expert FFN at moe-gpt3-s's training chunk and serving
capacity, at DeepSeek-V2-Lite's experts and on both routed decode
buffers; attention at the training shape, with a window, with GQA and at
head dim 128. ``--fp32`` adds the fp32 cases. For the bf16 expert-FFN
cases it also prints the device time of each of the kernel's launches
(flags, phase 1, phase 2). Exits non-zero without a card or when a case
fails. ``--root`` runs the kernels, wrappers and checks of another
checkout of this repository instead (its ``chip_smoke.py`` and
``src/``), so that two versions can be timed in turns on one card;
cases that checkout does not have are skipped.
"""
import argparse
import sys
from pathlib import Path

def launches_ms(torch, fn, iters=10) -> dict:
    """Device ms per call of each CUDA kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:70]: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def grouped_breakdown(cs, torch, e, c, m, h, gated, act, seed):
    from repro_torch.kernels.grouped_ffn import grouped_ffn
    x = cs.randn(torch, (e, c, m), seed, dtype="bfloat16")
    wu = cs.randn(torch, (e, m, h), seed + 1, m ** -0.5, "bfloat16")
    wg = cs.randn(torch, (e, m, h), seed + 2, m ** -0.5, "bfloat16") \
        if gated else None
    wd = cs.randn(torch, (e, h, m), seed + 3, h ** -0.5, "bfloat16")
    cs.log(f"grouped_ffn launches E {e} C {c} M {m} H {h}: " + str(
        launches_ms(torch, lambda: grouped_ffn(x, wu, wg, wd, act))))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description="Time the flash-attention "
                                 "and expert-FFN kernels on the card.")
    ap.add_argument("--fp32", action="store_true",
                    help="also run the fp32 cases")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose kernels to time (default: this one)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs   # the checkout under test
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    cs.log(f"{args.root}: {torch.cuda.get_device_name(0)}; build "
           f"{build.build(['flash_attention', 'grouped_ffn'])}")
    for dtype in ["bfloat16"] + (["float32"] if args.fp32 else []):
        for case, c in (("train", 40), ("serve", 8)):
            cs.check_grouped(torch, case, 64, c, 768, 3072, False, "gelu",
                             dtype, seed=c)
        cs.check_grouped(torch, "deepseek", 64, 8, 2048, 1408, True, "silu",
                         dtype, seed=3)
        if dtype == "bfloat16" and hasattr(cs, "check_routed"):
            grouped_breakdown(cs, torch, 64, 40, 768, 3072, False, "gelu", 7)
            grouped_breakdown(cs, torch, 64, 8, 768, 3072, False, "gelu", 8)
            grouped_breakdown(cs, torch, 64, 8, 2048, 1408, True, "silu", 9)
            cs.check_routed(torch, "routed_decode_moe", "moe-gpt3-s", 4)
            cs.check_routed(torch, "routed_decode_deepseek", cs.DEEPSEEK, 5)
        for case, b, hq, kv, d, window in (("train", 8, 8, 8, 96, 0),
                                           ("window256", 8, 8, 8, 96, 256),
                                           ("gqa4", 8, 8, 2, 96, 0),
                                           ("d128", 4, 16, 16, 128, 0)):
            cs.check_flash(torch, case, b, 1024, hq, kv, d, window, dtype,
                           seed=6, library=window == 0 and kv == hq)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
