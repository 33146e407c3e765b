#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s dense-cache phase alone on the card.

    python3 tools/dense_phase.py [fixed,oracle,gather]

Builds the kernels from the checkout, then runs the named parts (default:
all three, in that order) through ``chip_smoke.py``'s own functions with
the same checks and log lines: ``fixed`` draws full-width bf16 weights
(seed 0, as phases 4 and 9 do: moe-gpt3-s, then DeepSeek-V2-Lite at full
depth, 32.4 GB) and runs the launcher's fixed-batch loop over each
(``fixed_batch``; no engine step to set beside it here); ``oracle`` holds
the captured engine to ``dense_greedy_reference`` at full-depth
moe-gpt3-s in fp32 (``oracle_full_depth``, with the capacity-1.25
measurement); ``gather`` runs ``gather_vs_kernel`` with its oracle column
for both models at 2 layers. Prints the card's name and power limit
first. It needs one CUDA card.
"""
import gc
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PARTS = ("fixed", "oracle", "gather")


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("dense_phase: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.launch import serve as launcher
    from repro_torch.models import lm
    parts = argv[0].split(",") if argv else list(PARTS)
    if any(p not in PARTS for p in parts):
        print(f"dense_phase: parts are {','.join(PARTS)}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())
    t0 = time.perf_counter()
    cs.log(f"build {build.build()} ({time.perf_counter() - t0:.1f} s)")
    for part in parts:
        t0 = time.perf_counter()
        if part == "fixed":
            for arch in ("moe-gpt3-s", cs.DEEPSEEK):
                params = lm.init_compute(cs.serve_config(arch=arch), 0,
                                         device="cuda")
                cs.fixed_batch(torch, build, launcher, arch, params)
                del params
                gc.collect()
                torch.cuda.empty_cache()
        elif part == "oracle":
            cs.oracle_full_depth(torch, build)
        else:
            for arch in ("moe-gpt3-s", cs.DEEPSEEK):
                cs.gather_vs_kernel(torch, arch)
        cs.log(f"part {part} {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
