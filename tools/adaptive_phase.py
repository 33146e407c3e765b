#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s adaptive (n, strategy) phase alone on the card.

    python3 tools/adaptive_phase.py [eta,memory,serve,train]

Builds the kernels from the checkout, then runs the named parts of the
phase (default: all four, in that order) through ``chip_smoke.py``'s own
functions: ``eta_sigma`` (the host link, eta and sigma), ``strategy_memory``
(one MoE layer under NONE and S1-S4), ``adaptive_serve_phase`` and
``adaptive_train_phase``, with the same checks and log lines. Prints the
card's name and power limit first. It needs one CUDA card.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PARTS = ("eta", "memory", "serve", "train")


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("adaptive_phase: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    parts = argv[0].split(",") if argv else list(PARTS)
    if any(p not in PARTS for p in parts):
        print(f"adaptive_phase: parts are {','.join(PARTS)}", file=sys.stderr)
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
        if part == "eta":
            cs.eta_sigma(torch)
        elif part == "memory":
            cs.strategy_memory(torch)
        elif part == "serve":
            cs.adaptive_serve_phase(torch, build)
        else:
            cs.adaptive_train_phase(torch, build)
        cs.log(f"phase {part} {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
