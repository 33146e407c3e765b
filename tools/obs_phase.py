#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s telemetry / replay / ingress phase alone on
the card.

    python3 tools/obs_phase.py [pairs,metrics,replay,ingress,exact]

Builds the kernels from the checkout, draws full-width moe-gpt3-s bf16
weights (seed 0, as phase 4's engine does), then runs the named parts of
phase 7 (default: all five, in that order) through ``chip_smoke.py``'s
own functions with the same checks and log lines: ``telemetry_pairs``
(the tracer off and on in turns), ``metrics_run`` (``/metrics`` scraped
mid-run), ``replay_phase`` (the Poisson replay), ``ingress_full`` and
``ingress_exact``. Prints the card's name and power limit first. It
needs one CUDA card.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PARTS = ("pairs", "metrics", "replay", "ingress", "exact")


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("obs_phase: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.models import lm
    parts = argv[0].split(",") if argv else list(PARTS)
    if any(p not in PARTS for p in parts):
        print(f"obs_phase: parts are {','.join(PARTS)}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())
    t0 = time.perf_counter()
    cs.log(f"build {build.build()} ({time.perf_counter() - t0:.1f} s)")
    cfg = cs.serve_config()
    params = lm.init_compute(cfg, 0, device="cuda")
    reqs = cs.requests(cfg.vocab_size, 16, seed=0)
    for part in parts:
        t0 = time.perf_counter()
        if part == "pairs":
            cs.telemetry_pairs(torch, build, cfg, params, reqs)
        elif part == "metrics":
            cs.metrics_run(torch, build, cfg, params, reqs)
        elif part == "replay":
            cs.replay_phase(build, cfg, params)
        elif part == "ingress":
            cs.ingress_full(torch, build, cfg, params, reqs)
        else:
            cs.ingress_exact(torch, build)
        cs.log(f"part {part} {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
