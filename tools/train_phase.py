#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``train-memory`` phase alone on the card.

    python3 tools/train_phase.py [optim,remat,ckpt,models] [--kernels]

Builds the kernels from the checkout, then runs the named parts of the
phase (default: all four, in that order) through ``chip_smoke.py``'s own
functions, with the same checks and log lines: ``optim`` (moe-gpt3-s
under AdamW, 8-bit AdamW and Adafactor), ``remat`` (``nothing``,
``dots``, ``full``), ``ckpt`` (8-bit AdamW checkpointed at step 2,
restored and resumed) and ``models`` (moe-bert-l and 4-layer
moe-gpt3-xl). ``--kernels`` first holds the kernels against their plain
versions at the two larger models' training shapes (phase 3's
``train_bert_l`` and ``train_xl`` rows). Prints the card's name and power
limit first. It needs one CUDA card.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_phase: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    kernels = "--kernels" in argv
    argv = [a for a in argv if a != "--kernels"]
    parts = argv[0].split(",") if argv else list(cs.MEMORY_PARTS)
    if any(p not in cs.MEMORY_PARTS for p in parts):
        print(f"train_phase: parts are {','.join(cs.MEMORY_PARTS)}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())
    t0 = time.perf_counter()
    cs.log(f"build {build.build()} ({time.perf_counter() - t0:.1f} s)")
    if kernels:
        for case, m, h, hq in (("train_bert_l", 1024, 4096, 8),
                               ("train_xl", 2048, 8192, 16)):
            cs.check_grouped(torch, case, 64, 40, m, h, False, "gelu",
                             "bfloat16", seed=m)
            cs.check_flash(torch, case, 8, 1024, hq, hq, 128, 0, "bfloat16",
                           seed=hq, library=True)
    launches = cs.train_memory_phase(torch, build, parts)
    cs.log(f"launches {dict(launches)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
