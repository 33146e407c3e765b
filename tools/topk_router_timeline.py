#!/usr/bin/env python3
"""Where the fused router launch spends its time, phase by phase, on one
NVIDIA card:

    python3 tools/topk_router_timeline.py

Builds a copy of ``src/repro_torch/kernels/topk_router/csrc/topk_router.cu``
into ``build/`` with a ``%globaltimer`` mark taken by thread 0 of every
block at each phase boundary (start; the block's place in the order, with
several blocks; the rows done; its histogram published; the earlier
blocks' flags seen; their histograms summed; the end), launches it at the
main paths' routing shapes, and prints, per shape, the marks of a few
blocks (ns from the first block's start) and the median and largest
length of each phase over the blocks. Then, with the unmarked kernel,
the device time of the top-k alone (``topk_router``), of the plan
(``route_plan``) and of the plan with the statistics, from
``torch.profiler``. The marks sit at fixed places in the source: the
script stops with the anchor it could not find if the kernel changed.
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SHAPES = ((2048, 64, 1, 40, False), (64, 64, 6, 8, True), (16, 64, 1, 8, True),
          (8, 64, 6, 8, True), (8, 64, 1, 8, True), (8, 64, 1, 8, False))
PHASES = ("start", "order", "rows", "publish", "wait", "lookback", "end")
MARKS = (   # (anchor in the source, text put after it)
    ("#include <stdint.h>\n",
     "__device__ unsigned long long g_marks[8192 * 8];\n#define MARK(i) "
     "if (threadIdx.x == 0) { unsigned long long t_; asm volatile("
     "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
     "g_marks[size_t(blockIdx.x) * 8 + (i)] = t_; }\n"),
    ("multi = cross && B > 1;\n", "  MARK(0)\n"),
    ("% 0x7fffffff) + 1;\n", "    MARK(1)\n"),
    ("if (lane == 0) zs[warp] = zacc;\n  }\n  __syncthreads();\n",
     "  MARK(2)\n"),
    ("  if (multi) {\n    // publish, then wait for every block before this "
     "one in order\n    __syncthreads();\n", "    MARK(3)\n"),
    ("if (spin > kMaxSpin) __trap();\n    __syncthreads();\n", "    MARK(4)\n"),
    ("  }\n  __syncthreads();\n\n  write_routes();\n", "  MARK(5)\n"),
    ("finalize_aux(a, cnt, psum, zs[0]);\n  }\n",
     "  MARK(6)\n  if (threadIdx.x == 0) g_marks[size_t(blockIdx.x) * 8 + 7]"
     " = order;\n"),
)
API = ('extern "C" int marks_copy(void* d, int n) { return int('
       'cudaMemcpyFromSymbol(d, g_marks, size_t(n) * 8)); }\n'
       'extern "C" int marks_clear() { static unsigned long long z[8192 * 8];'
       ' return int(cudaMemcpyToSymbol(g_marks, z, sizeof z)); }\n')


def marked_source(src: str) -> str:
    for anchor, text in MARKS:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in topk_router.cu: "
                             f"{anchor!r}")
        src = src.replace(anchor, anchor + text)
    return src + API


def bind(lib):
    lib.route_plan.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                               + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                               + [ctypes.c_void_p])
    lib.route_plan_workspace.argtypes = [ctypes.c_int] * 5
    lib.topk_router.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                + [ctypes.c_void_p])
    return lib


def launcher(torch, lib, t, e, k, cap, stats, plan=True):
    """A function launching ``lib``'s kernel once on fixed inputs."""
    dev = "cuda"
    x = torch.randn((t, e), device=dev)
    probs = torch.empty((t, k), device=dev)
    idx = torch.empty((t, k), dtype=torch.int32, device=dev)
    dest = torch.empty(t * k, dtype=torch.int32, device=dev)
    valid = torch.empty(t * k, dtype=torch.bool, device=dev)
    st = torch.empty(2 * e + 3, dtype=torch.int32, device=dev)
    words = lib.route_plan_workspace(t, e, k, int(stats), 0)
    ws = torch.zeros(max(words, 1), dtype=torch.int32, device=dev)
    s = torch.cuda.current_stream().cuda_stream
    if not plan:
        return lambda: lib.topk_router(x.data_ptr(), probs.data_ptr(),
                                       idx.data_ptr(), t, e, k, 0, s)
    return lambda: lib.route_plan(
        x.data_ptr(), probs.data_ptr(), idx.data_ptr(), dest.data_ptr(),
        valid.data_ptr(), st.data_ptr() if stats else None,
        ws.data_ptr() if words else None, t, e, k, cap, 1.0, 1.0, 0, 0, s)


def device_ms(torch, fn, iters=200):
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / iters


def main(argv) -> int:
    argparse.ArgumentParser(description="Phase timeline of the fused "
                            "router launch on the card.").parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("topk_router_timeline: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    out = ROOT / "build" / "topk_router_timeline"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "marked.cu", out / "libmarked.so"
    cu.write_text(marked_source(build.SOURCES["topk_router"].read_text()))
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True)
    lib = bind(ctypes.CDLL(str(so)))
    lib.marks_copy.argtypes = [ctypes.c_void_p, ctypes.c_int]
    print(torch.cuda.get_device_name(0), flush=True)
    for t, e, k, cap, stats in SHAPES:
        fn = launcher(torch, lib, t, e, k, cap, stats)
        for _ in range(30):
            fn()
        torch.cuda.synchronize()
        assert lib.marks_clear() == 0
        assert fn() == 0
        torch.cuda.synchronize()
        buf = np.zeros(8192 * 8, dtype=np.uint64)
        assert lib.marks_copy(buf.ctypes.data, buf.size) == 0
        d = buf.reshape(-1, 8).astype(np.int64)
        d = d[d[:, 0] > 0]
        rel = np.where(d[:, :7] > 0, d[:, :7] - d[:, 0].min(), -1)
        order = d[:, 7]
        nb = len(d)
        print(f"T {t} E {e} k {k} C {cap} stats {stats}: {nb} blocks, "
              f"last end {rel[:, 6].max()} ns")
        for o in sorted({0, 1, nb // 2, nb - 1} & set(range(nb))):
            i = int(np.nonzero(order == o)[0][0])
            print(f"  block {o}: " + " ".join(
                f"{n}={v}" for n, v in zip(PHASES, rel[i]) if v >= 0))
        have = [j for j in range(7) if (rel[:, j] >= 0).all()]
        for i, j in zip(have, have[1:]):
            dur = rel[:, j] - rel[:, i]
            print(f"  {PHASES[i]} -> {PHASES[j]}: median "
                  f"{int(np.median(dur))} ns, largest {int(dur.max())} ns")
    lib = bind(build.load("topk_router"))
    for t, e, k, _, _ in SHAPES[:5]:
        parts = {"topk": device_ms(torch, launcher(torch, lib, t, e, k, 8,
                                                   False, plan=False)),
                 "plan": device_ms(torch, launcher(torch, lib, t, e, k, 8,
                                                   False)),
                 "plan+stats": device_ms(torch, launcher(torch, lib, t, e,
                                                         k, 8, True))}
        print(f"device ms T {t} E {e} k {k}: " + " ".join(
            f"{n} {v:.5f}" for n, v in parts.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
