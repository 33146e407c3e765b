"""Times the port's kernels on one NVIDIA card at ``chip_smoke.py``'s
shapes, without its serve and train phases:

    python3 tools/torch_kernel_bench.py [--fp32] [--root DIR]
        [--kernels decode,mla,ffn,flash,router,step]

Builds the kernels it times, then runs ``chip_smoke.py``'s checks (each
kernel against its plain version within its limit, timed beside its
plain version, its bound and, for attention,
``scaled_dot_product_attention``) and prints their ``kernel-case``
lines: the GQA paged decode (``decode``) and the MLA latent decode
(``mla``) at every phase-3 case of ``chip_smoke.py`` (the engine shapes,
with a window, 32 x 4096 and the GQA capacity case), each with its split
count and the device time of each CUDA launch a call makes (the decode
kernel, and the MLA kernel's merge where the splits are merged in a
second launch); the expert FFN (``ffn``) at
moe-gpt3-s's training chunk and serving capacity, at DeepSeek-V2-Lite's
experts and on both routed decode buffers; attention (``flash``) at the
training shape, with a window, with GQA and at head dim 128; an MoE
chunk's routing (``router``) at every shape of ``chip_smoke.ROUTE_SHAPES``
(fp32 logits, the path's capacity): the parent's ``route`` then
``dispatch_plan`` and, where the port has them, the fused ``route_plan``
launch (checked against its plain version) and ``route_and_plan``, with
the device time of each CUDA launch of each. ``step`` (not in the
default set) profiles 10 full-batch decode steps of full-width bf16
moe-gpt3-s and DeepSeek-V2-Lite, twice each (``chip_smoke.profile_decode``:
wall and device ms a step, kernels a step and a MoE layer). ``--fp32``
adds the fp32 cases of the kernel groups. For the bf16 expert-FFN cases
it also prints the device time of each of the kernel's launches (flags,
phase 1, phase 2). Exits non-zero without a card or when a case fails.
``--root`` times the port (``src/``: kernels and wrappers) of another
checkout of this repository with this checkout's checks, so that two
versions can be timed in turns on one card; cases that port does not
have are skipped.
"""
import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
KINDS = ("decode", "mla", "ffn", "flash", "router", "step")
LIBS = {"decode": "paged_decode", "mla": "paged_mla_decode",
        "ffn": "grouped_ffn", "flash": "flash_attention",
        "router": "topk_router"}     # "step" runs them all

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


def decode_breakdown(cs, torch, kind, case) -> None:
    """The split count and the device ms of each CUDA launch of one
    call."""
    from repro_torch.kernels.paged_attention import ops
    if kind == "decode":
        q, kp, vp = case["q"], case["k_pool"], case["v_pool"]
        pt, lens, w = case["page_table"], case["lens"], case["window"]

        def fn():
            return ops.paged_decode_attention(q, kp, vp, pt, lens, window=w)
        splits = (ops.paged_decode_splits(q, kp, pt, window=w)
                  if hasattr(ops, "paged_decode_splits") else None)
    else:
        qa, qr, cp, kp = (case[k] for k in ("q_abs", "q_rope", "ckv", "kr"))
        pt, lens = case["page_table"], case["lens"]

        def fn():
            return ops.paged_mla_decode(qa, qr, cp, kp, pt, lens,
                                        scale=case["scale"])
        splits = (ops.paged_mla_decode_splits(qa, qr, cp, pt)
                  if hasattr(ops, "paged_mla_decode_splits") else None)
    launches = launches_ms(torch, fn, iters=20)
    ms, wall = cs.cuda_ms(torch, fn, 50)
    cs.log(f"{kind} {case['name']} {case['dtype']} "
           f"window={case.get('window', 0)} splits={splits}: ms {ms:.5f} "
           f"wall_ms {wall:.5f} launches {launches}")


def router_group(cs, torch) -> None:
    """Each MoE chunk shape of ``cs.ROUTE_SHAPES``: the fused launch
    checked and timed (``check_route_plan``, whose row carries the
    parent's and this port's chunk routing) where the port has it, else
    the parent's routing alone (``route_paths``); then the device time of
    each CUDA launch of each routing."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline_moe import capacity_for
    from repro_torch.kernels import topk_router as kr
    from repro_torch.moe import dispatch as D
    from repro_torch.moe import router as R
    for case, arch, t, train in cs.ROUTE_SHAPES:
        cfg = get_config(arch)
        m = cfg.moe
        cap = capacity_for(t, m.top_k, m.capacity_factor, m.num_experts)
        if hasattr(kr, "route_plan"):
            cs.check_route_plan(torch, case, arch, t, cap, "float32", 7,
                                train)
        else:
            paths = cs.route_paths(torch, arch, t, cap, 7, train)
            cs.log(f"router {case} {json.dumps(paths)}")
        _, tokens, params = cs.route_inputs(torch, arch, t, 7, train)
        fns = {"parent": lambda: D.dispatch_plan(
            R.route(params, tokens, cfg)[1], m.num_experts, cap)}
        if hasattr(R, "route_and_plan"):
            fns["chunk"] = lambda: R.route_and_plan(params, tokens, cfg, cap)
        with torch.enable_grad() if train else torch.no_grad():
            for name, fn in fns.items():
                cs.log(f"router {case} {name} launches: "
                       f"{launches_ms(torch, fn, 20)}")


def step_group(cs, torch) -> None:
    """Two 10-step decode profiles of each model at full width, bf16."""
    import gc
    from repro_torch.serve import Engine, EngineOptions
    for arch in ("moe-gpt3-s", cs.DEEPSEEK):
        engine = Engine(cs.serve_config(arch=arch), options=EngineOptions(
            device="cuda", attn_kernel="auto", adaptive=False, **cs.ENGINE),
            seed=0)
        for run in range(2):
            cs.log(f"decode-profile {arch} run {run} "
                   + json.dumps(cs.profile_decode(torch, engine)))
        del engine
        gc.collect()
        torch.cuda.empty_cache()


def main(argv) -> int:
    ap = argparse.ArgumentParser(description="Time the port's kernels on "
                                 "the card.")
    ap.add_argument("--fp32", action="store_true",
                    help="also run the fp32 cases")
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose port to time (default: this one)")
    ap.add_argument("--kernels", default="decode,mla,ffn,flash,router",
                    help="comma-separated, of: " + ", ".join(KINDS))
    args = ap.parse_args(argv)
    kinds = set(args.kernels.split(","))
    if not kinds <= set(KINDS):
        ap.error(f"unknown kernels in {args.kernels}")
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs   # this checkout's checks; it puts src/ first
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    libs = None if "step" in kinds else sorted(LIBS[k] for k in kinds)
    cs.log(f"{args.root} ({build.__file__}): {torch.cuda.get_device_name(0)}"
           f"; build {build.build(libs)}")
    dtypes = ["bfloat16"] + (["float32"] if args.fp32 else [])
    if "decode" in kinds:
        for case in cs.kernel_cases(torch):
            if case["dtype"] in dtypes:
                cs.check_paged_decode(torch, case)
                decode_breakdown(cs, torch, "decode", case)
        torch.cuda.empty_cache()
    if "mla" in kinds:
        for case in cs.mla_cases(torch):
            if case["dtype"] in dtypes:
                cs.check_mla(torch, case)
                decode_breakdown(cs, torch, "mla", case)
        torch.cuda.empty_cache()
    for dtype in dtypes if kinds & {"ffn", "flash"} else []:
        for case, c in (("train", 40), ("serve", 8)) if "ffn" in kinds \
                else ():
            cs.check_grouped(torch, case, 64, c, 768, 3072, False, "gelu",
                             dtype, seed=c)
        if "ffn" in kinds:
            cs.check_grouped(torch, "deepseek", 64, 8, 2048, 1408, True,
                             "silu", dtype, seed=3)
        if "ffn" in kinds and dtype == "bfloat16":
            grouped_breakdown(cs, torch, 64, 40, 768, 3072, False, "gelu", 7)
            grouped_breakdown(cs, torch, 64, 8, 768, 3072, False, "gelu", 8)
            grouped_breakdown(cs, torch, 64, 8, 2048, 1408, True, "silu", 9)
            cs.check_routed(torch, "routed_decode_moe", "moe-gpt3-s", 4)
            cs.check_routed(torch, "routed_decode_deepseek", cs.DEEPSEEK, 5)
        for case, b, hq, kv, d, window in (
                ("train", 8, 8, 8, 96, 0), ("window256", 8, 8, 8, 96, 256),
                ("gqa4", 8, 8, 2, 96, 0), ("d128", 4, 16, 16, 128, 0)) \
                if "flash" in kinds else ():
            cs.check_flash(torch, case, b, 1024, hq, kv, d, window, dtype,
                           seed=6, library=window == 0 and kv == hq)
        torch.cuda.empty_cache()
    if "router" in kinds:
        router_group(cs, torch)
    if "step" in kinds:
        step_group(cs, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
