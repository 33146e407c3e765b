"""Builds the port's hand-written CUDA kernels and counts their launches.

Each kernel is one ``csrc/*.cu`` file with a plain C interface. At first
use ``nvcc`` compiles it for ``sm_90a`` into a shared library under
``build/repro_torch_kernels/<hash of the source and flags>/`` at the
root of the checkout (a directory ``.gitignore`` lists), and ``ctypes``
loads it. The build reads only the repository's sources, so a fresh
checkout builds itself; a changed source gets a new hash and a new
build. ``build()`` starts one ``nvcc`` per source, all at once.

``LAUNCHES`` counts, per kernel, the launches its wrapper made — one
per launch, nowhere else — so a run can show that its main path went
through the kernels. Under CUDA graph capture a wrapper call records
its launch instead of making it: ``recording()`` takes such calls back
out of the count and hands them to the caller, which adds them once per
replay (``replayed``), when the recorded launches run.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_ROOT = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# kernel library name -> its CUDA source
SOURCES: Dict[str, Path] = {
    "paged_decode": KERNELS_DIR / "paged_attention" / "csrc"
                    / "paged_decode.cu",
    "paged_mla_decode": KERNELS_DIR / "paged_attention" / "csrc"
                        / "paged_mla_decode.cu",
    "topk_router": KERNELS_DIR / "topk_router" / "csrc" / "topk_router.cu",
    "grouped_ffn": KERNELS_DIR / "grouped_ffn" / "csrc" / "grouped_ffn.cu",
    "flash_attention": KERNELS_DIR / "flash_attention" / "csrc"
                       / "flash_attention.cu",
}

LAUNCHES: collections.Counter = collections.Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


@contextlib.contextmanager
def recording() -> Iterator[collections.Counter]:
    """Around a CUDA graph capture: the wrapper calls made inside are
    recorded launches, not launches. They leave ``LAUNCHES`` as it was
    and fill the yielded counter, for ``replayed`` to add per replay."""
    before = collections.Counter(LAUNCHES)
    recorded: collections.Counter = collections.Counter()
    try:
        yield recorded
    finally:
        recorded.update(collections.Counter(LAUNCHES) - before)
        LAUNCHES.clear()
        LAUNCHES.update(before)


def replayed(recorded: collections.Counter) -> None:
    """One replay of a captured graph launched ``recorded``."""
    LAUNCHES.update(recorded)


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path("/usr/local/cuda/bin/nvcc")
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "build on a machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_ROOT / digest[:16] / f"lib{name}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` process each, all started together. Returns each
    built library's compile seconds (0.0 when it was already built)."""
    names = list(SOURCES if names is None else names)
    procs, secs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)           # atomic: readers never see half
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The kernel's loaded library, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
