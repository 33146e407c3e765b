"""Checkpoints of a train state: per-host npz shards and a JSON
manifest, as ``repro.ckpt.checkpoint``, with the same file layout
(``step_%010d/shard_<h>.npz`` and ``manifest.json``, each leaf's shape
and dtype).

* atomic: a checkpoint is written to ``<dir>.tmp`` and then renamed, so
  a crash never leaves a half-written checkpoint as the latest;
* async: ``save`` copies every leaf to the host before it returns, and a
  background thread writes the copies. The copy is not optional here:
  the port's optimizers write the parameters and moments in place, so a
  thread that read the live tensors would save a later step's values.
  CUDA leaves go through pinned buffers and one synchronise;
* keep-k: only the newest ``keep`` checkpoints stay on disk.

A state nests dicts, lists and ``NamedTuple`` pairs (the 8-bit moments'
``Q8``); its leaves are tensors of a dtype numpy holds (fp32 and int8 in
a train state) and Python ints (``step``, ``count``), which are saved as
0-d arrays and come back as ``int``. Any other leaf raises.
``restore(step, like=state)`` copies into ``like``'s tensors in place,
on their devices, and returns the state; without ``like`` it returns
the flat ``{"key/path": array}`` dict, as the JAX package does. A
writer thread's error is raised by the next ``wait`` (or ``save``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

# torch dtypes whose tensors numpy holds as they are
_NUMPY = {torch.float64, torch.float32, torch.float16, torch.int64,
          torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool}


def _items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs; keys join dict keys, list indices and
    ``NamedTuple`` field names with ``/``."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], join(k))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _items(v, join(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, join(i))
    else:
        yield prefix, tree


def _to_host(state) -> Tuple[Dict[str, np.ndarray], int]:
    """Every leaf as a numpy array that nothing else writes (a copy), and
    their bytes. CUDA tensors are copied into pinned buffers with one
    synchronise at the end."""
    out: Dict[str, np.ndarray] = {}
    on_card = False
    for key, leaf in _items(state):
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype not in _NUMPY:
                raise TypeError(f"checkpoint leaf {key}: numpy cannot hold "
                                f"{leaf.dtype}")
            t = leaf.detach()
            if t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                on_card = True
            else:
                host = t.to("cpu", copy=True)
            out[key] = host.numpy()
        elif isinstance(leaf, (bool, np.bool_)):
            raise TypeError(f"checkpoint leaf {key}: a bool is not a step "
                            f"count")
        elif isinstance(leaf, (int, np.integer)):
            out[key] = np.asarray(leaf, dtype=np.int64)
        elif isinstance(leaf, np.ndarray):
            out[key] = np.array(leaf, copy=True)
        else:
            raise TypeError(f"checkpoint leaf {key}: cannot save a "
                            f"{type(leaf).__name__}")
    if on_card:
        torch.cuda.synchronize()
    return out, sum(a.nbytes for a in out.values())


def _fill(like, arrays: Dict[str, np.ndarray], prefix: str = ""):
    """``like`` with its tensors overwritten in place from ``arrays`` and
    its ints replaced; the containers are rebuilt, the tensors kept."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(like, dict):
        return {k: _fill(like[k], arrays, join(k)) for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_fill(v, arrays, join(k))
                            for k, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, arrays, join(i))
                          for i, v in enumerate(like))
    if prefix not in arrays:
        raise KeyError(f"checkpoint has no leaf {prefix!r}")
    arr = arrays[prefix]
    if isinstance(like, torch.Tensor):
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if src.shape != like.shape or src.dtype != like.dtype:
            raise ValueError(f"checkpoint leaf {prefix}: {src.dtype} "
                             f"{tuple(src.shape)}, the state holds "
                             f"{like.dtype} {tuple(like.shape)}")
        with torch.no_grad():
            like.copy_(src)
        return like
    if isinstance(like, (int, np.integer)):
        return int(arr)
    raise TypeError(f"checkpoint leaf {prefix}: cannot restore into a "
                    f"{type(like).__name__}")


class Checkpointer:
    """Saves and restores train states under ``directory``; see the
    module docstring. ``last_copy_s`` / ``last_bytes`` hold the blocking
    part of the latest ``save`` (the copy to the host) and
    ``last_write_s`` the writer thread's seconds of the latest finished
    write."""

    def __init__(self, directory: str, keep: int = 3,
                 host_index: int = 0, num_hosts: int = 1):
        self.dir = directory
        self.keep = keep
        self.host_index = host_index
        self.num_hosts = num_hosts
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.last_copy_s = 0.0
        self.last_bytes = 0
        self.last_write_s = 0.0

    # ---------------- save ----------------
    def save(self, step: int, state, block: bool = False) -> None:
        self.wait()
        t0 = time.perf_counter()
        arrays, nbytes = _to_host(state)
        self.last_copy_s = time.perf_counter() - t0
        self.last_bytes = nbytes

        def _write():
            t1 = time.perf_counter()
            try:
                path = os.path.join(self.dir, f"step_{step:010d}")
                tmp = path + ".tmp"
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, f"shard_{self.host_index}.npz"),
                         **arrays)
                manifest = {
                    "step": step,
                    "num_hosts": self.num_hosts,
                    "leaves": {k: {"shape": list(v.shape),
                                   "dtype": str(v.dtype)}
                               for k, v in arrays.items()},
                }
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(path):
                    shutil.rmtree(path)
                os.rename(tmp, path)                 # atomic publish
                self._gc()
            except Exception as e:                   # raised by wait()
                self._error = e
            self.last_write_s = time.perf_counter() - t1

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self) -> None:
        """Waits for the writer thread; raises the error it met, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _gc(self) -> None:
        steps = sorted(self.list_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---------------- restore ----------------
    def list_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore(self, step: int, like=None, shardings=None):
        if shardings is not None:
            raise NotImplementedError(
                "restoring onto target shardings comes with ROADMAP.md's "
                "'Expert parallelism' slice")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        arrays: Dict[str, np.ndarray] = {}
        for h in range(manifest["num_hosts"]):
            fn = os.path.join(path, f"shard_{h}.npz")
            if os.path.exists(fn):
                with np.load(fn) as z:
                    arrays.update({k: z[k] for k in z.files})
        return _fill(like, arrays) if like is not None else arrays

    def restore_latest(self, abstract=None, like=None, shardings=None):
        """The newest checkpoint as ``{"step", "state"}``, or None.
        ``abstract`` is accepted and ignored, as in the JAX package."""
        steps = self.list_steps()
        if not steps:
            return None
        step = steps[-1]
        return {"step": step,
                "state": self.restore(step, like=like, shardings=shardings)}
