"""Checkpoints of a train state: npz shards and a JSON manifest, as
``repro.ckpt.checkpoint`` (``step_%010d/shard_<r>.npz`` and
``manifest.json``, each leaf's global shape and dtype), in the
multi-host form its docstring sketches: slices keyed by global offset.

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

One device is one rank that holds every leaf whole (``WHOLE``, the
default of ``save`` and ``restore``); over ranks ``shardings`` is this
rank's ``Layout`` (``runtime.train_loop.state_layout``):

* ``save``: each rank copies to the host only the leaves it alone
  writes (``Layout.owns``: its expert and ZeRO-3 slices and their
  optimizer state; a leaf that several ranks hold by its lowest rank,
  the replicated ones by rank 0) and writes them to
  ``step_N.tmp/shard_<rank>.npz`` with ``part_<rank>.json``, each leaf's
  global shape and its slice's offset. Rank 0's writer waits for every
  rank's part (the file system is the rendezvous: a writer thread never
  calls a collective, which would interleave with the step's), merges
  them into ``manifest.json`` (``leaves``: global shapes; ``slices``:
  each leaf's files and offsets), publishes with one rename and keeps
  ``keep`` checkpoints; every other rank's writer waits for that
  manifest, so that ``wait`` on any rank means published. ``save``
  itself makes one collective over ranks, in the calling thread: rank 0
  clears the step's ``.tmp`` and broadcasts a fresh id that marks this
  save's parts and manifest. Every wait is bounded (``RANKS_TIMEOUT_S``).
* ``restore``: each rank reads only the slices that overlap its part of
  each leaf (``Layout.cut``), from any checkpoint of the same model,
  saved on the same mesh, on another one or on one device; without
  ``like``, into the flat dict of whole leaves.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import shutil
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the longest a writer waits for the other ranks' files (a rank that
# died before writing its part must not hang the others for ever)
RANKS_TIMEOUT_S = 600.0

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


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where one rank's train state lies in the whole one, for ``save``
    and ``restore`` over ranks. ``cut(key, ndim)``: the leaf's cuts,
    ``(axis, index, parts)`` each (this rank holds part ``index`` of
    ``parts`` equal parts along ``axis``), ``()`` for a whole leaf.
    ``owns(key, ndim)``: whether this rank writes the leaf. ``rank`` and
    ``world`` are the default group's; ``device`` holds the tensor of
    ``agree``'s broadcast."""
    rank: int
    world: int
    cut: Callable[[str, int], tuple]
    owns: Callable[[str, int], bool]
    device: Any = "cpu"

    def region(self, key: str, shape) -> Tuple[list, list]:
        """(global shape, this rank's offset) of a leaf shaped ``shape``
        here."""
        whole, start = list(shape), [0] * len(shape)
        for axis, i, n in self.cut(key, len(shape)):
            whole[axis], start[axis] = shape[axis] * n, shape[axis] * i
        return whole, start

    def agree(self, value: int) -> int:
        """Rank 0's ``value`` on every rank (collective over ranks)."""
        if self.world == 1:
            return value
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        dist.broadcast(t, src=0)
        return int(t.item())


# one device: one rank that holds and writes every leaf whole
WHOLE = Layout(rank=0, world=1, cut=lambda key, ndim: (),
               owns=lambda key, ndim: True)


def _ndim(leaf) -> int:
    return leaf.dim() if isinstance(leaf, torch.Tensor) else np.ndim(leaf)


def _to_host(items: Iterable[Tuple[str, Any]]
             ) -> Tuple[Dict[str, np.ndarray], int]:
    """Every leaf as a numpy array that nothing else writes (a copy), and
    their bytes. CUDA tensors are copied into pinned buffers with one
    synchronise at the end."""
    out: Dict[str, np.ndarray] = {}
    on_card = False
    for key, leaf in items:
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


def _fill(like, read: Callable, prefix: str = ""):
    """``like`` with its tensors overwritten in place from ``read(key,
    leaf)`` (this rank's part of the leaf, as numpy) and its ints
    replaced; the containers are rebuilt, the tensors kept."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(like, dict):
        return {k: _fill(like[k], read, join(k)) for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_fill(v, read, join(k))
                            for k, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, read, join(i))
                          for i, v in enumerate(like))
    arr = read(prefix, like)
    if isinstance(like, torch.Tensor):
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if src.dtype != like.dtype:
            raise ValueError(f"checkpoint leaf {prefix}: {src.dtype}, the "
                             f"state holds {like.dtype}")
        with torch.no_grad():
            like.copy_(src)
        return like
    if isinstance(like, (int, np.integer)):
        return int(arr)
    raise TypeError(f"checkpoint leaf {prefix}: cannot restore into a "
                    f"{type(like).__name__}")


class _Reader:
    """A checkpoint's leaves by part: ``read(key, start, shape)`` is the
    region of the whole leaf at ``start``, assembled from the slices
    that overlap it (each file opened once, each slice loaded only
    where it overlaps a region asked for)."""

    def __init__(self, path: str, manifest: dict):
        self.path = path
        self.leaves = manifest["leaves"]
        self.slices = manifest["slices"]
        self.files: Dict[str, Any] = {}

    def _file(self, name: str):
        if name not in self.files:
            self.files[name] = np.load(os.path.join(self.path, name))
        return self.files[name]

    def read(self, key: str, start, shape) -> np.ndarray:
        if key not in self.leaves:
            raise KeyError(f"checkpoint has no leaf {key!r}")
        for sl in self.slices.get(key, ()):      # one slice, the region
            if list(sl["start"]) == list(start) and \
                    list(sl["shape"]) == list(shape):
                return self._file(sl["file"])[key]
        out = np.empty(shape, dtype=np.dtype(self.leaves[key]["dtype"]))
        covered = 0
        for sl in self.slices.get(key, ()):
            lo = [max(a, b) for a, b in zip(sl["start"], start)]
            hi = [min(a + n, b + m) for a, n, b, m in
                  zip(sl["start"], sl["shape"], start, shape)]
            if any(x >= y for x, y in zip(lo, hi)):
                continue
            src = self._file(sl["file"])[key]
            out[tuple(slice(x - b, y - b) for x, y, b in
                      zip(lo, hi, start))] = src[tuple(
                          slice(x - a, y - a) for x, y, a in
                          zip(lo, hi, sl["start"]))]
            covered += math.prod(y - x for x, y in zip(lo, hi))
        if covered != math.prod(shape):
            raise ValueError(f"checkpoint leaf {key}: its slices cover "
                             f"{covered} of the {math.prod(shape)} "
                             f"elements asked for")
        return out

    def close(self) -> None:
        for f in self.files.values():
            f.close()


def _write_json(path: str, obj) -> None:
    """Written whole or not at all (a reader polls for it)."""
    with open(path + ".part", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".part", path)


def _load_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


class Checkpointer:
    """Saves and restores train states under ``directory``; see the
    module docstring. ``last_copy_s`` / ``last_bytes`` hold the blocking
    part of the latest ``save`` (over ranks: the broadcast and this
    rank's copy to the host) and its bytes, ``last_write_s`` the writer
    thread's seconds of the latest finished write (over ranks, on rank 0
    the wait for every rank's part included)."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.last_copy_s = 0.0
        self.last_bytes = 0
        self.last_write_s = 0.0

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    # ---------------- save ----------------
    def save(self, step: int, state, block: bool = False,
             shardings: Layout = WHOLE) -> None:
        """Copies this rank's part of ``state`` (as ``shardings`` says)
        to the host and writes it in a thread; ``block`` waits for the
        write."""
        self.wait()
        t0 = time.perf_counter()
        path = self._path(step)
        lay = shardings
        if lay.rank == 0:
            shutil.rmtree(path + ".tmp", ignore_errors=True)
            os.makedirs(path + ".tmp")
        nonce = lay.agree(random.getrandbits(62) if lay.rank == 0 else 0)
        arrays, nbytes = _to_host((k, v) for k, v in _items(state)
                                  if lay.owns(k, _ndim(v)))
        part = {}
        for k, a in arrays.items():
            whole, start = lay.region(k, a.shape)
            part[k] = {"shape": whole, "dtype": str(a.dtype),
                       "start": start, "size": list(a.shape)}
        self.last_copy_s = time.perf_counter() - t0
        self.last_bytes = nbytes

        def run():
            t1 = time.perf_counter()
            try:
                self._write(step, path, arrays, part, nonce, lay)
            except Exception as e:                   # raised by wait()
                self._error = e
            self.last_write_s = time.perf_counter() - t1

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def _write(self, step: int, path: str, arrays, part, nonce: int,
               lay: Layout) -> None:
        tmp = path + ".tmp"
        np.savez(os.path.join(tmp, f"shard_{lay.rank}.npz"), **arrays)
        _write_json(os.path.join(tmp, f"part_{lay.rank}.json"),
                    {"nonce": nonce, "leaves": part})
        if lay.rank != 0:                  # published when rank 0 has
            self._await(lambda: (_load_json(os.path.join(
                path, "manifest.json")) or {}).get("nonce") == nonce,
                f"step {step}'s manifest")
            return
        parts: Dict[int, dict] = {}

        def arrived() -> bool:
            for r in range(lay.world):
                if r not in parts:
                    got = _load_json(os.path.join(tmp, f"part_{r}.json"))
                    if got is not None and got["nonce"] == nonce:
                        parts[r] = got
            return len(parts) == lay.world

        self._await(arrived, f"step {step}'s parts from {lay.world} ranks")
        manifest = {"step": step, "num_hosts": lay.world, "nonce": nonce,
                    "leaves": {}, "slices": {}}
        for r in sorted(parts):
            for k, v in parts[r]["leaves"].items():
                manifest["leaves"][k] = {"shape": v["shape"],
                                         "dtype": v["dtype"]}
                manifest["slices"].setdefault(k, []).append(
                    {"file": f"shard_{r}.npz", "start": v["start"],
                     "shape": v["size"]})
            os.remove(os.path.join(tmp, f"part_{r}.json"))
        _write_json(os.path.join(tmp, "manifest.json"), manifest)
        self._publish(tmp, path)

    def _publish(self, tmp: str, path: str) -> None:
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)                         # atomic publish
        self._gc()

    def _await(self, done: Callable[[], bool], what: str) -> None:
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        while not done():
            if time.monotonic() > deadline:
                raise TimeoutError(f"checkpoint: waited {RANKS_TIMEOUT_S} "
                                   f"s for {what}")
            time.sleep(0.005)

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
            shutil.rmtree(self._path(s), ignore_errors=True)

    # ---------------- restore ----------------
    def list_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore(self, step: int, like=None, shardings: Layout = WHOLE):
        """Step ``step``'s state: this rank's part (as ``shardings``
        says) copied into ``like`` in place, or without ``like`` the flat
        dict of whole leaves."""
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        reader = _Reader(path, manifest)
        try:
            if like is None:
                return {k: reader.read(k, [0] * len(v["shape"]),
                                       v["shape"])
                        for k, v in manifest["leaves"].items()}

            def read(key, leaf):
                shape = list(np.shape(leaf))
                whole, start = shardings.region(key, shape)
                if key in reader.leaves and \
                        reader.leaves[key]["shape"] != whole:
                    raise ValueError(
                        f"checkpoint leaf {key}: shape "
                        f"{tuple(reader.leaves[key]['shape'])}, the state "
                        f"holds {tuple(whole)}")
                return reader.read(key, start, shape)
            return _fill(like, read)
        finally:
            reader.close()

    def restore_latest(self, abstract=None, like=None,
                       shardings: Layout = WHOLE):
        """The newest checkpoint as ``{"step", "state"}``, or None, after
        this checkpointer's own write has finished (over ranks: been
        published, so every rank sees the same steps). ``abstract`` is
        accepted and ignored, as in the JAX package."""
        self.wait()
        steps = self.list_steps()
        if not steps:
            return None
        step = steps[-1]
        return {"step": step,
                "state": self.restore(step, like=like, shardings=shardings)}
