"""Training runtime: state, the train step, the online adaptive
``(n, strategy)`` controller and the host loop, as
``repro.runtime.train_loop``.

Step semantics: fp32 parameters, compute in ``cfg.compute_dtype``, MoE
auxiliary losses folded into the objective by ``lm.loss_fn``, AdamW with
the linear-warmup cosine schedule. PyTorch runs eagerly, so there is no
jit: ``make_train_step`` returns a plain function, and its update writes
the state's parameters and moments in place (``optim.adamw``).

Online adaptation (paper §III-C Algorithm 1 + §III-E): when the config
leaves ``num_partitions == 0`` or ``memory_reuse_strategy ==
"adaptive"``, an :class:`AdaptiveController` resolves the concrete
(n, strategy) at runtime — on every batch-shape change and, optionally,
every ``retune_every`` steps — through a persistent
``core.selector.Resolver``, and builds a step only when the resolved
(n, strategy, batch shape) key is new (an LRU of step functions).

Checkpoint/restart (``train(checkpointer=...)``) follows the JAX loop:
restore at start, a save every ``ckpt_every`` steps and a blocking save
at the end, and a roll-back to the latest checkpoint when a step fails
past its retries or in its optimizer update.

Under a ``DistContext`` (``dist``) each rank holds its shard of the
parameters (``convert.shard_tree``) and takes its data-parallel rows of
every global batch. Its loss is its share of the whole batch's
(``lm.loss_fn``), so every gradient reduction is a sum:

* dense leaves: the same on every rank of an EP group; summed over the
  world and divided by ``ep`` (a sum over dp that leaves every replica
  bit-equal);
* router and shared-expert leaves, which carry only this rank's part
  of the loss (its tokens): summed over the world;
* expert leaves: complete per EP rank through the All-to-All's
  transpose; a ZeRO-3 shard is summed over dp by its gather's
  reduce-scatter, any other expert leaf by an ``all_reduce`` over dp.

``compress_grads`` then quantizes the reduced gradients, as the JAX step
does the global ones (a ZeRO-3 row takes its maximum over dp), and the
grad norm sums each sharded leaf over its group and each replicated one
once. The 8-bit AdamW and Adafactor take each expert leaf's
``optim.groups.Split`` (``_splits``) and reduce the statistics that span
its split axes over the ranks that hold them; the replicated leaves
need no collective. Checkpoints under ``dist`` write each rank's part
and restore onto any mesh (``state_layout``, a ``ckpt.Layout``).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.ckpt import Layout
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import leaf_cut, shard_tree
from repro_torch.core.selector import Resolver
from repro_torch.core.types import GPU_H100, HardwareSpec, Strategy
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import slowest
from repro_torch.distributed.compression import compress_with_feedback
from repro_torch.models import lm
from repro_torch.models.module import leaves, unflatten
from repro_torch.moe.layer import zero3_ok
from repro_torch.obs import Recorder
from repro_torch.optim import get_optimizer, lr_schedule
from repro_torch.optim.groups import Split, paths

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class TrainOptions:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    compress_grads: bool = False
    grad_accum: int = 1              # microbatching (PP-free memory lever)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def init_state(cfg: ArchConfig, opts: TrainOptions, *, seed: int = 0,
               params=None, device=None, dist=None) -> Dict[str, Any]:
    """Parameters (``lm.init`` from ``seed``, or ``params`` as given —
    e.g. ``convert.from_jax`` of the JAX package's), the optimizer's
    zero state and step 0, on ``device`` (default ``cuda``; under
    ``dist`` the context's). Under ``dist`` the whole ``params`` (or the
    seeded init, the same on every rank) are cut to this rank's shard.
    With ``compress_grads`` the state holds ``grad_err``, the
    compression's carried error (fp32 zeros shaped as the parameters)."""
    dev = resolve_device(device if device is not None or dist is None
                         else dist.device)
    if params is None:
        params = lm.init(cfg, seed, device=dev)
    if dist is not None:
        params = shard_tree(params, cfg, dist)
    params = _map(params, lambda p: p.detach().to(dev).requires_grad_(True))
    opt_mod, ocfg = get_optimizer(cfg.optimizer, opts.lr)
    state = {"params": params, "opt": opt_mod.init(params, ocfg), "step": 0}
    if opts.compress_grads:
        state["grad_err"] = _map(params, lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device))
    return state


def _kind(path, expert: str) -> str:
    if leaf_cut(path, False) is not None:
        return expert
    return "local" if "moe" in path else "dense"


def _leaf_kinds(params, cfg: ArchConfig, dist) -> list:
    """Each leaf's part in the gradient reductions, in ``leaves`` order:
    ``dense``, ``local`` (router and shared experts: this rank's tokens
    only), ``expert`` or ``expert_z3`` (a ZeRO-3 shard,
    ``moe.layer.zero3_ok``)."""
    expert = "expert_z3" if zero3_ok(cfg, dist) else "expert"
    return [_kind(path, expert) for path, _ in paths(params)]


def _splits(cfg: ArchConfig, dist) -> Optional[Callable]:
    """The optimizers' ``split``: an expert leaf (or stacked group, by
    path) is cut over the EP group on its leading axis and, a ZeRO-3
    shard, over dp on its last (the whole leaf then over the world);
    every other leaf is whole on every rank."""
    if dist is None:
        return None
    if zero3_ok(cfg, dist):
        cut = Split(dist.dp_group, dist.dp_size,
                    torch.distributed.group.WORLD, dist.world_size)
    elif dist.ep_size > 1:
        cut = Split(whole=dist.ep_group, whole_ranks=dist.ep_size)
    else:
        return None
    return lambda path: cut if leaf_cut(path, False) is not None else None


def state_layout(cfg: ArchConfig, dist) -> Layout:
    """This rank's ``ckpt.Layout`` of a train state (``convert.leaf_cut``):
    a leaf cut over the experts is written by the first rank of the dp
    group, one cut over both by every rank, a whole one by rank 0."""
    zero3 = zero3_ok(cfg, dist)

    def cut(key: str, ndim: int) -> tuple:
        c = leaf_cut(key.split("/"), zero3)
        if c is None:
            return ()
        parts = [(c[0], dist.ep_rank, dist.ep_size)]
        if c[1]:
            parts.append((ndim - 1, dist.dp_rank, dist.dp_size))
        return tuple(p for p in parts if p[2] > 1)

    def owns(key: str, ndim: int) -> bool:
        c = leaf_cut(key.split("/"), zero3)
        split_ep = c is not None and dist.ep_size > 1
        split_dp = c is not None and c[1] and dist.dp_size > 1
        return ((split_ep or dist.ep_rank == 0)
                and (split_dp or dist.dp_rank == 0))

    return Layout(rank=dist.rank, world=dist.world_size, cut=cut,
                  owns=owns, device=dist.device)


def _reduce_grads(grads: list, kinds: list, dist) -> list:
    """The gradient reductions of the module docstring (NCCL takes
    contiguous tensors only; a backward may give a strided one)."""
    ep = dist.ep_size
    grads = [g.contiguous() for g in grads]
    for g, kind in zip(grads, kinds):
        if kind == "dense":
            torch.distributed.all_reduce(g)
            if ep > 1:
                g.div_(ep)
        elif kind == "local":
            torch.distributed.all_reduce(g)
        elif kind == "expert" and dist.dp_size > 1:
            torch.distributed.all_reduce(g, group=dist.dp_group)
    return grads


def _grad_sq(grads: list, kinds: list, dist) -> torch.Tensor:
    """The squared norm of the whole gradient tree: replicated leaves
    counted once, each shard summed over the ranks it is split over."""
    same = torch.zeros((), device=grads[0].device)
    split = torch.zeros((), device=grads[0].device)
    for x, kind in zip(grads, kinds):
        if kind.startswith("expert") and dist is not None:
            split = split + torch.sum(x * x)
        else:
            same = same + torch.sum(x * x)
    if dist is not None:
        z3 = "expert_z3" in kinds
        torch.distributed.all_reduce(split, group=None if z3
                                     else dist.ep_group)
    return same + split


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _step_parts(cfg: ArchConfig, opts: TrainOptions, dist=None):
    """The two halves of a train step: ``grads(params, batch)`` — loss and
    backward (and under ``dist`` the gradient reductions), which write
    nothing — and ``update(state, grads, metrics)``, which writes the
    parameters, moments and compression error in place."""
    opt_mod, ocfg = get_optimizer(cfg.optimizer, opts.lr)
    split = _splits(cfg, dist)

    def grads_of(params, batch):
        flat = leaves(params)
        n = opts.grad_accum
        if batch["tokens"].shape[0] % n:
            raise ValueError(f"batch {batch['tokens'].shape[0]} does not "
                             f"split into grad_accum={n} microbatches")
        mb = batch["tokens"].shape[0] // n
        grads = None
        metrics: Dict[str, torch.Tensor] = {}
        for i in range(n):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, m = lm.loss_fn(params, micro, cfg, dist)
            g = torch.autograd.grad(loss, flat, allow_unused=True)
            g = [torch.zeros_like(p) if x is None else x.float()
                 for x, p in zip(g, flat)]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v.detach()
            del loss, m, g
        if n > 1:
            grads = [x / n for x in grads]
            metrics = {k: v / n for k, v in metrics.items()}
        if dist is not None:
            grads = _reduce_grads(grads, _leaf_kinds(params, cfg, dist),
                                  dist)
        return grads, metrics

    def update(state, grads, metrics):
        params = state["params"]
        kinds = _leaf_kinds(params, cfg, dist)
        new_state = dict(state)
        if opts.compress_grads:
            z3 = dist.dp_group if dist is not None else None
            amax = {p for (p, _), k in zip(paths(params), kinds)
                    if k == "expert_z3"}
            tree, err = compress_with_feedback(
                unflatten(params, grads), state.get("grad_err"),
                amax_group=lambda path: z3 if path in amax else None)
            grads = leaves(tree)
            new_state["grad_err"] = err
        scale = lr_schedule(state["step"], warmup=opts.warmup,
                            total=opts.total_steps)
        gnorm = _grad_sq(grads, kinds, dist)
        # the tree, not the flat leaves: the 8-bit AdamW and Adafactor
        # read the period leaves as JAX's stacked ones (optim.groups)
        opt = opt_mod.update(unflatten(params, grads), state["opt"], params,
                             ocfg, lr_scale=scale, split=split)
        new_state.update(opt=opt, step=state["step"] + 1)
        out = {k: float(v) for k, v in metrics.items()}
        out.update(grad_norm=float(torch.sqrt(gnorm)), lr_scale=scale)
        return new_state, out

    return grads_of, update


def make_train_step(cfg: ArchConfig, opts: TrainOptions,
                    dist=None) -> Callable:
    """``step(state, batch) -> (state, metrics)``; ``batch`` holds device
    tensors ``tokens`` and ``labels`` ``[B, S]`` (under ``dist``, this
    rank's rows). Metrics (python floats, the whole batch's): ``ce``,
    ``aux_loss``, ``z_loss``, ``loss``, ``grad_norm``, ``lr_scale``.
    With ``grad_accum`` > 1 the batch is split along B and the gradients
    and metrics are averaged over the microbatches."""
    grads_of, update = _step_parts(cfg, opts, dist)

    def train_step(state, batch):
        grads, metrics = grads_of(state["params"], batch)
        return update(state, grads, metrics)

    return train_step


# ---------------------------------------------------------------------------
# Online adaptive (n, strategy) controller
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdaptiveOptions:
    """Knobs of the online controller (paper §III-C + §III-E).

    retune_every == 0 retunes only on batch-shape change; k > 0 also
    re-runs ``resolve`` every k steps (workload drift without shape
    drift — e.g. interference from a colocated job).
    ``measure``: "wallclock" times a few candidate steps' gradients on
    the training device, "simulate" uses the analytic pipeline
    simulator, "auto" picks wallclock iff the state lies on a CUDA
    device.
    """
    retune_every: int = 0
    ep_size: int = 1
    dp: int = 1
    hw: HardwareSpec = GPU_H100
    measure: str = "auto"            # auto | wallclock | simulate
    measure_fn: Optional[Callable[[int, int, Strategy], float]] = None
    measure_steps: int = 2
    allow_offload: Optional[bool] = None
    candidates: Optional[Sequence[int]] = None
    cache_size: int = 32             # LRU bound on kept step functions
    obs: Optional[Recorder] = None   # telemetry recorder shared with
                                     # the resolver (None = private
                                     # metrics-only recorder)


StepParts = Tuple[Callable, Callable]     # (grads_of, update)


class AdaptiveController:
    """Feedback loop between the granularity searcher, the perf model and
    the step function: resolves (n, strategy) online and keeps an LRU of
    step functions keyed by (n, strategy, batch shape), so a step is
    built at most once per distinct configuration while it stays cached
    (``rejit_count`` counts the builds, under the JAX package's name).

    ``device`` is the training device; it is read only to resolve
    ``measure="auto"`` (``None``: the card, raising without CUDA).

    Under ``dist`` the EP and dp extents come from the context unless
    the options set them (as in the JAX controller), the resolver is
    given the whole batch's token count (JAX's batch is global), and
    every candidate's measured time is the maximum over the world, so
    that every rank picks the same ``(n, strategy)``.
    """

    def __init__(self, cfg: ArchConfig, opts: TrainOptions,
                 aopts: Optional[AdaptiveOptions] = None, *,
                 device=None, dist=None):
        if cfg.moe is None or not cfg.moe.pipeline:
            # with pipeline=False every candidate n runs as n=1 — the
            # granularity search would be meaningless
            raise ValueError("AdaptiveController needs a pipelined MoE "
                             "config (cfg.moe with pipeline=True)")
        self.cfg = cfg
        self.opts = opts
        self.dist = dist
        self.aopts = aopts or AdaptiveOptions()
        if dist is not None:
            if self.aopts.ep_size == 1:
                self.aopts = dataclasses.replace(self.aopts,
                                                 ep_size=dist.ep_size)
            if self.aopts.dp == 1:
                self.aopts = dataclasses.replace(self.aopts,
                                                 dp=dist.dp_size)
            if device is None:
                device = dist.device
        measure_fn = self.aopts.measure_fn
        if measure_fn is None:
            mode = self.aopts.measure
            if mode == "auto":
                mode = ("wallclock" if resolve_device(device).type == "cuda"
                        else "simulate")
            if mode not in ("wallclock", "simulate"):
                raise ValueError(f"measure must be auto, wallclock or "
                                 f"simulate, not {mode!r}")
            if mode == "wallclock":
                measure_fn = self._wallclock_measure
        if dist is not None and measure_fn is not None:
            measure_fn = slowest(measure_fn, resolve_device(device))
        self.obs = (self.aopts.obs if self.aopts.obs is not None
                    else Recorder())
        self.resolver = Resolver(cfg, ep_size=self.aopts.ep_size,
                                 hw=self.aopts.hw, measure_fn=measure_fn,
                                 dp=self.aopts.dp,
                                 allow_offload=self.aopts.allow_offload,
                                 candidates=self.aopts.candidates,
                                 obs=self.obs)
        self._step_cache: Dict[Tuple, StepParts] = {}
        self._probe = None               # (state, batch) for wallclock
        self._last_shape = None
        self._last_refresh = None
        self.current: Optional[Tuple[int, str]] = None
        self.rejit_count = 0
        self.retune_count = 0

    def _cache_get(self, key: Tuple) -> Optional[StepParts]:
        """LRU: dicts iterate in insertion order; re-insert on hit."""
        fn = self._step_cache.pop(key, None)
        if fn is not None:
            self._step_cache[key] = fn
        return fn

    def _cache_put(self, key: Tuple, fn: StepParts) -> None:
        self._step_cache[key] = fn
        while len(self._step_cache) > max(1, self.aopts.cache_size):
            self._step_cache.pop(next(iter(self._step_cache)))

    @staticmethod
    def _shape_key(batch) -> Tuple:
        return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                            for k, v in batch.items()))

    def _local_tokens(self, batch) -> int:
        x = batch["tokens"] if "tokens" in batch else \
            next(iter(batch.values()))
        rows = int(x.shape[0]) * (self.dist.dp_size if self.dist else 1)
        return rows * (int(x.shape[1]) if x.ndim > 1 else 1)

    def _cfg_with(self, n: int, strategy: str) -> ArchConfig:
        return dataclasses.replace(
            self.cfg, moe=dataclasses.replace(
                self.cfg.moe, num_partitions=n,
                memory_reuse_strategy=strategy))

    def _wallclock_measure(self, b: int, n: int,
                           strategy: Strategy) -> float:
        """Algorithm 1's measure function on the training device: the
        seconds of candidate (n, strategy)'s loss and backward,
        ``grads_of(params, batch)`` of ``_step_parts``, on the live
        (state, batch). ``b`` equals the probe batch's token count by
        construction (the searcher is queried at the current size).

        The JAX package times whole jitted steps against an undonated
        state. Here the update writes the parameters and AdamW moments
        in place, and a copy of the state is as large as the state, so
        the update is left out: it is the same work for every candidate
        and does not move the argmin. ``grads_of`` writes nothing. One
        warm-up call, then ``measure_steps`` calls, each call's
        gradients freed before the next; timed with CUDA events on the
        current stream on the card, with the host clock on the CPU."""
        state, batch = self._probe
        grads_of, _ = _step_parts(self._cfg_with(n, strategy.value),
                                  self.opts, self.dist)
        params = state["params"]

        def once():
            grads, metrics = grads_of(params, batch)
            del grads, metrics

        reps = max(1, self.aopts.measure_steps)
        once()                                     # warm-up
        if leaves(params)[0].device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                once()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            once()
        return (time.perf_counter() - t0) / reps

    def step_fn(self, state, batch, step: int
                ) -> Tuple[StepParts, Dict[str, Any]]:
        """The step's halves ``(grads_of, update)`` (``_step_parts``) and
        the controller's metrics for this batch."""
        shape = self._shape_key(batch)
        shape_changed = self.current is None or shape != self._last_shape
        # timer fires on its own clock, independent of shape churn — a
        # cyclic-shape trace must not starve drift re-measurement
        timer = (self.aopts.retune_every > 0
                 and self._last_refresh is not None
                 and step - self._last_refresh >= self.aopts.retune_every)
        info: Dict[str, Any] = {}
        if shape_changed or timer:
            t0 = time.perf_counter()
            self._probe = (state, batch)
            # a timer-triggered retune re-measures (refresh): cached
            # timings are exactly what workload drift invalidates
            try:
                rcfg = self.resolver.resolve(self._local_tokens(batch),
                                             refresh=timer)
            finally:
                self._probe = None
            resolved = (rcfg.moe.num_partitions,
                        rcfg.moe.memory_reuse_strategy)
            if resolved != self.current:
                log.info("adaptive retune @%d: (n, strategy) %s -> %s",
                         step, self.current, resolved)
            self.current = resolved
            self._last_shape = shape
            if timer or self._last_refresh is None:
                self._last_refresh = step
            self.retune_count += 1
            info["retune_time_s"] = time.perf_counter() - t0
        n, strategy = self.current
        key = (n, strategy, shape)
        fn = self._cache_get(key)
        if fn is None:
            fn = _step_parts(self._cfg_with(n, strategy), self.opts,
                             self.dist)
            self._cache_put(key, fn)
            self.rejit_count += 1
        info.update(n=n, strategy=strategy)
        return fn, info


def _any_rank(failed: bool, dist) -> bool:
    """Whether this step failed on any rank: one flag ``all_reduce``
    (MAX) over the world."""
    flag = torch.tensor([float(failed)], device=dist.device)
    torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
    return bool(flag.item())


def _rows(batch: Dict[str, np.ndarray], dist) -> Dict[str, np.ndarray]:
    """This rank's data-parallel rows of a global batch."""
    if dist is None or dist.dp_size == 1:
        return batch
    b = next(iter(batch.values())).shape[0]
    if b % dist.dp_size:
        raise ValueError(f"batch {b} does not split over dp="
                         f"{dist.dp_size}")
    n = b // dist.dp_size
    return {k: v[dist.dp_rank * n:(dist.dp_rank + 1) * n]
            for k, v in batch.items()}


def train(cfg: ArchConfig, *, steps: int, batch_source,
          opts: Optional[TrainOptions] = None, checkpointer=None,
          ckpt_every: int = 100, max_retries: int = 2,
          heartbeat: Optional[Callable[[int, Dict], None]] = None,
          state=None, adaptive=None, device=None, dist=None):
    """Run ``steps`` training steps with checkpoint/restart semantics.

    ``batch_source.batch_at(step)`` must be deterministic (seekable).
    ``adaptive`` selects the online (n, strategy) controller: ``None``
    turns it on when cfg.moe still carries adaptive placeholders
    (``num_partitions == 0`` or ``memory_reuse_strategy ==
    "adaptive"``); ``False`` forces the static path (the placeholders
    then run as n = 4 and ``none``, as in the JAX package); an
    :class:`AdaptiveOptions` tunes the controller, and a pre-built
    :class:`AdaptiveController` is used as given (callers inspect its
    counters).

    With a ``checkpointer`` (``repro_torch.ckpt.Checkpointer``), as the
    JAX loop: the latest checkpoint is restored at start into the state
    (in place) and the run resumes from its step; after every step whose
    count is a multiple of ``ckpt_every`` the state is saved, and at the
    end the state of ``steps`` is saved with ``block=True`` (unless the
    loop has just saved that state: then it only waits for the write).
    The JAX loop restores without a ``like`` tree, which hands the step a
    flat ``{"params/...": array}`` dict; the port restores into the live
    state.

    A step whose loss or backward pass fails is retried up to
    ``max_retries`` times: that half writes nothing. Past them, and on
    any failure in or after the optimizer update (which writes the
    parameters and moments in place), the run rolls back to the latest
    checkpoint and carries on from its step, reading that step's batch
    again; without a checkpoint the failure is raised. Returns (final
    state, history list of metric dicts, each with its ``step`` and
    ``step_time_s``, and with the controller its ``n``, ``strategy`` and,
    on a retune, ``retune_time_s``).

    Under ``dist`` (a ``DistContext``) ``batch_source`` yields the global
    batch, as in the JAX loop, and each rank trains on its dp rows; the
    state is this rank's (``init_state(dist=)``). A checkpointer then
    saves each rank's part and restores this rank's from a checkpoint
    of any mesh or of one device (``state_layout``). Retry and
    roll-back are agreed: every rank reaches one flag ``all_reduce``
    after the step's last collective (the end of the update), and if any
    rank failed, every rank rolls back to the latest checkpoint (or,
    without one, raises); a step is not retried on one rank alone. A
    failure on only some ranks before that point leaves the others in a
    collective that does not complete: it is bounded by the process
    group's timeout, after which the run raises."""
    opts = opts or TrainOptions()
    if state is None:
        state = init_state(cfg, opts, seed=0, device=device, dist=dist)
    dev = leaves(state["params"])[0].device
    controller = None
    if isinstance(adaptive, AdaptiveController):
        controller = adaptive
    elif adaptive is None:
        if cfg.moe is not None and cfg.moe.pipeline and (
                cfg.moe.num_partitions == 0
                or cfg.moe.memory_reuse_strategy == "adaptive"):
            controller = AdaptiveController(cfg, opts, device=dev,
                                            dist=dist)
    elif adaptive:
        aopts = adaptive if isinstance(adaptive, AdaptiveOptions) else None
        controller = AdaptiveController(cfg, opts, aopts, device=dev,
                                        dist=dist)
    if controller is None:
        grads_of, update = _step_parts(cfg, opts, dist)

    start = 0
    saved = None                    # the step whose state was saved last
    # over ranks the checkpointer takes this rank's layout; on one device
    # it is called as the JAX loop calls its own
    ck_kw = ({"shardings": state_layout(cfg, dist)}
             if dist is not None and checkpointer is not None else {})
    if checkpointer is not None:
        restored = checkpointer.restore_latest(like=state, **ck_kw)
        if restored is not None:
            state, start = restored["state"], int(restored["step"])
            saved = start
            log.info("restored checkpoint at step %d", start)

    history = []
    step = start
    while step < steps:
        batch = _to_device(_rows(batch_source.batch_at(step), dist), dev)
        attempt = 0
        error = None
        try:
            while True:
                try:
                    ainfo: Dict[str, Any] = {}
                    if controller is not None:
                        (grads_of, update), ainfo = controller.step_fn(
                            state, batch, step)
                    t0 = time.perf_counter()
                    grads, metrics = grads_of(state["params"], batch)
                    break
                except Exception:
                    attempt += 1
                    log.exception("step %d failed (attempt %d)", step,
                                  attempt)
                    if dist is not None or attempt > max_retries:
                        raise
            state, metrics = update(state, grads, metrics)
            del grads
        except Exception as e:
            error = e
        failed = error is not None
        if dist is not None:
            failed = _any_rank(failed, dist)
        if failed:
            grads = None
            restored = (checkpointer.restore_latest(like=state, **ck_kw)
                        if checkpointer is not None else None)
            if restored is None:
                if error is not None:
                    raise error
                raise RuntimeError(f"step {step} failed on another rank")
            log.warning("step %d failed%s; rolling back", step,
                        "" if error is not None else " on another rank")
            state, step = restored["state"], int(restored["step"])
            saved = step
            log.warning("rolled back to step %d", step)
            continue
        metrics["step_time_s"] = time.perf_counter() - t0
        metrics.update(ainfo)
        history.append({"step": step, **metrics})
        if heartbeat is not None:
            heartbeat(step, metrics)
        step += 1
        if checkpointer is not None and step % ckpt_every == 0:
            checkpointer.save(step, state, **ck_kw)
            saved = step
    if checkpointer is not None:
        if saved == steps:
            checkpointer.wait()
        else:
            checkpointer.save(steps, state, block=True, **ck_kw)
    return state, history
