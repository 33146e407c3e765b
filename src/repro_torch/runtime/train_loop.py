"""Training runtime: state, the train step and the host loop, as the
static path of ``repro.runtime.train_loop``.

Step semantics: fp32 parameters, compute in ``cfg.compute_dtype``, MoE
auxiliary losses folded into the objective by ``lm.loss_fn``, AdamW with
the linear-warmup cosine schedule. PyTorch runs eagerly, so there is no
jit: ``make_train_step`` returns a plain function, and its update writes
the state's parameters and moments in place (``optim.adamw``).

Not ported yet, each raising ``NotImplementedError``: the online
``(n, strategy)`` controller (``adaptive=True``, or ``None`` with a
config that still holds the adaptive placeholders — ROADMAP.md's
'Adaptive (n, strategy)' slice), int8 gradient compression (the 'Expert
parallelism' slice) and checkpoint/restart (ROADMAP.md Queue 1,
'Checkpointing').
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.module import leaves
from repro_torch.optim import get_optimizer, lr_schedule

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
               params=None, device=None) -> Dict[str, Any]:
    """Parameters (``lm.init`` from ``seed``, or ``params`` as given —
    e.g. ``convert.from_jax`` of the JAX package's), the optimizer's
    zero state and step 0, on ``device`` (default ``cuda``)."""
    if opts.compress_grads:
        raise NotImplementedError(
            "int8 gradient compression comes with ROADMAP.md's 'Expert "
            "parallelism' slice")
    dev = resolve_device(device)
    if params is None:
        params = lm.init(cfg, seed, device=dev)
    params = _map(params, lambda p: p.detach().to(dev).requires_grad_(True))
    opt_mod, ocfg = get_optimizer(cfg.optimizer, opts.lr)
    return {"params": params, "opt": opt_mod.init(params, ocfg), "step": 0}


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _step_parts(cfg: ArchConfig, opts: TrainOptions):
    """The two halves of a train step: ``grads(params, batch)`` — loss and
    backward, which write nothing — and ``update(state, grads, metrics)``,
    which writes the parameters and moments in place."""
    if opts.compress_grads:
        raise NotImplementedError(
            "int8 gradient compression comes with ROADMAP.md's 'Expert "
            "parallelism' slice")
    opt_mod, ocfg = get_optimizer(cfg.optimizer, opts.lr)

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
            loss, m = lm.loss_fn(params, micro, cfg)
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
        return grads, metrics

    def update(state, grads, metrics):
        flat = leaves(state["params"])
        scale = lr_schedule(state["step"], warmup=opts.warmup,
                            total=opts.total_steps)
        gnorm = torch.zeros((), device=flat[0].device)
        for x in grads:
            gnorm = gnorm + torch.sum(x * x)
        opt = opt_mod.update(grads, state["opt"], flat, ocfg,
                             lr_scale=scale)
        new_state = dict(state, opt=opt, step=state["step"] + 1)
        out = {k: float(v) for k, v in metrics.items()}
        out.update(grad_norm=float(torch.sqrt(gnorm)), lr_scale=scale)
        return new_state, out

    return grads_of, update


def make_train_step(cfg: ArchConfig, opts: TrainOptions) -> Callable:
    """``step(state, batch) -> (state, metrics)``; ``batch`` holds device
    tensors ``tokens`` and ``labels`` ``[B, S]``. Metrics (python floats):
    ``ce``, ``aux_loss``, ``z_loss``, ``loss``, ``grad_norm``,
    ``lr_scale``. With ``grad_accum`` > 1 the batch is split along B and
    the gradients and metrics are averaged over the microbatches."""
    grads_of, update = _step_parts(cfg, opts)

    def train_step(state, batch):
        grads, metrics = grads_of(state["params"], batch)
        return update(state, grads, metrics)

    return train_step


def _check_static(cfg: ArchConfig, adaptive) -> None:
    if adaptive is None:
        adaptive = cfg.moe is not None and cfg.moe.pipeline and (
            cfg.moe.num_partitions == 0
            or cfg.moe.memory_reuse_strategy == "adaptive")
    if adaptive:
        raise NotImplementedError(
            "the online (n, strategy) controller comes with ROADMAP.md's "
            "'Adaptive (n, strategy)' slice; pass adaptive=False to train "
            "with the config's fixed n (0 runs as 4) and strategy "
            "('adaptive' runs as none)")


def train(cfg: ArchConfig, *, steps: int, batch_source,
          opts: Optional[TrainOptions] = None, checkpointer=None,
          max_retries: int = 2,
          heartbeat: Optional[Callable[[int, Dict], None]] = None,
          state=None, adaptive=None, device=None):
    """Run ``steps`` training steps on the static path.

    ``batch_source.batch_at(step)`` must be deterministic (seekable).
    ``adaptive`` must resolve to the static path: ``False``, or ``None``
    with a config whose ``num_partitions`` and ``memory_reuse_strategy``
    are concrete. A step whose loss or backward pass fails is retried up
    to ``max_retries`` times: that half writes nothing. A failure in or
    after the optimizer update raises, since the update writes the
    parameters and moments in place and there is no checkpoint to go
    back to. Returns (final state, history list of
    metric dicts, each with its ``step`` and ``step_time_s``)."""
    opts = opts or TrainOptions()
    _check_static(cfg, adaptive)
    if checkpointer is not None:
        raise NotImplementedError(
            "checkpoint/restart is not ported yet (ROADMAP.md Queue 1, "
            "'Checkpointing')")
    if state is None:
        state = init_state(cfg, opts, seed=0, device=device)
    dev = leaves(state["params"])[0].device
    grads_of, update = _step_parts(cfg, opts)

    history = []
    step = 0                 # as the JAX loop without a checkpoint
    while step < steps:
        batch = _to_device(batch_source.batch_at(step), dev)
        attempt = 0
        while True:
            try:
                t0 = time.perf_counter()
                grads, metrics = grads_of(state["params"], batch)
                break
            except Exception:
                attempt += 1
                log.exception("step %d failed (attempt %d)", step, attempt)
                if attempt > max_retries:
                    raise
        state, metrics = update(state, grads, metrics)
        del grads
        metrics["step_time_s"] = time.perf_counter() - t0
        history.append({"step": step, **metrics})
        if heartbeat is not None:
            heartbeat(step, metrics)
        step += 1
    return state, history
