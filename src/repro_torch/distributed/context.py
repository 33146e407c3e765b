"""The distribution context threaded through the port's model functions,
as ``repro.distributed.context``: the data-parallel and expert-parallel
process groups of a ``(data, model)`` mesh over ``torch.distributed``
ranks.

The rank layout is JAX's: ``make_mesh((dp, ep), ("data", "model"))``
puts device ``r`` at mesh position ``(r // ep, r % ep)``, so rank ``r``
is ``dp_rank · ep + ep_rank``. The batch is split over ``data``; inside
the MoE layer the sequence is split over ``model`` and each rank holds
``E / ep`` experts (``moe.layer``). The port has no tensor parallelism:
the JAX context's ``tp_axis`` only places activations (GSPMD layout
hints that change no value), so every rank of an EP group runs the
attention and dense layers on the same tokens.

``make_serving_context`` is the serving engine's counterpart of the JAX
``make_serving_context``: the ``ep_split`` of ``devices`` over the
started group, whose size must be ``devices``.

``init_distributed`` reads the environment ``torch.distributed.run``
sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) and starts NCCL on the cards, gloo when
the caller asks for ``device="cpu"`` or when more ranks than cards share
a host. ``make_context`` builds the groups over a default
group the caller started itself (two gloo processes on one card, where
NCCL refuses two ranks of one device).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["DistContext", "ep_split", "init_distributed", "make_context",
           "make_serving_context"]


@dataclasses.dataclass(frozen=True)
class DistContext:
    """This rank's place in a ``(dp, ep)`` mesh and its two groups:
    ``ep_group`` holds the ``ep`` ranks of its data-parallel replica (the
    All-to-Alls run there), ``dp_group`` the ``dp`` ranks that hold the
    same experts (gradients and ZeRO-3 shards are reduced there)."""
    dp_size: int
    ep_size: int
    rank: int
    device: torch.device
    ep_group: Optional[object] = None
    dp_group: Optional[object] = None

    @property
    def world_size(self) -> int:
        return self.dp_size * self.ep_size

    @property
    def ep_rank(self) -> int:
        return self.rank % self.ep_size

    @property
    def dp_rank(self) -> int:
        return self.rank // self.ep_size


def ep_split(devices: int, num_experts: int) -> Tuple[int, int]:
    """Factor ``devices`` into ``(dp, ep)`` for serving.

    ``ep`` is the largest divisor of ``devices`` that also divides
    ``num_experts`` (every device must own the same number of whole
    experts); the rest of the machine becomes data parallelism. Dense
    models (``num_experts == 0``) get ``ep = 1``.
    """
    assert devices >= 1
    ep = 1
    if num_experts > 0:
        for d in range(min(devices, num_experts), 0, -1):
            if devices % d == 0 and num_experts % d == 0:
                ep = d
                break
    return devices // ep, ep


def make_context(mesh_data: int, mesh_model: int,
                 device) -> DistContext:
    """The context of this rank over the started default group, whose
    size must be ``mesh_data * mesh_model``. Every rank calls it: each
    ``new_group`` is collective over the world, in the same order."""
    world = dist.get_world_size()
    if world != mesh_data * mesh_model:
        raise ValueError(f"mesh {mesh_data}x{mesh_model} needs "
                         f"{mesh_data * mesh_model} ranks, the group has "
                         f"{world}")
    rank = dist.get_rank()
    ep_group = dp_group = None
    for d in range(mesh_data):
        g = dist.new_group([d * mesh_model + e for e in range(mesh_model)])
        if rank // mesh_model == d:
            ep_group = g
    for e in range(mesh_model):
        g = dist.new_group([d * mesh_model + e for d in range(mesh_data)])
        if rank % mesh_model == e:
            dp_group = g
    return DistContext(dp_size=mesh_data, ep_size=mesh_model, rank=rank,
                       device=torch.device(device), ep_group=ep_group,
                       dp_group=dp_group)


def make_serving_context(devices: int, *, num_experts: int = 0,
                         device) -> Optional[DistContext]:
    """The ``(dp, ep) = ep_split(devices, num_experts)`` context of this
    rank for serving over ``devices`` ranks (expert parallelism over
    ``ep``, the rest data parallelism), or None for ``devices <= 1``:
    the one-device engine. Collective over the started default group,
    whose size must be ``devices``."""
    if devices <= 1:
        return None
    if not dist.is_initialized():
        raise ValueError(
            f"devices={devices} serves over {devices} torch.distributed "
            f"ranks: start the process group first (torch.distributed.run, "
            f"or init_process_group on every rank)")
    world = dist.get_world_size()
    if world != devices:
        raise ValueError(f"devices={devices} must equal the process "
                         f"group's world size, {world}")
    return make_context(*ep_split(devices, num_experts), device)


def init_distributed(mesh_data: int = 1, mesh_model: int = 1, *,
                     device=None) -> DistContext:
    """Start the default process group from ``torch.distributed.run``'s
    environment and return this rank's context. ``device`` defaults to
    ``cuda:{LOCAL_RANK}`` (NCCL); ``"cpu"`` runs gloo, and so do more
    local ranks than cards, which then share them (``cuda:{LOCAL_RANK %
    cards}``: NCCL refuses two ranks of one device)."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    cards = torch.cuda.device_count()
    shared = 0 < cards < int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if device is None:
        device = f"cuda:{local % cards if shared else local}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend = "gloo" if shared else "nccl"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend,
                                rank=int(os.environ.get("RANK", 0)),
                                world_size=int(os.environ.get(
                                    "WORLD_SIZE", 1)))
    return make_context(mesh_data, mesh_model, dev)
