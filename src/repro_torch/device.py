"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
explicit device they take ``"cuda"``, and with no CUDA they raise rather
than carry on quietly on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises without CUDA); otherwise as given. A
    CUDA device comes back with its index (``cuda`` -> ``cuda:<current>``)
    so it compares equal to the device of the tensors made on it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is "
                               f"unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` / ... -> the torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
