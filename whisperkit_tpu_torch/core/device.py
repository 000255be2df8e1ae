"""Device resolution for the port.

Every public entry point takes an explicit `device`. Asking for "cuda" on a
host without a usable card raises: the port never carries on on the CPU
when the caller asked for the GPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """`device` ("cpu", "cuda", "cuda:N" or a torch.device) → torch.device."""
    if device is None:
        raise ValueError("an explicit device is required ('cpu' or 'cuda')")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was requested but no CUDA device is available"
            )
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(device)!r} was requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible"
            )
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}; use 'cpu' or 'cuda'")
    return dev
