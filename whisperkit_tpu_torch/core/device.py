"""Device resolution for the port.

Every public entry point that places tensors takes a `device`, "cuda" by
default: the port runs on the card unless the caller asks for the CPU.
Asking for "cuda" on a host without a usable card raises: the port never
carries on on the CPU when the caller did not ask for it.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """`device` ("cpu", "cuda", "cuda:N" or a torch.device) → torch.device."""
    if device is None:
        raise ValueError("device must be 'cpu', 'cuda', 'cuda:N' or a torch.device, not None")
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
