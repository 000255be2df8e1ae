"""Device resolution for the port.

Every public entry point that places tensors takes a `device`, "cuda" by
default: the port runs on the card unless the caller asks for the CPU.
Asking for "cuda" on a host without a usable card raises: the port never
carries on on the CPU when the caller did not ask for it.
"""

from __future__ import annotations

import contextlib
import threading
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


@contextlib.contextmanager
def ieee_float32():
    """Within the block (or the decorated function), float32 convolutions,
    RNNs and matmuls on the card run in IEEE float32, whatever the
    process's flags: cuDNN's TF32 (`torch.backends.cudnn.allow_tf32`, on
    by default) and cuBLAS's (`torch.backends.cuda.matmul.allow_tf32`) are
    turned off and restored after. The speaker models and the fbank run
    under it, so every entry point computes them at the float32 their
    variants state. The flags are the process's: a thread running beside
    the block sees them off too, and blocks that overlap in several threads
    restore them when the last one ends."""
    global _ieee_depth, _ieee_saved
    with _ieee_lock:
        if _ieee_depth == 0:
            _ieee_saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        _ieee_depth += 1
    try:
        yield
    finally:
        with _ieee_lock:
            _ieee_depth -= 1
            if _ieee_depth == 0:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = _ieee_saved


_ieee_lock = threading.Lock()
_ieee_depth = 0  # ieee_float32 blocks open in any thread
_ieee_saved: tuple = ()
