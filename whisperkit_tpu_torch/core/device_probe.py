"""Fail-fast CUDA probe (the port's counterpart of
whisperkit_tpu/core/device_probe.py).

A fault of the card or of its kernel module can make the first CUDA call
of a process hang or abort it. The probe initialises CUDA and runs one
small tensor op on the card in a THROWAWAY child process under a hard
timeout, so that an entry point fails fast with a clear message, and the
caller's own CUDA state stays untouched. There is no fallback to the CPU: a failure raises
`DeviceUnavailable`; a caller that wants the CPU asks for it (`--device cpu`).

Reference behavior: WhisperKit wraps model-load failures in actionable
errors (WhisperKit.swift:344-350).
"""

from __future__ import annotations

import subprocess
import sys

from whisperkit_tpu_torch.core.errors import DeviceUnavailable

_PROBE_CODE = (
    "import torch; torch.cuda.init(); "
    "x = torch.arange(8, device='cuda', dtype=torch.float32); "
    "s = float((x * 2).sum()); "
    "assert s == 56.0, s; "
    "print(torch.cuda.get_device_name(0), torch.cuda.device_count())"
)


def probe_backend(timeout_s: float = 90.0) -> str:
    """Initialise CUDA and run one tensor op on the card in a child process
    under `timeout_s`. Returns the child's "<device name> <device count>";
    raises DeviceUnavailable when the child fails or outlives the timeout."""
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _PROBE_CODE],
            capture_output=True,
            text=True,
            timeout=timeout_s,
        )
    except subprocess.TimeoutExpired as e:
        raise DeviceUnavailable(
            f"the CUDA device did not initialise within {timeout_s:.0f}s; "
            "pass --device cpu to run on the host"
        ) from e
    if proc.returncode != 0:
        lines = (proc.stderr or "").strip().splitlines()
        # the error's own line (torch ends a CUDA error with a hint line)
        tail = [line for line in lines if "Error" in line][-1:] or lines[-1:]
        raise DeviceUnavailable(f"the CUDA device failed to initialise: {' '.join(tail)}")
    return proc.stdout.strip()
