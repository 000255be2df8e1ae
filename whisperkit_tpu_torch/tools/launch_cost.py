"""The host's cost of a small launch from Python, before and after one
`torch.profiler` session in the same process.

    python -m whisperkit_tpu_torch.tools.launch_cost

Once a session has run, every later launch of the process costs the host
more, so `chip_smoke.py` takes its device-time traces in a process of its
own and `profile_step` takes every wall before its first trace. One JSON
line: µs per launch (an in-place add on 1,024 floats, 20,000 launches
back to back, the host clock stopped before the closing sync), three
times before and three times after a session that traces 50 launches,
and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

LAUNCHES = 20_000


def host_us(x: torch.Tensor) -> float:
    """Host µs per launch of an in-place add over LAUNCHES launches."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LAUNCHES):
        x.add_(1.0)
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / LAUNCHES * 1e6


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("launch_cost needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    x = torch.zeros(1024, device="cuda")
    host_us(x)  # warm-up
    before = [host_us(x) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(50):
            x.add_(1.0)
        torch.cuda.synchronize()
    after = [host_us(x) for _ in range(3)]
    print(json.dumps({"card": smi.stdout.strip(), "host_us_per_launch_before": before,
                      "host_us_per_launch_after": after}), flush=True)


if __name__ == "__main__":
    main()
