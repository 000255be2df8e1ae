"""The host's cost of one stage span (`core/signposts.py`), with no
profiler session and inside one.

    python -m whisperkit_tpu_torch.tools.span_cost

One JSON line: µs per empty span with one attribute, over SPANS spans in
a loop, three times with no session (a clock read and a ring append each
side of no torch call), three times inside a `torch.profiler` session of
the host and the card (each span then also enters `record_function`), and
three times with no session again after it; and the card's name and
power limit. It needs a CUDA device, since a session's cost on a card's
host is what the benchmark's traced runs pay.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from whisperkit_tpu_torch.core import signposts

SPANS = 100_000


def span_us() -> float:
    """Host µs per span over SPANS spans."""
    signpost = signposts.signpost
    t0 = time.perf_counter()
    for i in range(SPANS):
        with signpost("span_cost", position=i):
            pass
    return (time.perf_counter() - t0) / SPANS * 1e6


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("span_cost needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    torch.zeros(1, device="cuda")
    span_us()  # warm-up
    off = [span_us() for _ in range(3)]
    on = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            on.append(span_us())
    after = [span_us() for _ in range(3)]
    signposts.reset()
    print(json.dumps({"card": smi.stdout.strip(), "spans": SPANS, "us_per_span_no_profiler": off,
                      "us_per_span_profiler_on": on, "us_per_span_after_a_session": after}), flush=True)


if __name__ == "__main__":
    main()
