"""Stage tracing: named scopes + wall-clock signpost intervals (port of
whisperkit_tpu/core/signposts.py).

Reference: Sources/WhisperKit/Utilities/Logging.swift:9-48 — OSSignposter
intervals around TranscribeAudio / Decode / ExtractAudioFeatures /
EncodeAudio, used at TranscribeTask.swift:62, TextDecoder.swift:323,
FeatureExtractor.swift:49, AudioEncoder.swift:56.

Here `torch.profiler.record_function` marks show up in profiler traces;
`signpost()` also records wall-clock intervals queryable from tests and
benchmarks. Start a device trace with `start_trace(logdir)` /
`stop_trace()` around a workload: the CLI's `transcribe --profile-dir`
does so around its whole batch.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Iterator, Optional

import torch

_intervals: dict[str, list[float]] = defaultdict(list)
# the running trace: (profiler session, directory its file goes to)
_trace: Optional[tuple[torch.profiler.profile, Path]] = None


@contextlib.contextmanager
def signpost(name: str) -> Iterator[None]:
    """Profiler annotation + wall-clock interval recording."""
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        _intervals[name].append(time.perf_counter() - t0)


def intervals(name: str) -> list[float]:
    return list(_intervals[name])


def reset() -> None:
    _intervals.clear()


def summary() -> dict[str, dict[str, float]]:
    out = {}
    for name, times in _intervals.items():
        out[name] = {
            "count": len(times),
            "total_s": sum(times),
            "mean_ms": 1000.0 * sum(times) / max(len(times), 1),
        }
    return out


def start_trace(logdir: str | os.PathLike) -> None:
    """Open a `torch.profiler` session that records the host (CPU) and the
    card (CUDA, where this torch build has it) until `stop_trace`.

    Once a profiler session has run, every later kernel launch of its
    process costs the host more (`python -m
    whisperkit_tpu_torch.tools.launch_cost`: 7.6 → 13.4 µs a launch on an
    H100 host), for the rest of the process. So trace a process that ends
    after its trace, as the CLI does, and never time a wall after a trace
    in the same process."""
    global _trace
    if _trace is not None:
        raise RuntimeError("a trace is already running; call stop_trace() first")
    wanted = (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
    activities = [a for a in wanted if a in torch.profiler.supported_activities()]
    session = torch.profiler.profile(activities=activities)
    session.start()
    _trace = (session, Path(logdir))


def stop_trace() -> Path:
    """Close the session `start_trace` opened and write its Chrome trace
    (JSON) under its directory; returns the file's path."""
    global _trace
    if _trace is None:
        raise RuntimeError("no trace is running; call start_trace() first")
    (session, logdir), _trace = _trace, None
    session.stop()
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / f"trace_{os.getpid()}_{time.strftime('%Y%m%d-%H%M%S')}.json"
    session.export_chrome_trace(str(path))
    return path
