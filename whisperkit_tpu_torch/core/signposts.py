"""Stage spans: the port's one span recorder (port of
whisperkit_tpu/core/signposts.py).

Reference: Sources/WhisperKit/Utilities/Logging.swift:9-48 — OSSignposter
intervals around TranscribeAudio / Decode / ExtractAudioFeatures /
EncodeAudio, used at TranscribeTask.swift:62, TextDecoder.swift:323,
FeatureExtractor.swift:49, AudioEncoder.swift:56.

`with signpost(name, **attrs) as span:` records one `Span` into a bounded
in-memory ring (a deque of the last `RING_SIZE` spans, the oldest dropped
first): its name, its start and end on `time.perf_counter`, the thread, its
own id and its parent's (the innermost span open on the same thread), the
request it serves (given, or its parent's) and a few scalar attributes.
`new_request()` hands out request ids. A span is recorded when it closes;
`span.seconds` is its length from then on, and a caller may add attributes
to `span.attrs` until then.

Only while a `torch.profiler` session is active on the calling thread (the
autograd profiler's enabled flag) does a span also enter
`torch.profiler.record_function(name)`: it then shows as a user annotation
in the trace, on the profiler's clock beside the device's activities. With
no session a span costs two clock reads, a push and a pop on the thread's
stack and a deque append: no lock and no torch call besides the flag's read.

The spans time host work: a span around a launch closes once the host has
enqueued it, and the device's side comes from a trace. `spans_between`,
`intervals`, `summary` read the ring; `reset` empties it. Start a device
trace with `start_trace(logdir)` / `stop_trace()` around a workload: the
CLI's `transcribe --profile-dir` does so around its whole batch.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from pathlib import Path
from typing import Optional

import torch

RING_SIZE = 1 << 16

_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()  # per thread: the stack of open spans
_profiling = torch._C._autograd._profiler_enabled
_clock = time.perf_counter
# the running trace: (profiler session, directory its file goes to)
_trace: Optional[tuple[torch.profiler.profile, Path]] = None


class Span:
    """One span: a context manager that records itself into the ring as it
    closes (see the module)."""

    __slots__ = ("name", "t0", "t1", "thread", "id", "parent", "request", "attrs", "_annotation")

    def __init__(self, name: str, request: Optional[int], attrs: dict):
        self.name = name
        self.request = request
        self.attrs = attrs
        self.t0 = self.t1 = 0.0
        self.thread = self.parent = None
        self.id = next(_ids)
        self._annotation = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def __enter__(self) -> "Span":
        stack = _local.__dict__.get("stack")
        if stack is None:
            stack = _local.stack = []
        if stack:
            outer = stack[-1]
            self.parent = outer.id
            if self.request is None:
                self.request = outer.request
        self.thread = threading.get_ident()
        stack.append(self)
        if _profiling():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = _clock()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        _local.stack.pop()
        _ring.append(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, request={self.request}, "
                f"{1e3 * self.seconds:.3f} ms, {self.attrs})")


def signpost(name: str, request: Optional[int] = None, **attrs) -> Span:
    """A span named `name` (see the module): `request` is the request's id
    (the parent's when None); `attrs` are a few scalars about the work."""
    return Span(name, request, attrs)


def new_request() -> int:
    """A fresh request id."""
    return next(_requests)


def spans_between(t0: float, t1: float) -> list[Span]:
    """The ring's spans that overlap [t0, t1] (`time.perf_counter`
    readings), oldest start first."""
    return sorted((s for s in list(_ring) if s.t0 <= t1 and s.t1 >= t0), key=lambda s: s.t0)


def intervals(name: str) -> list[float]:
    """The seconds of each span named `name` in the ring, in closing order."""
    return [s.t1 - s.t0 for s in list(_ring) if s.name == name]


def reset() -> None:
    _ring.clear()


def summary() -> dict[str, dict[str, float]]:
    out: dict[str, dict[str, float]] = {}
    for s in list(_ring):
        row = out.setdefault(s.name, {"count": 0, "total_s": 0.0})
        row["count"] += 1
        row["total_s"] += s.t1 - s.t0
    for row in out.values():
        row["mean_ms"] = 1000.0 * row["total_s"] / row["count"]
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
