"""A `torch.profiler` trace of a bounded slice of a run, and the arithmetic
that the per-layer metrics read from it.

Device busy is the length of the union of the device activities'
intervals (kernels, copies, sets), as the port's `tools/profile_step.py`
takes it; a kernel's time is summed by its name. A device activity belongs
to a host span (the benchmark's own, `spans.Spans`) when the runtime call
that launched it (a kernel launch, or the graph launch of a CUDA graph
replay, matched by the trace's correlation ids) lies inside the span. The
spans are stamped with `time.perf_counter`; a mark recorded at each end of
the slice maps that clock onto the trace's.

The trace is written to a temporary file under TMPDIR, read, and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Iterable, Optional, Sequence

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARK = "bench.clock"


def union_us(intervals: Iterable[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: Iterable[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Slice:
    """`with Slice() as sl:` traces what runs inside (every thread's device
    work); afterwards `sl` holds the device activities and launches, and
    the host-clock bounds of the slice."""

    def __init__(self, sync: bool = True):
        self.sync = sync  # wait for the device at both ends (the caller's own work)
        self.kernels: list[tuple[str, float, float, Optional[int]]] = []  # name, start us, end us, correlation
        self.launch_us: dict[int, float] = {}
        self.t0 = self.t1 = 0.0
        self._offsets: list[float] = []

    def _mark(self, record_function) -> float:
        t = time.perf_counter()
        with record_function(MARK):
            pass
        return t

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if self.sync:
            torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._marks = [self._mark(record_function)]
        self.t0 = self._marks[0]
        return self

    def __exit__(self, *exc):
        import torch
        from torch.profiler import record_function

        if self.sync:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._marks.append(self._mark(record_function))
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        del self._prof
        self._read(events)
        return False

    def _read(self, events: list) -> None:
        marks = sorted(e["ts"] for e in events if e.get("name") == MARK and "ts" in e)
        if len(marks) != len(self._marks):
            raise RuntimeError(f"the trace holds {len(marks)} clock marks, not {len(self._marks)}")
        self._offsets = [m - h * 1e6 for m, h in zip(marks, self._marks)]
        for e in events:
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                corr = (e.get("args") or {}).get("correlation")
                self.kernels.append((e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), corr))
            elif cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    self.launch_us[corr] = float(e["ts"])
        if not self.kernels:
            raise RuntimeError("the profiler recorded no device activity in the slice")

    def to_us(self, t_host: float) -> float:
        """A `time.perf_counter` reading on the trace's clock."""
        return t_host * 1e6 + sum(self._offsets) / len(self._offsets)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def bounds_us(self) -> tuple[float, float]:
        return self.to_us(self.t0), self.to_us(self.t1)

    def busy_s(self) -> float:
        """Device busy inside the slice's bounds."""
        lo, hi = self.bounds_us()
        return union_us((max(s, lo), min(e, hi)) for _, s, e, _ in self.kernels if e > lo and s < hi) / 1e6

    def launched_in(self, spans: Sequence[tuple[float, float]]) -> list[tuple[str, float, float, Optional[int]]]:
        """The device activities whose launch lies inside one of `spans`
        (host-clock (start, end) pairs)."""
        bounds = sorted((self.to_us(a), self.to_us(b)) for a, b in spans)
        out = []
        for k in self.kernels:
            at = self.launch_us.get(k[3], k[1])
            if any(a <= at <= b for a, b in bounds):
                out.append(k)
        return out

    def top_ops(self, n: int = 10) -> list[list]:
        """The n device operations that took most time: [name, seconds]."""
        by: dict[str, float] = {}
        for name, s, e, _ in self.kernels:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[name, t] for name, t in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans: Sequence[tuple[str, float, float]], n: int = 10) -> list[list]:
        """The n longest stretches of the slice with no device activity,
        each named by the innermost host span around its middle (or
        "outside spans"): [name, seconds]."""
        lo, hi = self.bounds_us()
        busy = merged((max(s, lo), min(e, hi)) for _, s, e, _ in self.kernels if e > lo and s < hi)
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        mapped = [(name, self.to_us(a), self.to_us(b)) for name, a, b in spans]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = (a + b) / 2
            inside = [(s, name) for name, s, e in mapped if s <= mid <= e]
            out.append([max(inside)[1] if inside else "outside spans", (b - a) / 1e6])
        return out
