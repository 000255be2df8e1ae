"""The benchmark's own spans around the system's calls.

`Spans(instrument)` records every call that the system module's
`instrument(spans)` wraps (for Whisper, the pipeline's encode and decode
calls, `systems/whisper.py`): each call's kind, its host-clock start and end
(`time.perf_counter`), its rows, and for a decode the positions it ran.
`instrument` returns the function that undoes its wrapping.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class Call:
    kind: str  # e.g. "encode" or "decode"
    t0: float
    t1: float
    rows: int
    steps: int = 0  # decode: positions decoded after the prompt


class Spans:
    """`with Spans(instrument) as sp:` records the wrapped calls into `sp.calls`.

    `trace_from(t_on, seconds)` asks for a profiler slice on the thread that
    runs the calls (a trace sees the device work of the thread that started
    it): the wrapper that calls `maybe_trace()` (for Whisper, the encode
    call's) opens it at its first call at or after `t_on` and closes it at
    its first call `seconds` later, so it holds whole groups and the host's
    work between them; `slice` then holds it. Reading the trace there holds
    up that thread's later groups."""

    def __init__(self, instrument: Callable[["Spans"], Callable[[], None]]):
        self.calls: list[Call] = []
        self.slice = None
        self.slice_error: Exception | None = None
        self.slice_done_at: float | None = None  # when closing the slice (reading its trace) ended
        self._trace_at: tuple[float, float] | None = None
        self._instrument = instrument

    def record(self, kind: str, t0: float, rows: int, steps: int = 0) -> None:
        """A call of `kind` that started at `t0` and ends now."""
        self.calls.append(Call(kind, t0, time.perf_counter(), rows, steps))

    def trace_from(self, t_on: float, seconds: float) -> None:
        self._trace_at = (t_on, seconds)

    def maybe_trace(self) -> None:
        if self._trace_at is None:
            return
        from benchmark.trace import Slice

        now = time.perf_counter()
        t_on, seconds = self._trace_at
        if self.slice is None and now >= t_on:
            self.slice = Slice(sync=False).__enter__()
        elif self.slice is not None and now >= self.slice.t0 + seconds:
            self._trace_at = None
            try:  # a trace that fails must not fail the batch that closes it
                self.slice.__exit__(None, None, None)
            except RuntimeError as e:
                self.slice_error = e
            self.slice_done_at = time.perf_counter()

    def __enter__(self):
        self._undo = self._instrument(self)
        return self

    def __exit__(self, *exc):
        self._undo()
        return False

    def between(self, t0: float, t1: float, kind: str | None = None) -> list[Call]:
        """The calls that started and ended inside [t0, t1]."""
        return [c for c in self.calls if t0 <= c.t0 and c.t1 <= t1 and (kind is None or c.kind == kind)]
