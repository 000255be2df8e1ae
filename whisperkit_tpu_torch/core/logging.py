"""Level-gated global logger with callback interception (the port's copy of
whisperkit_tpu/core/logging.py, trimmed to the logger and the timing
report's formatter).

Reference: Sources/ArgmaxCore/Logging.swift:20-219 — singleton logger with
LogLevel{debug,info,error,none} and an optional callback that intercepts
all messages.
"""

from __future__ import annotations

import enum
import sys
import threading
from typing import Callable, Optional


class LogLevel(enum.IntEnum):
    DEBUG = 0
    INFO = 1
    ERROR = 2
    NONE = 3


class _Logging:
    """Process-global logger (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.level: LogLevel = LogLevel.INFO
        self.callback: Optional[Callable[[str], None]] = None

    def _emit(self, level: LogLevel, *args: object) -> None:
        with self._lock:
            if level < self.level:
                return
            cb = self.callback
        msg = " ".join(str(a) for a in args)
        if cb is not None:
            cb(msg)
        else:
            print(msg, file=sys.stderr)

    def debug(self, *args: object) -> None:
        self._emit(LogLevel.DEBUG, *args)

    def info(self, *args: object) -> None:
        self._emit(LogLevel.INFO, *args)

    def error(self, *args: object) -> None:
        self._emit(LogLevel.ERROR, *args)


logging = _Logging()


def format_time_with_percentage(time_s: float, runs: float, full_pipeline_s: float) -> str:
    """Reference: Logging.swift `formatTimeWithPercentage` — used by timing reports."""
    per_run = time_s / runs if runs > 0 else 0.0
    pct = (time_s / full_pipeline_s * 100.0) if full_pipeline_s > 0 else 0.0
    return f"{time_s * 1000:9.2f} ms / {int(runs):4d} runs ({per_run * 1000:9.2f} ms/run) {pct:5.2f}%"
