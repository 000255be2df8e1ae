"""Cross-thread cancellation (the port's copy of
whisperkit_tpu/core/concurrency.py, trimmed to `EarlyStopFlag`).

Reference: Sources/ArgmaxCore/ConcurrencyUtilities.swift `EarlyStopActor`
(:105-127).
"""

from __future__ import annotations

import threading


class EarlyStopFlag:
    """Cross-thread cancellation signal checked between decode windows.

    Reference: EarlyStopActor (ConcurrencyUtilities.swift:105-127) +
    TextDecoder.swift:733-756 — the callback-driven stop. The pipeline
    polls it between decode segments (decoding/loop.decode_loop_segmented).
    """

    def __init__(self):
        self._event = threading.Event()

    def stop(self) -> None:
        self._event.set()

    @property
    def should_stop(self) -> bool:
        return self._event.is_set()

    def reset(self) -> None:
        self._event.clear()
