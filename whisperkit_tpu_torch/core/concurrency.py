"""Concurrency utilities (the port's copy of
whisperkit_tpu/core/concurrency.py).

Reference: Sources/ArgmaxCore/ConcurrencyUtilities.swift — `PropertyLock`
(:55-90), `EarlyStopActor` (:105-127) — and the `LoadModelsCoordinator`
actor (ModelManager.swift:214-232) that coalesces concurrent load requests.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class PropertyLock(Generic[T]):
    """Lock-protected mutable value (reference: PropertyLock)."""

    def __init__(self, value: T):
        self._lock = threading.Lock()
        self._value = value

    def get(self) -> T:
        with self._lock:
            return self._value

    def set(self, value: T) -> None:
        with self._lock:
            self._value = value

    def with_lock(self, fn: Callable[[T], T]) -> T:
        with self._lock:
            self._value = fn(self._value)
            return self._value


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


class CoalescingLoader:
    """Coalesces concurrent load requests into one in-flight load.

    Reference: LoadModelsCoordinator actor (ModelManager.swift:214-232).
    """

    class _Round:
        """One in-flight load attempt; error/result are per-round so a new
        attempt can't clobber what an old round's waiters will read."""

        def __init__(self):
            self.event = threading.Event()
            self.result: Optional[object] = None
            self.error: Optional[BaseException] = None

    def __init__(self, load_fn: Callable[[], T]):
        self._load_fn = load_fn
        self._lock = threading.Lock()
        self._loaded: Optional[T] = None
        self._in_flight: Optional["CoalescingLoader._Round"] = None

    def ensure_loaded(self) -> T:
        with self._lock:
            if self._loaded is not None:
                return self._loaded
            if self._in_flight is None:
                self._in_flight = CoalescingLoader._Round()
                rnd, owner = self._in_flight, True
            else:
                rnd, owner = self._in_flight, False
        if owner:
            try:
                rnd.result = self._load_fn()
                with self._lock:
                    self._loaded = rnd.result
            except BaseException as e:
                rnd.error = e
            finally:
                with self._lock:
                    self._in_flight = None
                rnd.event.set()
        else:
            rnd.event.wait()
        if rnd.error is not None:
            raise rnd.error
        return rnd.result  # type: ignore[return-value]

    def unload(self) -> None:
        with self._lock:
            self._loaded = None
