"""Model lifecycle state machine (the port's copy of
whisperkit_tpu/core/modelstate.py).

Reference: Sources/ArgmaxCore/ModelState.swift:20-53 — the same 8-state enum
shared by all pipelines, with `is_busy` semantics.
"""

from __future__ import annotations

import enum


class ModelState(enum.Enum):
    UNLOADING = "unloading"
    UNLOADED = "unloaded"
    LOADING = "loading"
    LOADED = "loaded"
    PREWARMING = "prewarming"
    PREWARMED = "prewarmed"
    DOWNLOADING = "downloading"
    DOWNLOADED = "downloaded"

    @property
    def is_busy(self) -> bool:
        return self in (
            ModelState.LOADING,
            ModelState.PREWARMING,
            ModelState.UNLOADING,
            ModelState.DOWNLOADING,
        )

    def __str__(self) -> str:  # matches reference's descriptions
        return self.value
