"""Model lifecycle manager: download → prewarm → load → unload (port of
whisperkit_tpu/core/model_manager.py).

Reference: Sources/ArgmaxCore/ModelManager.swift — `ModelLoader` protocol
(:14-29), `ensureModelsLoaded` (:75-82), `prewarmModels` (:121-153), and the
`LoadModelsCoordinator` actor that coalesces concurrent loads (:214-232),
driving the 8-state `ModelState` machine (ModelState.swift:20-53).
"""

from __future__ import annotations

import time
from typing import Callable, Generic, Optional, TypeVar

from whisperkit_tpu_torch.core.concurrency import CoalescingLoader
from whisperkit_tpu_torch.core.logging import logging
from whisperkit_tpu_torch.core.modelstate import ModelState

T = TypeVar("T")

ModelStateCallback = Callable[[ModelState, ModelState], None]


class ModelManager(Generic[T]):
    """Generic lifecycle wrapper around a load function.

    The load function does resolution+weights (the reference's download+
    load); `prewarm_fn` runs the hot path once, which builds and loads the
    CUDA kernels (the reference's CoreML specialization pass; e.g.
    `WhisperPipeline.prewarm`).
    """

    def __init__(
        self,
        load_fn: Callable[[], T],
        prewarm_fn: Optional[Callable[[T], None]] = None,
        state_callback: Optional[ModelStateCallback] = None,
    ):
        self._loader = CoalescingLoader(load_fn)
        self._prewarm_fn = prewarm_fn
        self._state = ModelState.UNLOADED
        self._state_callback = state_callback
        self.load_time: float = 0.0
        self.prewarm_time: float = 0.0

    @property
    def state(self) -> ModelState:
        return self._state

    def _set_state(self, new: ModelState) -> None:
        old, self._state = self._state, new
        if self._state_callback and old != new:
            self._state_callback(old, new)

    def ensure_loaded(self, prewarm: bool = False) -> T:
        """Reference: ModelManager.ensureModelsLoaded — idempotent, and
        concurrent callers coalesce into one load."""
        if self._state == ModelState.LOADED:
            return self._loader.ensure_loaded()
        self._set_state(ModelState.LOADING)
        t0 = time.perf_counter()
        try:
            model = self._loader.ensure_loaded()
        except BaseException:
            self._set_state(ModelState.UNLOADED)
            raise
        self.load_time = time.perf_counter() - t0
        if prewarm and self._prewarm_fn is not None:
            self._set_state(ModelState.PREWARMING)
            t0 = time.perf_counter()
            try:
                self._prewarm_fn(model)
            except Exception as e:
                # prewarm is an optimization: the model IS loaded, so log
                # and continue to LOADED (mirrors the reference's defensive
                # recompile semantics) instead of wedging in PREWARMING
                logging.error(f"prewarm failed (continuing unprewarmed): {e}")
            self.prewarm_time = time.perf_counter() - t0
        self._set_state(ModelState.LOADED)
        logging.debug(
            f"model loaded in {self.load_time:.2f}s (prewarm {self.prewarm_time:.2f}s)"
        )
        return model

    def unload(self) -> None:
        self._set_state(ModelState.UNLOADING)
        self._loader.unload()
        self._set_state(ModelState.UNLOADED)
