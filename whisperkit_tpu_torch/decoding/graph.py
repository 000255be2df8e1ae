"""Capture one decode step as a CUDA graph and replay it.

The JAX package runs the whole token loop as one `lax.while_loop` on the
device. The port's counterpart is a CUDA graph of one step: the step
function reads and writes only tensors whose addresses stay put (the
caches, the token buffers, the device-side position), so the graph
captured from one call replays the step at every later position, one
launch from the host where the eager step makes a few thousand.

`StepGraph(step, device)` runs `step` once eagerly on its capture stream
(the warm-up: cuBLAS's workspace for that stream and each launcher's
one-time attribute calls happen outside the capture), then captures it
into a graph with a private memory pool. The capture stream is the
thread's current stream (a mesh rank's own, parallel/mesh.py, so a rank
keeps one stream), or a stream of the thread's own where that is the
device's default stream, which no capture may use. `replay()` runs the
captured step on the device's current stream and counts its kernels'
launches (`ops/_build.recording`); `stats_by_device` counts captures and
replays. A capture error raises: there is no eager fallback on the card.
A graph lives for one decode call, so it never outlives the buffers it
froze; `close()` frees its pool. The warm-up, the capture (with the
instantiation), the first replay and the release each run in a stage span
of their own (`graph.warmup`, `graph.capture`, `graph.first_replay`,
`graph.release`; core/signposts.py).

Captures run one at a time in the process (a mesh runs one decode thread
per device), each in "thread_local" mode: the mesh's other threads may
call capture-unsafe APIs meanwhile, which the default "global" mode
refuses. Under tensor parallelism every rank captures its own step: the
warm-up runs outside the lock, so its all-reduces meet the peers'
warm-ups on the device while another rank captures; the capture records
the all-reduce launches without running them (the group's device
sequence does not move), and a rank's replays then wait on the device for
its peers' replays, with no host barrier. The loops then call
`TPRank.captured`, so that ranks that share a device replay only once
every rank has captured.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import torch

from whisperkit_tpu_torch.core.signposts import signpost
from whisperkit_tpu_torch.ops import _build

_capture_lock = threading.Lock()
_streams = threading.local()  # per thread: device -> its capture stream

# per device: captures, replays, and the captures' host seconds (the
# step captured, then the graph instantiated), for a run to report
STATS = ("captures", "replays", "capture_s", "instantiate_s")
stats_by_device: dict[str, dict[str, float]] = {}
_stats_lock = threading.Lock()


def reset_stats() -> None:
    with _stats_lock:
        stats_by_device.clear()


def _add(device: torch.device, **values: float) -> None:
    with _stats_lock:
        per = stats_by_device.setdefault(str(device), dict.fromkeys(STATS, 0))
        for key, value in values.items():
            per[key] += value


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """This thread's capture stream on `device`, one per thread and device,
    so that cuBLAS's workspace for it is made once."""
    streams = _streams.__dict__.setdefault("by_device", {})
    key = str(device)
    if key not in streams:
        streams[key] = torch.cuda.Stream(device)
    return streams[key]


class StepGraph:
    """A CUDA graph of one call of `step` on `device` (see the module)."""

    def __init__(self, step: Callable[[], None], device: torch.device):
        self.device = torch.device(device)
        self.graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(self.device)
        # the thread's current stream, unless it is the device's default
        stream = current
        if current.cuda_stream == torch.cuda.default_stream(self.device).cuda_stream:
            stream = _capture_stream(self.device)
        with torch.cuda.device(self.device):
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                with signpost("graph.warmup"):
                    step()  # the warm-up: this position's step, run eagerly
                with signpost("graph.capture"), _capture_lock:
                    t0 = time.perf_counter()
                    self.graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        with _build.recording() as record:
                            step()
                    except BaseException:
                        try:
                            self.graph.capture_end()
                        except RuntimeError:
                            pass  # the capture was already invalid; the step's error says why
                        raise
                    t1 = time.perf_counter()
                    self.graph.capture_end()  # ends the capture and instantiates the graph
            current.wait_stream(stream)
        self.record = record
        self.replayed = False
        _add(self.device, captures=1, capture_s=t1 - t0, instantiate_s=time.perf_counter() - t1)

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            if self.replayed:
                self.graph.replay()
            else:  # the first launch of an instantiated graph uploads it to the device
                with signpost("graph.first_replay"):
                    self.graph.replay()
                self.replayed = True
        _build.add_launches(self.record)
        _add(self.device, replays=1)

    def close(self) -> None:
        """Free the graph and its pool once its launches have finished: a
        tp rank's replays may still wait on the device for a peer's, and
        destroying their graph then could hold this thread until they end
        while the peer's thread needs the interpreter to launch its own."""
        with signpost("graph.release"):
            torch.cuda.current_stream(self.device).synchronize()
            self.graph.reset()
