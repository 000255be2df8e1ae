"""Serving load generator (the port's copy of whisperkit_tpu/eval/loadgen.py,
over the port's pipelines/scheduler.BatchScheduler; the JAX package's
bench.py and tools/perf_serve.py use the original).

Submits a list of clips to a BatchScheduler — simultaneously (burst) or
at staggered arrival offsets (Poisson) — and returns latency percentiles,
aggregate decode throughput, batch-fill, and an optional queue-depth
trace. Keeping this in ONE place means a methodology fix (capacity
units, percentile definitions, depth sampling) cannot silently apply to
one harness and not the other (ADVICE-style drift risk flagged in the r8
self-review).

Reference analog: the regression harness's tokens/sec measurement via
callback stream (RegressionTestUtils.swift:84-101) — here at the serving
engine boundary.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np


def poisson_gaps(rng: np.random.Generator, rate_rps: float, n: int) -> list[float]:
    """Cumulative Poisson arrival offsets (seconds from t0) for n requests."""
    return np.cumsum(rng.exponential(1.0 / rate_rps, n)).tolist()


def run_load(
    sched,
    pipeline,
    clips: Sequence[np.ndarray],
    options,
    *,
    arrival_gaps: Optional[Sequence[float]] = None,
    sample_queue_depth: bool = False,
    depth_interval_s: float = 0.25,
    timeout: float = 3600.0,
) -> dict:
    """Run one load scenario and return its stats dict.

    `arrival_gaps[i]` = seconds after t0 to submit `clips[i]`
    (None = simultaneous burst). Latency = submit → result per request.
    Resets the scheduler's batch counters and the pipeline's timings so
    `agg_tokens_per_s` reflects only this scenario.
    """
    from whisperkit_tpu_torch.core.timings import TranscriptionTimings

    pipeline.timings = TranscriptionTimings()
    sched.batches_run = 0
    sched.jobs_run = 0
    sched.windows_run = 0

    depth_samples: list[tuple[float, int]] = []
    stop_sampler = threading.Event()
    t_start = time.perf_counter()

    def sampler():
        while not stop_sampler.wait(depth_interval_s):
            depth = sched._queue.qsize() + len(sched._pending)
            depth_samples.append(
                (round(time.perf_counter() - t_start, 2), depth)
            )

    sampler_thread = None
    if sample_queue_depth:
        sampler_thread = threading.Thread(target=sampler, daemon=True)
        sampler_thread.start()

    # Latency must be stamped at COMPLETION time (done-callback), not when
    # this thread gets around to observing the future: with mixed-duration
    # staggered arrivals a short request can finish while we are still
    # blocked on an earlier long one, and an observe-order stamp would
    # inflate its latency by the wait (r9 self-review finding).
    done_at: dict[int, float] = {}
    submitted = []
    try:
        for i, clip in enumerate(clips):
            if arrival_gaps is not None:
                wait = t_start + arrival_gaps[i] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            f = sched.submit(clip, options)
            f.add_done_callback(
                lambda _f, i=i: done_at.setdefault(i, time.perf_counter())
            )
            submitted.append((time.perf_counter(), f))
        for _, f in submitted:
            f.result(timeout=timeout)
        wall = time.perf_counter() - t_start
        # result() can return before the done-callback has run (CPython
        # notifies waiters before invoking callbacks); callbacks fire on
        # success AND failure, so a bounded spin closes the window
        deadline = time.perf_counter() + 5.0
        while len(done_at) < len(submitted) and time.perf_counter() < deadline:
            time.sleep(0.001)
    finally:
        # stop the depth sampler even when a request's result() raises —
        # a leaked daemon thread would keep polling a shut-down scheduler
        if sampler_thread is not None:
            stop_sampler.set()
            sampler_thread.join(timeout=2)
    # fallback stamp if a callback still hasn't fired after the bounded
    # spin (plausible on a loaded one-core host): the window is
    # microseconds in practice, so "now" is still an accurate stamp —
    # and a KeyError here would kill bench.py's one-JSON-line contract
    now = time.perf_counter()
    lat = [done_at.get(i, now) - t0 for i, (t0, _) in enumerate(submitted)]

    lat_arr = np.asarray(sorted(lat))
    tokens = int(pipeline.timings.total_decoding_loops)
    audio_s = sum(len(c) for c in clips) / 16_000
    out = {
        "requests": len(clips),
        "audio_seconds": round(audio_s, 1),
        "wall_s": round(wall, 2),
        "p50_s": round(float(np.percentile(lat_arr, 50)), 2),
        "p90_s": round(float(np.percentile(lat_arr, 90)), 2),
        "p95_s": round(float(np.percentile(lat_arr, 95)), 2),
        "p99_s": round(float(np.percentile(lat_arr, 99)), 2),
        "agg_tokens_per_s": round(tokens / wall, 1),
        "serving_rtf": round(wall / audio_s, 5),
        "batches": sched.batches_run,
        "mean_batch_fill": round(
            sched.windows_run / max(sched.batches_run, 1), 1
        ),
    }
    if depth_samples:
        depths = [d for _, d in depth_samples]
        out["queue_depth_max"] = max(depths)
        out["queue_depth_mean"] = round(float(np.mean(depths)), 1)
        step = max(1, len(depth_samples) // 24)
        out["queue_depth_trace"] = depth_samples[::step]
    return out
