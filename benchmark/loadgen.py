"""Open-loop load: the schedule, the latencies and their percentiles.

The arithmetic of the port's `eval/loadgen.py` (Poisson arrivals,
completion stamps from done-callbacks, percentiles), copied so that a change
to the program cannot change the yardstick, with two fixes: a request is
timed from when it was due, its place in the schedule, not from when the
generator got round to submitting it (so a stall of the generator counts
against the requests it delays); and the window is fixed, not "until every
request returns": every request due in it counts, and one with no answer
by the end of a bounded drain counts as failed, with the drain's end as
its latency.

Every seed gets the same work in the same order: the clip lengths and the
gaps between arrivals are drawn from the traffic's `shape_seed`; the run's
seed makes the audio (and the weights).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def clip_lengths(n: int, clips: Sequence[dict], rng: np.random.Generator) -> np.ndarray:
    """n clip lengths in seconds: each component {"share", "min_s", "max_s"}
    gets round(share * n) of them (the last the rest), log-uniform over
    [min_s, max_s]."""
    out, left = [], n
    for i, c in enumerate(clips):
        k = left if i == len(clips) - 1 else min(left, int(round(c["share"] * n)))
        out.append(np.exp(rng.uniform(math.log(c["min_s"]), math.log(c["max_s"]), k)))
        left -= k
    return np.concatenate(out) if out else np.zeros(0)


def schedule(rate_rps: float, seconds: float, clips: Sequence[dict], shape_seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(due times [n] in seconds from the window's start, clip lengths [n]
    in seconds) for round(rate * seconds) requests, all due inside the
    window, Poisson: the exponential gaps are scaled so that their sum, one
    more gap included, is the window."""
    n = max(1, int(round(rate_rps * seconds)))
    rng = np.random.default_rng(shape_seed)
    gaps = rng.exponential(1.0, n + 1)
    lengths = rng.permutation(clip_lengths(n, clips, rng))
    return seconds * np.cumsum(gaps)[:n] / gaps.sum(), lengths


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def latencies(due: Sequence[float], done: dict, drain_end: float) -> tuple[list[float], int]:
    """Each request's seconds from its due time to its answer (`done`: index
    → answer time on the same clock as `due`), and how many had none; those
    count with the drain's end as their answer time."""
    out, missing = [], 0
    for i, t in enumerate(due):
        if i in done:
            out.append(done[i] - t)
        else:
            out.append(drain_end - t)
            missing += 1
    return out, missing
