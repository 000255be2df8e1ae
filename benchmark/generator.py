"""The general generator of the benchmark's traffic. A traffic mix is a
data file, `benchmark/traffic/<mix>.json`, whose `kind` names its runner,
`benchmark/generators/<kind>.py`, and whose other keys are the runner's
parameters. A runner module holds one class, `Runner(traffic, system,
seed, seconds)`, with three methods:

    warmup()                      run every shape the window will use
    window(seconds, trace, spans) -> Window: measure for `seconds`; with
                                  `trace`, also take a trace.Slice
    cases(items, cases_per_item, seed) -> the sample the reference judges,
                                  from the check's cases of each finished item

It drives the system through the calls the system module offers for its
kind of traffic (`transcribe`, `start_scheduler`, ...).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Sequence

import numpy as np

SAMPLE_RATE = 16_000


@dataclasses.dataclass
class Served:
    """One finished request: what was sent and the program's answer."""

    request: object  # e.g. a clip's samples
    answer: object  # the program's result of it


@dataclasses.dataclass
class Window:
    """What a window did: its finished items, its wall and counts."""

    wall_s: float
    attempted: int
    failed: int  # no answer: raised, or none by the end of the drain
    items: list  # Served, the finished ones
    audio_s: float = 0.0  # audio of the finished items
    latencies: list = dataclasses.field(default_factory=list)
    late_s: list = dataclasses.field(default_factory=list)  # generator: submit - due
    batches: list = dataclasses.field(default_factory=list)  # real windows of each batch before the trace
    trace: object = None  # a trace.Slice taken during or after the window
    trace_result: object = None  # the answer of the request traced after the window, where a runner does so


def pick(lengths: Sequence[int], k: int, seed: int) -> list[int]:
    """Indices of k of `lengths` drawn from the seed, the longest always
    among them, in order."""
    if not lengths:
        return []
    rng = np.random.default_rng([seed, 0x5EED])
    longest = max(range(len(lengths)), key=lambda i: lengths[i])
    rest = [i for i in range(len(lengths)) if i != longest]
    extra = rng.choice(rest, size=min(k - 1, len(rest)), replace=False).tolist() if rest and k > 1 else []
    return sorted([longest] + [int(i) for i in extra])


def runner(kind: str):
    """The Runner class of traffic of `kind`."""
    try:
        return importlib.import_module(f"benchmark.generators.{kind}").Runner
    except ModuleNotFoundError as e:
        if e.name == f"benchmark.generators.{kind}":
            raise ValueError(f"no runner for traffic of kind {kind!r}") from e
        raise


def make(traffic: dict, system, seed: int, seconds: float):
    return runner(traffic["kind"])(traffic, system, seed, seconds)
