"""The program's own spans (the port's `core/signposts.py` ring) against a
traced slice: the stretches in which the device ran nothing, how much of
them lies inside some spans and outside others, and which span each idle
second falls in.

The port stamps its spans with `time.perf_counter`, the clock that
`trace.Slice.to_us` maps onto the trace. Where the program keeps no span
ring (no `signposts.spans_between`), `found` gives None, and so does every
metric that reads through it.

    python3 -m benchmark.program_spans --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on the card, runs the cell once with a trace, as `run.py --trace 1` does, and prints one
JSON line: the slice's device-idle seconds split by the innermost program
span around each idle stretch (all stretches, and those of 50 µs or more),
the share of idle inside a span other than the root spans `transcribe` and
`batch`, each root's seconds traced and untraced, and the longest spans.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

from benchmark.trace import merged

ROOTS = ("transcribe", "batch")
OUTSIDE = "outside spans"

Interval = tuple[float, float]


def found(sl, t0: Optional[float] = None, t1: Optional[float] = None) -> Optional[list]:
    """The program's spans that overlap [t0, t1] (the slice's bounds by
    default), oldest start first; None without a slice, a span ring, or any
    span there."""
    if sl is None:
        return None
    from whisperkit_tpu_torch.core import signposts

    between = getattr(signposts, "spans_between", None)
    if between is None:
        return None
    return between(sl.t0 if t0 is None else t0, sl.t1 if t1 is None else t1) or None


def idle_us(sl) -> list[Interval]:
    """The slice's stretches with no device activity, on the trace's clock:
    the complement of the merged device activities within the bounds."""
    lo, hi = sl.bounds_us()
    out, at = [], lo
    for s, e in merged((max(s, lo), min(e, hi)) for _, s, e, _ in sl.kernels if e > lo and s < hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def intersect(a: Sequence[Interval], b: Sequence[Interval]) -> list[Interval]:
    """The overlaps of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def minus(a: Sequence[Interval], b: Sequence[Interval]) -> list[Interval]:
    """The parts of a sorted list of disjoint intervals outside another."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, at = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > at:
                out.append((at, b[k][0]))
            at = max(at, b[k][1])
            k += 1
        if e > at:
            out.append((at, e))
    return out


def on_trace(sl, spans: Iterable) -> list[Interval]:
    """Host-clock (start, end) pairs, or spans, as merged trace intervals."""
    pairs = ((s.t0, s.t1) if hasattr(s, "t0") else s for s in spans)
    return merged((sl.to_us(a), sl.to_us(b)) for a, b in pairs)


def idle_s(sl, inside: Iterable, outside: Iterable = ()) -> float:
    """Seconds of device idle inside the union of `inside` and outside the
    union of `outside` (spans, or host-clock (start, end) pairs)."""
    region = minus(on_trace(sl, inside), on_trace(sl, outside))
    return sum(e - s for s, e in intersect(idle_us(sl), region)) / 1e6


def idle_by_span(sl, spans: Sequence, min_us: float = 0.0) -> dict[str, float]:
    """The slice's idle seconds, each stretch named by the innermost span
    around it (of those that cover it, the latest to start), or OUTSIDE;
    only stretches of at least `min_us` (a kernel's own launch gap inside a
    graph replay is a few µs; a stretch the host leaves is longer)."""
    cuts = sorted({x for s in spans for x in (sl.to_us(s.t0), sl.to_us(s.t1))})
    pieces: list[tuple[float, float, str]] = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        around = [s for s in spans if sl.to_us(s.t0) <= mid <= sl.to_us(s.t1)]
        if around:
            pieces.append((a, b, max(around, key=lambda s: (s.t0, s.id)).name))
    out: dict[str, float] = {}
    idle = [(a, b) for a, b in idle_us(sl) if b - a >= min_us]
    named, j = 0.0, 0
    for a, b, name in pieces:  # sorted and disjoint, as the idle stretches are
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        k, t = j, 0.0
        while k < len(idle) and idle[k][0] < b:
            t += max(0.0, min(b, idle[k][1]) - max(a, idle[k][0])) / 1e6
            k += 1
        if t:
            out[name] = out.get(name, 0.0) + t
            named += t
    out[OUTSIDE] = sum(e - s for s, e in idle) / 1e6 - named
    return out


def named_share(split: dict[str, float]) -> Optional[float]:
    """The share of idle inside a span below the roots (not `transcribe` or
    `batch` alone, not outside every span)."""
    total = sum(split.values())
    if not total:
        return None
    return 1.0 - sum(split.get(n, 0.0) for n in (*ROOTS, OUTSIDE)) / total


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    import time

    t_start = time.perf_counter()
    p = argparse.ArgumentParser(description="a traced run's device idle, split by the program's spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    from benchmark import harness, trace

    slices = []
    close = trace.Slice.__exit__

    def keep(self, *exc):
        out = close(self, *exc)
        slices.append(self)
        return out

    trace.Slice.__exit__ = keep
    cell = harness.cell_of(args.workload)
    problem = harness.require_devices(cell.workload["chips"])
    if problem is not None:
        print(problem, file=sys.stderr)
        return 1
    out = harness.run_cell(cell, args.seed, args.seconds, True, t_start)
    sl = slices[-1]
    spans = found(sl) or []
    split = idle_by_span(sl, spans)
    line = {"workload": args.workload, "seed": args.seed, "correct": out["correct"],
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "busy_s": sl.busy_s(), "window_s": sl.window_s, "idle_s": sum(split.values()),
            "named_share": named_share(split), "idle_by_span": dict(sorted(split.items(), key=lambda kv: -kv[1])),
            "idle_by_span_50us": {k: v for k, v in sorted(idle_by_span(sl, spans, 50.0).items(), key=lambda kv: -kv[1])},
            "spans": len(spans), **traced_against_untraced(sl, found(sl, 0.0, sl.t1) or []),
            "longest": [[s.name, s.seconds] for s in longest(found(sl, 0.0, sl.t1) or [])]}
    print(json.dumps(line))
    return 0


def longest(spans: Sequence, n: int = 8) -> list:
    """The n longest spans below the roots, the gather's wait left out: where
    a stall sits."""
    return sorted((s for s in spans if s.name not in (*ROOTS, "batch.gather")), key=lambda s: -s.seconds)[:n]


def traced_against_untraced(sl, spans: Sequence) -> dict:
    """The root spans' seconds inside the slice (profiler on) beside the
    same roots' before it (profiler off), and the spans recorded per root:
    for a traced file, the same file's earlier `transcribe` spans; for the
    batcher, each `batch` span in the slice beside the earlier batches of
    as many rows (the spans per batch count the batch's own span)."""
    roots = [s for s in spans if s.name in ROOTS]
    inside = [s for s in roots if sl.t0 <= s.t0 and s.t1 <= sl.t1]
    if not inside:
        return {}
    if inside[-1].name == "transcribe":
        traced = inside[-1]
        before = [s.seconds for s in roots if s.t1 < sl.t0 and s.attrs.get("audio_s") == traced.attrs["audio_s"]]
        per_root = sum(1 for s in spans if s.request == traced.request)
        return {"transcribe_s_traced": traced.seconds, "transcribe_s_untraced": before,
                "spans_per_transcribe": per_root}
    # each batch in the slice beside the mean of the earlier batches of its rows
    mean = lambda xs: sum(xs) / len(xs) if xs else None  # noqa: E731
    pairs = [(b.seconds, mean([s.seconds for s in roots if s.t1 < sl.t0 and s.attrs["rows"] == b.attrs["rows"]]))
             for b in inside]
    pairs = [p for p in pairs if p[1] is not None]
    per_batch = [sum(1 for x in spans if x.thread == b.thread and b.t0 <= x.t0 and x.t1 <= b.t1) for b in inside]
    return {"batch_s_traced": mean([t for t, _ in pairs]), "batch_s_untraced": mean([u for _, u in pairs]),
            "batches_compared": len(pairs), "spans_per_batch": mean(per_batch)}


if __name__ == "__main__":
    import os
    import sys
    from pathlib import Path

    cache = Path(__file__).resolve().parent.parent / "build" / "benchmark_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.exit(main())
