"""The arithmetic of the metrics that read the program's spans against the
trace (`program_spans.py` and its four readers), on a hand-worked slice
and hand-made spans: device idle inside and outside the named spans, per
window, per decode call and per batch, the batcher's queue wait, the idle
split by innermost span, and None where the program keeps no spans."""

from __future__ import annotations

import types

import pytest

from benchmark import harness, program_spans, trace
from whisperkit_tpu_torch.core import signposts


def _slice(t0: float, t1: float, busy: list[tuple[float, float]]) -> trace.Slice:
    """A slice whose trace clock is the host clock in µs."""
    sl = trace.Slice(sync=False)
    sl.t0, sl.t1, sl._offsets = t0, t1, [0.0]
    sl.kernels = [("k", a * 1e6, b * 1e6, None) for a, b in busy]
    return sl


class Ring:
    """Hand-made spans, in the port's Span's fields, served as its ring."""

    def __init__(self):
        self.spans = []

    def add(self, name, t0, t1, parent=None, request=None, **attrs):
        s = types.SimpleNamespace(name=name, t0=t0, t1=t1, id=len(self.spans) + 1, thread=1, seconds=t1 - t0,
                                  parent=None if parent is None else parent.id, request=request, attrs=attrs)
        self.spans.append(s)
        return s

    def between(self, t0, t1):
        return sorted((s for s in self.spans if s.t0 <= t1 and s.t1 >= t0), key=lambda s: s.t0)


@pytest.fixture
def ring(monkeypatch):
    r = Ring()
    monkeypatch.setattr(signposts, "spans_between", r.between)
    return r


def read(name: str, run) -> float | None:
    return harness.module_at(harness.BENCH_DIR / "metrics" / f"{name}.py").read(run)


def _longform(ring):
    """A traced file over [0, 10] s: the device busy in [2, 3], [3.5, 5],
    [6, 6.5]; four real windows, two decode calls."""
    root = ring.add("transcribe", 0.5, 9.5, request=1)
    for name, a, b in (("vad", 0.5, 1.0), ("mel", 1.0, 2.0), ("encode", 2.0, 2.2), ("prefill", 2.2, 2.3),
                       ("decode", 2.3, 5.5), ("readback", 5.5, 5.6), ("decode", 6.0, 7.0),
                       ("segments", 7.0, 9.0)):
        ring.add(name, a, b, parent=root, request=1)
    sl = _slice(0.0, 10.0, [(2.0, 3.0), (3.5, 5.0), (6.0, 6.5)])
    result = types.SimpleNamespace(timings=types.SimpleNamespace(total_decoding_windows=4))
    return types.SimpleNamespace(window=types.SimpleNamespace(trace=sl, trace_result=result, batches=[]))


def test_idle_stretches_and_interval_sets():
    sl = _slice(0.0, 10.0, [(2.0, 3.0), (2.5, 3.5), (9.0, 11.0)])
    assert program_spans.idle_us(sl) == [(0.0, 2e6), (3.5e6, 9e6)]
    a = [(0.0, 4.0), (6.0, 10.0)]
    assert program_spans.intersect(a, [(3.0, 7.0), (9.0, 12.0)]) == [(3.0, 4.0), (6.0, 7.0), (9.0, 10.0)]
    assert program_spans.minus(a, [(1.0, 2.0), (3.0, 7.0), (9.5, 12.0)]) == [(0.0, 1.0), (2.0, 3.0), (7.0, 9.5)]
    assert program_spans.idle_s(sl, [(1.0, 5.0)], [(4.0, 4.5)]) == pytest.approx(1.0 + 1.0)


def test_longform_readers(ring):
    run = _longform(ring)
    # transcribe [0.5, 9.5] less encode/prefill/decode: [0.5, 2], [5.5, 6], [7, 9.5];
    # idle there 1.5 + 0.5 + 2.5 s, over 4 windows
    assert read("host_stage_idle_ms.longform", run) == pytest.approx(1e3 * 4.5 / 4)
    # decode spans [2.3, 5.5], [6, 7]: idle [3, 3.5], [5, 5.5], [6.5, 7], over 2 calls
    assert read("decode_idle_ms.longform", run) == pytest.approx(1e3 * 1.5 / 2)


def test_idle_split_by_innermost_span(ring):
    run = _longform(ring)
    sl = run.window.trace
    split = program_spans.idle_by_span(sl, program_spans.found(sl))
    want = {"outside spans": 1.0, "vad": 0.5, "mel": 1.0, "decode": 1.5, "readback": 0.1, "transcribe": 0.9,
            "segments": 2.0}
    assert split.keys() == want.keys()
    for k, v in want.items():
        assert split[k] == pytest.approx(v), k
    assert sum(split.values()) == pytest.approx(7.0)
    assert program_spans.named_share(split) == pytest.approx(1.0 - 1.9 / 7.0)
    # only the stretches of 0.6 s or more: [0, 2], [5, 6], [6.5, 10]
    long = program_spans.idle_by_span(sl, program_spans.found(sl), min_us=0.6e6)
    assert sum(long.values()) == pytest.approx(6.5) and "readback" in long and long["decode"] == pytest.approx(1.0)


def test_requests_readers(ring):
    """Batches before a slice over [10, 20] s, then three batches in it."""
    ring.add("batch", 0.1, 0.5, windows=1, wait_sum_s=100.0)  # before the window's batches
    ring.add("batch", 1.0, 3.0, windows=2, wait_sum_s=0.4)
    ring.add("batch", 4.0, 6.0, windows=4, wait_sum_s=2.0)
    c = ring.add("batch", 9.0, 12.0, windows=3, wait_sum_s=9.0)  # the slice opened inside it
    ring.add("encode", 9.5, 10.5, parent=c)
    ring.add("decode", 10.5, 11.8, parent=c)
    d = ring.add("batch", 12.0, 16.0, windows=2, wait_sum_s=1.0)
    for name, a, b in (("mel", 12.0, 12.5), ("encode", 12.5, 13.2), ("prefill", 13.2, 13.3),
                       ("decode", 13.3, 15.2), ("segments", 15.2, 16.0)):
        ring.add(name, a, b, parent=d)
    gather = ring.add("batch.gather", 16.0, 16.8)
    ring.add("vad", 16.2, 16.6, parent=gather, request=9)
    e = ring.add("batch", 16.8, 21.0, windows=1, wait_sum_s=0.5)
    ring.add("encode", 17.0, 17.5, parent=e)
    ring.add("decode", 17.5, 19.5, parent=e)
    sl = _slice(10.0, 20.0, [(10.0, 11.5), (13.0, 15.0), (17.0, 19.0)])
    run = types.SimpleNamespace(window=types.SimpleNamespace(trace=sl, trace_result=None, batches=[2, 4]))
    # the two batches before the slice that batch_fill reads: (0.4 + 2.0) s over 6 windows
    assert read("queue_wait_ms.requests", run) == pytest.approx(1e3 * 2.4 / 6)
    # idle in the batches less their device stages: c 0.2, d 0.5 + 0.8, e 0.2 + 0.5; the vad's 0.4;
    # not the gather's other 0.4; over the two batches whose encode lies in the slice
    assert read("batch_host_idle_ms.requests", run) == pytest.approx(1e3 * 2.6 / 2)


@pytest.mark.parametrize("name", ["host_stage_idle_ms.longform", "decode_idle_ms.longform",
                                  "queue_wait_ms.requests", "batch_host_idle_ms.requests"])
def test_readers_find_nothing_without_spans(ring, monkeypatch, name):
    """An empty ring, or a program without one (the parent of the port's
    span ring), gives None, and never raises."""
    sl = _slice(0.0, 10.0, [(2.0, 3.0)])
    result = types.SimpleNamespace(timings=types.SimpleNamespace(total_decoding_windows=4))
    run = types.SimpleNamespace(window=types.SimpleNamespace(trace=sl, trace_result=result, batches=[1]))
    assert read(name, run) is None
    monkeypatch.delattr(signposts, "spans_between")
    assert read(name, run) is None
    run.window.trace = None
    assert read(name, run) is None


def test_traced_roots_beside_untraced_ones(ring):
    """The tool's overhead reading: the traced file's root against the same
    file's earlier roots; the batches in the slice against those before."""
    ring.add("transcribe", -30.0, -21.0, request=7, audio_s=600.0)
    ring.add("transcribe", -20.0, -19.5, request=8, audio_s=300.0)
    run = _longform(ring)
    ring.spans[2].attrs["audio_s"] = 600.0  # the traced file's root
    sl = run.window.trace
    out = program_spans.traced_against_untraced(sl, program_spans.found(sl, -100.0, sl.t1))
    assert out == {"transcribe_s_traced": pytest.approx(9.0), "transcribe_s_untraced": [pytest.approx(9.0)],
                   "spans_per_transcribe": 9}
    ring.spans.clear()
    ring.add("batch", 1.0, 3.0, windows=2, rows=4)
    ring.add("batch", 4.0, 7.0, windows=5, rows=8)
    ring.add("batch", 8.0, 8.6, windows=4, rows=4)
    b = ring.add("batch", 11.0, 12.0, windows=4, rows=4)
    ring.add("encode", 11.2, 11.5, parent=b)
    ring.add("decode", 11.5, 11.9, parent=b)
    ring.add("batch", 13.0, 14.0, windows=16, rows=16)  # no earlier batch of its rows
    sl = _slice(10.0, 20.0, [(10.0, 11.0)])
    out = program_spans.traced_against_untraced(sl, program_spans.found(sl, 0.0, sl.t1))
    assert out == {"batch_s_traced": pytest.approx(1.0), "batch_s_untraced": pytest.approx(1.3),
                   "batches_compared": 1, "spans_per_batch": 2}
