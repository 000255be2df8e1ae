"""The yardstick's arithmetic on hand-worked cases: percentiles from due
times, the window's rate with the file in flight, the schedule's fixed
work, the trace's busy union and idle gaps, and the operation, byte and
roofline counts."""

from __future__ import annotations

import statistics
import sys
import time
import types

import numpy as np
import pytest

from benchmark import generator, loadgen, roofline, trace
from benchmark.references.whisper import Dims

LARGE_V3 = Dims(128, 51866, 1500, 448, 1280, 20, 20, 32, 32, 5120, 5120)


def test_percentile_is_numpys_linear_rank():
    values = list(np.random.default_rng(0).exponential(1.0, 501))
    for q in (50, 90, 95, 99):
        assert loadgen.percentile(values, q) == pytest.approx(float(np.percentile(values, q)))
    assert loadgen.percentile(list(range(1, 21)), 95) == pytest.approx(19.05)


def test_latency_runs_from_the_due_time_and_counts_every_request():
    due = [0.0, 1.0, 2.0, 3.0]
    # request 1 was submitted late and answered at 4.5; request 3 never answered
    lat, missing = loadgen.latencies(due, {0: 0.5, 1: 4.5, 2: 2.25}, drain_end=10.0)
    assert lat == [0.5, 3.5, 0.25, 7.0] and missing == 1
    assert loadgen.percentile(lat, 95) == pytest.approx(3.5 + 0.85 * 3.5)


def test_schedule_is_the_traffics_whatever_the_seed():
    clips = [{"share": 0.85, "min_s": 2, "max_s": 30}, {"share": 0.15, "min_s": 30, "max_s": 120}]
    due, lengths = loadgen.schedule(16.0, 30.0, clips, 0)
    again, _ = loadgen.schedule(16.0, 30.0, clips, 0)
    other, other_len = loadgen.schedule(16.0, 30.0, clips, 1)
    assert len(due) == 480 and np.array_equal(due, again) and not np.array_equal(due, other)
    assert 0.0 < due.min() and due.max() < 30.0 and np.all(np.diff(due) >= 0)
    assert sum(1 for x in lengths if x > 30) == 72 and sum(1 for x in other_len if x > 30) == 72
    assert np.all((lengths >= 2) & (lengths <= 120))


class SlowSystem:
    """A stand-in pipeline: a file takes 0.1 s per minute of audio."""

    def options(self, group):
        return None

    def transcribe(self, audio, options):
        time.sleep(len(audio) / 16000 / 600)
        return types.SimpleNamespace(segments=[])


def test_window_rate_counts_the_file_in_flight():
    traffic = {"kind": "closed_loop_files", "file_minutes": [2, 4], "group": 4, "warmup_files": [],
               "trace_file": 0, "sample_windows": 1}
    gen = generator.make(traffic, SlowSystem(), seed=3, seconds=0.25)
    win = gen.window(0.25, trace=False)
    # 0.2 s, 0.4 s: the second file is in flight at 0.25 s and runs to its end
    assert win.attempted == 2 and win.audio_s == pytest.approx(360.0)
    assert 0.6 <= win.wall_s < 0.8
    assert win.audio_s / win.wall_s == pytest.approx(360.0 / 0.6, rel=0.15)


def test_a_runner_is_found_by_its_kind(monkeypatch):
    """A traffic kind is a module of its own: a new one needs no edit here."""
    fake = types.ModuleType("benchmark.generators.fake_kind")
    fake.Runner = lambda traffic, system, seed, seconds: (traffic["kind"], seed, seconds)
    monkeypatch.setitem(sys.modules, "benchmark.generators.fake_kind", fake)
    assert generator.make({"kind": "fake_kind"}, None, 2**33, 2.5) == ("fake_kind", 2**33, 2.5)
    with pytest.raises(ValueError, match="no runner"):
        generator.make({"kind": "no_such_kind"}, None, 1, 1.0)


def test_busy_is_the_union_of_intervals():
    assert trace.union_us([(0, 10), (5, 12), (20, 25), (24, 24.5)]) == 17
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]


def fake_slice(kernels, t0=0.0, t1=1.0, launch=None):
    sl = trace.Slice(sync=False)
    sl.kernels, sl.launch_us, sl.t0, sl.t1, sl._offsets = kernels, launch or {}, t0, t1, [0.0]
    return sl


def test_slice_busy_gaps_and_spans():
    # host clock = trace clock here; kernels in us
    sl = fake_slice([("a", 100_000.0, 300_000.0, 1), ("b", 250_000.0, 400_000.0, 2), ("a", 700_000.0, 900_000.0, 3)],
                    launch={1: 50_000.0, 2: 60_000.0, 3: 650_000.0})
    assert sl.busy_s() == pytest.approx(0.5)
    assert sl.top_ops(1) == [["a", pytest.approx(0.4)]]
    gaps = sl.idle_gaps([("decode", 0.6, 0.95), ("encode", 0.0, 0.08)], 3)
    assert gaps == [["outside spans", pytest.approx(0.3)], ["encode", pytest.approx(0.1)],
                    ["decode", pytest.approx(0.1)]]
    assert [k[0] for k in sl.launched_in([(0.0, 0.1)])] == ["a", "b"]
    assert [k[0] for k in sl.launched_in([(0.6, 0.7)])] == ["a"]


def test_k2_bound_at_the_encoders_shapes():
    """B=32, 20 heads, 1500 frames, Dh 64: 4 B H S^2 Dh = 368.64 GFLOP over
    989 TFLOP/s = 0.3727 ms (PERF.md's K2 bound); bytes 0.49 GB bound it
    at 0.147 ms, below."""
    assert roofline.mha_encoder_bound_s(32, 20, 1500, 64) == pytest.approx(368.64e9 / 989e12)
    assert roofline.mha_encoder_bound_s(32, 20, 1500, 64) * 1e3 == pytest.approx(0.3727, abs=1e-4)


def test_k3_bound_at_the_decode_steps_shapes():
    """B=32, 20 heads, one query, 1500 frames: the int8 K and V codes are
    2 x 32 x 20 x 1500 x 64 = 122.88 MB; with the query, its scale, V's
    scales and the float32 output 123.25 MB, over 3.35 TB/s = 36.79 us."""
    nbytes = 640 * (64 + 4 + 2 * 1500 * 64 + 64 * 4 + 64 * 4)
    assert nbytes == 123_251_200
    assert roofline.cross_attend_q8_bound_s(32, 20, 1, 1500, 64) == pytest.approx(nbytes / 3.35e12)


def test_model_flops_of_a_large_v3_window():
    """About 3.0 TFLOP a window that decodes 221 tokens: encoder 2.27, the
    cross-KV projection 0.31, the decoder 0.41 (by hand, below)."""
    d, s = 1280, 1500
    enc = 2 * (2 * s * 128 * 3 * d + s * d * 3 * d + 32 * (4 * s * d * d + 2 * s * d * 5120 + 2 * s * s * d))
    assert roofline.encoder_flops(LARGE_V3) == enc
    assert roofline.cross_kv_flops(LARGE_V3) == 2 * 32 * 2 * s * d * d
    tok = 2 * (32 * (6 * d * d + 2 * d * 5120 + 2 * 101 * d + 2 * s * d) + d * 51866)
    assert roofline.token_flops(LARGE_V3, 100) == tok
    total = roofline.window_flops(LARGE_V3, 221)
    assert 2.9e12 < total < 3.1e12
    assert total == pytest.approx(enc + 2 * 32 * 2 * s * d * d
                                  + sum(roofline.token_flops(LARGE_V3, p) for p in range(223)))


def test_spread_is_the_interquartile_share_of_the_median():
    """The bound's rule reads spreads with Python's quartiles; numpy's sit
    closer together."""
    runs = [100.0, 101.0, 99.0, 103.0, 98.0, 100.5]
    q1, _, q3 = statistics.quantiles(runs, n=4)
    assert (q3 - q1) / statistics.median(runs) == pytest.approx((101.5 - 98.75) / 100.25)
