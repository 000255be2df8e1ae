"""The W8A16 product's roofline share (`metrics/w8a16_roofline.longform.py`)
on a synthetic trace: known launches inside known decode calls."""

from __future__ import annotations

import types

import pytest

from benchmark import harness, trace
from benchmark.references.whisper import Dims
from benchmark.spans import Call

LARGE_V3 = Dims(128, 51866, 1500, 448, 1280, 20, 20, 32, 32, 5120, 5120)


def metric():
    return harness.module_at(harness.BENCH_DIR / "metrics" / "w8a16_roofline.longform.py")


def run_of(kernels, calls):
    """A run whose traced slice holds `kernels` (name, start us, end us,
    launched at us) and whose decode calls are `calls`; host clock = trace
    clock in seconds."""
    sl = trace.Slice(sync=False)
    sl.kernels = [(name, s, e, i) for i, (name, s, e, _) in enumerate(kernels)]
    sl.launch_us = {i: at for i, (_, _, _, at) in enumerate(kernels)}
    sl.t0, sl.t1, sl._offsets = 0.0, 10.0, [0.0]
    spans = types.SimpleNamespace(between=lambda t0, t1, kind: [c for c in calls if c.kind == kind])
    run = types.SimpleNamespace(window=types.SimpleNamespace(trace=sl), dims=LARGE_V3)
    run.slice_calls = lambda kind: spans.between(sl.t0, sl.t1, kind)
    return run


def test_step_bound_at_large_v3_widths():
    """32 rows: a [1280, 1280] product moves 1,638,400 codes + 2,560 scale
    bytes + 81,920 of x + 81,920 of y = 1,804,800 bytes (0.539 us at
    3.35 TB/s; its 105 MFLOP take 0.106 us at 989 TFLOP/s); fc1 and fc2
    6,574,080 and 6,897,664 bytes; 32 layers of six and two of those."""
    m = metric()
    assert m.product_bound_s(32, 1280, 1280) == pytest.approx(1_804_800 / 3.35e12)
    assert m.product_bound_s(32, 1280, 5120) == pytest.approx((6_553_600 + 10_240 + 81_920 + 327_680) / 3.35e12)
    step = 32 * (6 * 1_804_800 + (6_553_600 + 10_240 + 81_920 + 327_680) + (6_553_600 + 2_560 + 327_680 + 81_920))
    assert m.step_bound_s(LARGE_V3, 32) == pytest.approx(step / 3.35e12)
    # at 4096 rows the operations bind: 2 x 4096 x 1280^2 / 989e12
    assert m.product_bound_s(4096, 1280, 1280) == pytest.approx(2 * 4096 * 1280 * 1280 / 989e12)


def test_share_sums_bounds_over_the_kernels_device_time():
    """Two decode calls (32 rows x 10 steps, 16 rows x 5 steps); the kernel's
    launches inside them take 3 ms and 1 ms of device time; other kernels
    and launches outside the calls do not count."""
    m = metric()
    calls = [Call("decode", 1.0, 2.0, 32, 10), Call("decode", 3.0, 4.0, 16, 5), Call("encode", 5.0, 6.0, 32)]
    kernels = [("void w8a16_matmul_kernel<4>(Args)", 1_100_000.0, 1_102_000.0, 1_050_000.0),
               ("void w8a16_matmul_kernel<4>(Args)", 1_200_000.0, 1_201_000.0, 1_150_000.0),
               ("cross_attend_q8_kernel", 1_300_000.0, 1_400_000.0, 1_250_000.0),
               ("void w8a16_matmul_kernel<2>(Args)", 3_100_000.0, 3_101_000.0, 3_050_000.0),
               ("void w8a16_matmul_kernel<4>(Args)", 5_100_000.0, 5_900_000.0, 5_050_000.0)]
    got = m.read(run_of(kernels, calls))
    bound = 10 * m.step_bound_s(LARGE_V3, 32) + 5 * m.step_bound_s(LARGE_V3, 16)
    assert got == pytest.approx(100.0 * bound / 4e-3)


def test_nothing_to_read_without_the_kernel():
    m = metric()
    calls = [Call("decode", 1.0, 2.0, 32, 10)]
    assert m.read(run_of([("elementwise_kernel", 1_100_000.0, 1_200_000.0, 1_050_000.0)], calls)) is None
    assert m.read(run_of([], [])) is None
    run = run_of([], calls)
    run.window.trace = None
    assert m.read(run) is None
