"""Each cell once on the card through `BENCHMARK.json`'s command, and its
result line's keys, metrics and checks. Skips without a card; on the card:

    python -m pytest benchmark/tests/test_harness_card.py -q -m card
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_runs_and_is_correct(card, workload, trace):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(2**31 + 101),
                          "--seconds", "10", "--trace", str(trace)], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(line)[-1] == "checks"
    assert line["correct"] and line["failed"] == 0, line["checks"]
    cell = harness.cell_of(workload)
    want = {m["name"] for m in cell.metrics("per_layer" if trace else "end_to_end")}
    assert set(line["metrics"]) == want
    device = line["device"]
    assert device["platform"] == "gpu" and device["count"] == cell.workload["chips"] and device["memory_peak_bytes"] > 0
    if trace:
        assert 0 < device["busy_s"] <= device["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10 and len(line["breakdown"]["idle_gaps"]) <= 10
    for m in line["metrics"].values():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 105
