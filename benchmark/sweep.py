"""The rate sweep that fixes an open-loop cell's offered rate: one process,
one system, the cell's traffic offered at each rate in turn for a window,
then drained. A rate is sustained when the backlog (requests due and not yet
answered), sampled over the window's second half, grows by no more than
SLOPE_LIMIT requests a second (a least-squares slope). The last line names
the knee, the highest rate sustained with every lower rate sustained too,
and the cell's rate, 0.8 of it. Not a benchmark run; the cell's traffic
file holds the chosen rate as a number.

    python benchmark/sweep.py --workload turbo.requests --rates 8 12 16 20 24 28 --seconds 20
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SLOPE_LIMIT = 0.5


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=3_800_000_001)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import importlib

    from benchmark import generator, harness, loadgen

    cell = harness.cell_of(args.workload)
    system = importlib.import_module(f"benchmark.systems.{cell.config['system']}")
    sut = system.System(cell.config, args.seed, "cuda")
    first = generator.make(cell.traffic, sut, args.seed, args.seconds)
    first.warmup()
    knee, failed = None, False
    for rate in sorted(args.rates):
        traffic = {**cell.traffic, "rate_rps": rate}
        gen = generator.runner(traffic["kind"])(traffic, sut, args.seed, args.seconds, scheduler=first.scheduler)
        t = time.perf_counter()
        win = gen.window(args.seconds, False)
        answered_in = sum(1 for lat, due in zip(win.latencies, gen.due) if due + lat <= args.seconds)
        at = np.linspace(args.seconds / 2, args.seconds, 11)
        backlog = [sum(1 for due, lat in zip(gen.due, win.latencies) if due <= x < due + lat) for x in at]
        slope = float(np.polyfit(at, backlog, 1)[0])
        print(json.dumps({
            "rate_rps": rate, "offered": len(gen.due), "answered_in_window": answered_in,
            "kept_up": answered_in / len(gen.due), "backlog_second_half": backlog, "backlog_slope_per_s": slope,
            "sustained": slope <= SLOPE_LIMIT,
            "p50_s": loadgen.percentile(win.latencies, 50), "p95_s": loadgen.percentile(win.latencies, 95),
            "failed": win.failed,
            "batch_fill_pct": 100.0 * sum(win.batches) / (traffic["scheduler"]["max_batch"] * max(1, len(win.batches))),
            "late_max_s": max(win.late_s), "seconds": time.perf_counter() - t}), flush=True)
        failed = failed or slope > SLOPE_LIMIT
        knee = knee if failed else rate
    print(json.dumps({"knee_rps": knee, "rate_rps": None if knee is None else round(0.8 * knee, 1)}))
    sut.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
