"""The readings that the correctness check's limits are set from, on the
card at a cell's own size: the program's compared numbers over many seeds
(the lower reading), the same with the lower-precision control in the
program's place (the upper reading), and a planted fault, all in one
process, each seed with its own weights and audio, each a short window at
the cell's own load with its reference check. Not a benchmark run.

    python benchmark/control.py --workload <cell> --seeds 12 --control-seeds 3 --seconds 8 \\
        [--first-seed N] [--fault rows_mixed]

The control is the program with its next weight format below the
configuration's switched on (the system module's `LOWER`: W4A16 for W8A16);
a fault is one of the system module's `FAULTS`. Each reading prints as one
JSON line.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=0)
    p.add_argument("--fault", default="rows_mixed")
    p.add_argument("--first-seed", type=int, default=3_900_000_001)
    p.add_argument("--seconds", type=float, default=8.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import importlib

    from benchmark import harness

    cell = harness.cell_of(args.workload)
    system = importlib.import_module(f"benchmark.systems.{cell.config['system']}")
    real = system.System
    lower = system.LOWER[cell.config["serving"]["weights"]]

    class Control(real):
        def __init__(self, config, seed, device="cuda"):
            config = copy.deepcopy(config)
            config["serving"]["weights"] = lower
            super().__init__(config, seed, device)

    plan = ([("program", i) for i in range(args.seeds)] + [("control", i) for i in range(args.control_seeds)]
            + [(args.fault, i) for i in range(args.fault_seeds)])
    for kind, i in plan:
        seed = args.first_seed + i
        system.System = Control if kind == "control" else real
        undo = system.FAULTS[kind]() if kind == args.fault else None
        t = time.perf_counter()
        try:
            out = harness.run_cell(cell, seed, args.seconds, False, t, warmup=False)
        finally:
            system.System = real
            if undo is not None:
                undo()
        line = {"workload": args.workload, "kind": kind, "weights": lower if kind == "control" else None,
                "seed": seed, "correct": out["correct"], "checks": {k: v["value"] for k, v in out["checks"].items()},
                "judged": out["judged"], "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
