"""One run of one cell: set up, warm up, measure, check, and the result line.

The cell, its configuration, its traffic and its metrics are all found by
name from `BENCHMARK.json`, so that a new configuration, traffic mix or
metric is new files:

- a configuration, `benchmark/configs/<file>.json`, names three modules:
  its `system` (`benchmark/systems/<system>.py`: the class `System`, and
  `instrument(spans)` and `counters()`, see `systems/whisper.py`), its plain
  `reference` (`benchmark/references/<reference>.py`, whose `Dims.of` gives
  the metrics their shapes) and its `check` (`benchmark/checks/<check>.py`:
  `prepare(items, config)` and `verdict(config, cases, seed, device)`, see
  `checks/whisper.py`);
- a traffic mix, `benchmark/traffic/<mix>.json`, names by its `kind` its
  runner, `benchmark/generators/<kind>.py` (see `generator.py`);
- each metric is read by `benchmark/metrics/<metric>.py`, whose `read(run)`
  returns its value, or None where it finds nothing to read;
- each cell's limits, `benchmark/limits/<cell>.json`: every number the
  check gives (and `missing`, the requests with no answer) that the file
  names is compared with its limit there.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "whisperkit_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell and everything the manifest says of it."""

    manifest: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, kind: str) -> list[dict]:
        """The cell's metrics of `kind` ("end_to_end" or "per_layer"): those
        that list it, or that list no cells."""
        return [m for m in self.manifest[kind] if self.name in m.get("workloads", [self.name])]


def cell_of(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of the manifest at `root`, its files read."""
    manifest = load_json(root / "BENCHMARK.json")
    workloads = {w["name"]: w for w in manifest["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = workloads[name]
    config = next(c for c in manifest["configs"] if c["name"] == w["config"])
    return Cell(manifest, w, load_json(root / config["file"]),
                load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
                load_json(BENCH_DIR / "limits" / f"{name}.json"))


def module_at(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_counters() -> dict:
    """The process's CPU seconds (a wait on the card spins) and its garbage
    collector's pauses: what the host did during a window."""
    return {"cpu_s": time.process_time(), "gc_s": _gc["s"], "gc_gen2": _gc["gen2"]}


_gc = {"s": 0.0, "gen2": 0, "t": 0.0}


def _gc_clock(phase: str, info: dict) -> None:
    if phase == "start":
        _gc["t"] = time.perf_counter()
    else:
        _gc["s"] += time.perf_counter() - _gc["t"]
        _gc["gen2"] += info.get("generation") == 2


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Run:
    """What a metric's `read(run)` reads."""

    cell: Cell
    seed: int
    seconds: float
    setup_s: float
    window: object  # generator.Window
    spans: object  # spans.Spans
    counters: dict  # the system's counters over the window
    dims: object  # the reference's Dims
    max_batch: Optional[int] = None

    def slice_calls(self, kind: str):
        """The encode or decode calls inside the traced slice."""
        sl = self.window.trace
        return self.spans.between(sl.t0, sl.t1, kind)


def require_devices(chips: int) -> Optional[str]:
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device: this benchmark runs on the card only"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} found"
    return None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda",
             warmup: bool = True) -> dict:
    """Run the cell once on `device` and return the result line's object
    (without the device block). The checks' lines go to stderr. Without
    `warmup` (the control's readings, which time nothing) set-up skips it."""
    import gc

    import torch

    from benchmark import generator
    from benchmark.loadgen import percentile
    from benchmark.spans import Spans

    if _gc_clock not in gc.callbacks:
        gc.callbacks.append(_gc_clock)

    system_mod = importlib.import_module(f"benchmark.systems.{cell.config['system']}")
    reference_mod = importlib.import_module(f"benchmark.references.{cell.config['reference']}")
    check_mod = importlib.import_module(f"benchmark.checks.{cell.config['check']}")
    dims = reference_mod.Dims.of(cell.config["model"])
    cuda = torch.device(device).type == "cuda"

    system = system_mod.System(cell.config, seed, device)
    gen = generator.make(cell.traffic, system, seed, seconds)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with Spans(system_mod.instrument) as spans:
        if warmup:
            gen.warmup()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        t_window = time.perf_counter()
        g0 = system_mod.counters()
        host0 = host_counters()
        win = gen.window(seconds, trace, spans)
        g1 = system_mod.counters()
        host1 = host_counters()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    max_batch = cell.traffic.get("scheduler", {}).get("max_batch")
    run = Run(cell, seed, seconds, setup_s, win, spans, {k: g1[k] - g0[k] for k in g0}, dims, max_batch)

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        value = module_at(BENCH_DIR / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"attempted": win.attempted, "failed": win.failed, "metrics": metrics, "peak": peak}
    if trace:
        sl = win.trace
        labels = [(c.kind, c.t0, c.t1) for c in spans.calls]
        out["trace"] = {"busy_s": sl.busy_s(), "window_s": sl.window_s}
        out["breakdown"] = {"device_ops": sl.top_ops(10), "idle_gaps": sl.idle_gaps(labels, 10)}
    if win.late_s:
        late = sorted(win.late_s)
        out["generator"] = {"late_p50_s": late[len(late) // 2], "late_max_s": late[-1]}
    out["host"] = {k: host1[k] - host0[k] for k in host0}
    calls = [c for c in spans.calls if c.t0 >= t_window]
    if win.latencies:
        lat = win.latencies
        out["latency"] = {"p50": percentile(lat, 50), "p90": percentile(lat, 90), "p99": percentile(lat, 99),
                          "max": max(lat), "windows_per_batch": sum(win.batches) / max(1, len(win.batches)),
                          "decode_s_max": max((c.t1 - c.t0 for c in calls if c.kind == "decode"), default=0.0)}

    # the check: the program's state freed first, then the reference, in blocks
    per_item, counted = check_mod.prepare(win.items, cell.config)
    cases = gen.cases(win.items, per_item, seed)
    del gen, run, spans, win, per_item
    system.close()
    del system
    if cuda:
        torch.cuda.empty_cache()
    found, out["judged"] = check_mod.verdict(cell.config, cases, seed, device)
    values = {**found, **counted, "missing": out["failed"]}
    unknown = sorted(set(cell.limits) - set(values))
    if unknown:
        raise KeyError(f"the limits of {cell.name} name numbers that the check does not give: {unknown}")
    checks = {k: {"value": values[k], "limit": limit} for k, limit in cell.limits.items()}
    out["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return out


def main(args, t_start: float) -> int:
    import torch

    cell = cell_of(args.workload)
    problem = require_devices(cell.workload["chips"])
    if problem is not None:
        print(problem, file=sys.stderr)
        return 1
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print(f"the run loaded JAX or the JAX package: {', '.join(found)}", file=sys.stderr)
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.workload["chips"],
              "memory_peak_bytes": int(out.pop("peak", 0))}
    return emit(out, device)


def emit(out: dict, device: dict) -> int:
    trace = out.pop("trace", None)
    if trace is not None:
        device.update(trace)
    checks = out.pop("checks")
    line = {"correct": out.pop("correct"), "attempted": out.pop("attempted"), "failed": out.pop("failed"),
            "metrics": out.pop("metrics"), "device": device, **out, "checks": checks}
    for v in line["metrics"].values():
        if not math.isfinite(v["value"]):
            raise ValueError(f"a metric is not finite: {line['metrics']}")
    print(json.dumps(line))
    return 0
