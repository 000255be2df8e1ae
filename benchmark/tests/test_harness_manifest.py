"""The manifest (`BENCHMARK.json`) against the rules it keeps: names
and units, the files each entry names, which cells report which metrics,
and the time a full check takes."""

from __future__ import annotations

import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion", "experts_per", "d_model",
               "ffn")


@pytest.fixture(scope="module")
def manifest():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in manifest["paths"])
    assert len(manifest["command"]) <= 32 and all(one_line(w) for w in manifest["command"])
    assert not any(w.startswith("/") or ".." in w for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(manifest, section):
    entries = manifest[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert set(e) <= KEYS[section] and set(e) >= KEYS[section] - {"workloads", "bound"}
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert one_line(e[text]), e


def test_configs(manifest):
    workloads = manifest["workloads"]
    assert 1 <= len(manifest["configs"]) <= 24
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert any(w["config"] == c["name"] for w in workloads)
        assert any(c["file"].startswith(p + "/") for p in manifest["paths"])
        data = harness.load_json(harness.ROOT / c["file"])
        assert data["name"] == c["name"] and data["source"] == c["source"] and data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(w in k for k in c["reduced"] for w in WIDTH_WORDS) and not any(
            k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert (harness.BENCH_DIR / "references" / f"{data['reference']}.py").exists()
        assert (harness.BENCH_DIR / "systems" / f"{data['system']}.py").exists()
        assert (harness.BENCH_DIR / "checks" / f"{data['check']}.py").exists()


def test_workloads(manifest):
    workloads = manifest["workloads"]
    assert 1 <= len(workloads) <= 24
    pairs = [(w["config"], w["traffic"]) for w in workloads]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in workloads) <= max(1, len(workloads) // 4)
    for w in workloads:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"]) and NAME.match(w["config"])
        traffic = harness.load_json(harness.BENCH_DIR / "traffic" / f"{w['traffic']}.json")
        assert (harness.BENCH_DIR / "generators" / f"{traffic['kind']}.py").exists()
        assert (harness.BENCH_DIR / "limits" / f"{w['name']}.json").exists()


def test_every_metric_has_a_reader(manifest):
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_bounds(manifest):
    names = [m["name"] for m in manifest["end_to_end"]]
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert 1 <= len(manifest["per_layer"]) <= 128


def test_cells_report_what_their_metrics_move(manifest):
    """Every cell reports setup_s, another end-to-end metric and a per-layer
    one; a per-layer metric's cells all report the metric it moves."""
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = [w["name"] for w in manifest["workloads"]]

    def cells_of(m):
        return m.get("workloads", cells)

    for m in manifest["per_layer"] + list(e2e.values()):
        assert set(cells_of(m)) <= set(cells), m["name"]
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(cells_of(m)) <= set(cells_of(e2e[m["moves"]])), m["name"]
    for cell in cells:
        reported = [n for n, m in e2e.items() if cell in cells_of(m)]
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert any(cell in cells_of(m) for m in manifest["per_layer"]), cell


def test_a_full_check_fits(manifest):
    """2 + 14 runs a cell at run_seconds + 60 s each, 2 x 90 s a cell to
    compile and 1200 s spare fit into 43200 s with 24 cells."""
    per_run = manifest["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 180 + 1200 <= 43200
