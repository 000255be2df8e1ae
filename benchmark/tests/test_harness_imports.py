"""What the benchmark loads: never JAX or the JAX package (compared by the
whole top-level module name, since the port's name begins with the JAX
package's), and in the yardstick's modules nothing of the program; and a
run without a card prints no result."""

from __future__ import annotations

import ast
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

# modules of the yardstick: they may not import the program
YARDSTICK = ("references/whisper.py", "checks/whisper.py", "roofline.py", "loadgen.py", "trace.py", "workload.py",
             "generator.py", "generators/closed_loop_files.py", "generators/open_loop_requests.py")


def imported_tops(path) -> set[str]:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("whisperkit_tpu_torch", "whisperkit_tpu_torch.ops", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys.modules.get(name) or object())
    assert not [n for n in harness.forbidden_modules() if n.split(".")[0] in ("whisperkit_tpu_torch", "jaxtyping")]
    monkeypatch.setitem(sys.modules, "whisperkit_tpu.ops.mel", object())
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    found = harness.forbidden_modules()
    assert "whisperkit_tpu.ops.mel" in found and "jaxlib.xla_client" in found


@pytest.mark.parametrize("path", sorted(p.relative_to(harness.BENCH_DIR).as_posix()
                                        for p in harness.BENCH_DIR.rglob("*.py")))
def test_no_file_imports_jax(path):
    assert not imported_tops(harness.BENCH_DIR / path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "whisperkit_tpu_torch" not in imported_tops(harness.BENCH_DIR / path)


def test_a_run_loads_no_jax():
    """Every module a run imports, the port's pipeline and batcher among
    them, in a fresh interpreter: no JAX, no JAX package."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.harness, benchmark.generator, benchmark.spans, benchmark.trace, benchmark.checks.whisper\n"
        "import benchmark.generators.closed_loop_files, benchmark.generators.open_loop_requests\n"
        "import benchmark.systems.whisper, benchmark.references.whisper\n"
        "import whisperkit_tpu_torch.pipelines.whisper, whisperkit_tpu_torch.pipelines.scheduler\n"
        "import whisperkit_tpu_torch.ops.quant, whisperkit_tpu_torch.decoding.graph\n"
        "print(benchmark.harness.forbidden_modules())\n" % str(harness.ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the command prints no result and fails; so it
    does in a directory holding only the manifest and the benchmark."""
    for root in (harness.ROOT, tmp_path):
        if root == tmp_path:
            shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                            ignore=shutil.ignore_patterns("__pycache__", "tests"))
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "lv3-w8a16.longform", "--seed",
                              "4294967311", "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0 and out.stdout.strip() == "", (out.stdout, out.stderr[-2000:])
