"""Shared fixtures of the benchmark's own tests, which run on the CPU:

    python -m pytest benchmark/tests -q

Tests that need the card carry the `card` marker and skip without one
(decided inside the test, never at import); on the card they run with
`python -m pytest benchmark/tests -q -m card`.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

TINY = dict(d_model=64, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
            encoder_ffn_dim=256, decoder_ffn_dim=256, num_mel_bins=80)
LONGFORM = {"kind": "closed_loop_files", "file_minutes": [1.0, 0.75], "group": 4, "warmup_files": [1],
            "trace_file": 1, "sample_windows": 4}
LIMITS = {"gap_max": 0.15, "unmatched": 0, "missing": 0}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def tiny_cell(workload: str = "turbo.longform", traffic: dict | None = None, limits: dict | None = None) -> harness.Cell:
    """A cell of the manifest at tiny widths (d_model 64, two layers a
    stack) for the CPU, with the published vocabulary and frame count."""
    base = harness.cell_of(workload)
    config = copy.deepcopy(base.config)
    config["model"].update(TINY)
    if traffic is None:
        traffic = LONGFORM if base.traffic["kind"] == "closed_loop_files" else {
            **base.traffic, "rate_rps": 2.0, "warmup_batches": [1, 2], "pool_seconds": 200, "drain_seconds": 30,
            "sample_requests": 3}
    return harness.Cell(base.manifest, base.workload, config, traffic, dict(limits or LIMITS))


@pytest.fixture
def louder_embedding(monkeypatch):
    """Scale the token embedding x4 in the weights both sides get: at width
    64 a random decoder otherwise ends most windows after a few tokens."""
    from benchmark.references import whisper as ref

    init = ref.init_weights

    def init_weights(dims, seed, device, dtype=torch.bfloat16):
        tree = init(dims, seed, device, dtype)
        tree["decoder"]["token_embed"] = tree["decoder"]["token_embed"] * 4
        return tree

    monkeypatch.setattr(ref, "init_weights", init_weights)
    monkeypatch.setattr("benchmark.systems.whisper.init_weights", init_weights)
