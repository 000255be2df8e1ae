"""The correctness check against broken programs: a run on the CPU at tiny
widths (the harness's look for a card skipped, the rest of the run as the
card runs it), once sound and once with each fault the cells can have
planted in the timed path underneath; and the lower-precision control.

At these widths a sound run reads a widest gap of 0 to 0.04 and each fault
far above the tiny limit (conftest.LIMITS, 0.15); the limits of the real
cells come from runs on the card (PERF.md)."""

from __future__ import annotations

import copy
import time

import pytest
import torch

from benchmark import harness
from conftest import tiny_cell

SEED = 2**31 + 77


def run(cell, seed=SEED, seconds=2.0):
    return harness.run_cell(cell, seed, seconds, False, time.perf_counter(), device="cpu")


@pytest.mark.parametrize("workload", ["turbo.longform", "turbo.requests", "lv3-w8a16.longform"])
def test_a_sound_run_is_correct(louder_embedding, workload):
    out = run(tiny_cell(workload))
    assert out["correct"], out["checks"]
    assert out["judged"]["tokens"] > 100


def test_a_token_altered_where_it_is_produced(louder_embedding, monkeypatch):
    from whisperkit_tpu_torch.decoding import loop

    sample = loop.sample_token
    calls = []

    def altered(logits, *args, **kwargs):
        token, logprob = sample(logits, *args, **kwargs)
        calls.append(1)
        if len(calls) % 40 == 20:  # one token of every row, mid-window
            token = (token + 7) % 50000
        return token, logprob

    monkeypatch.setattr(loop, "sample_token", altered)
    out = run(tiny_cell())
    assert not out["correct"] and out["checks"]["gap_max"]["value"] > 0.15, out["checks"]


def test_rows_mixed_between_windows(louder_embedding):
    """Each row of a group decodes against another row's audio (the fault of
    a batcher that mixed rows; the control script's `rows_mixed`)."""
    from benchmark.systems import whisper as system

    undo = system.FAULTS["rows_mixed"]()
    try:
        out = run(tiny_cell())
    finally:
        undo()
    assert not out["correct"] and out["checks"]["gap_max"]["value"] > 0.15, out["checks"]


def test_a_step_that_leaves_its_state_unchanged(louder_embedding, monkeypatch):
    """The decode step does not write its keys and values into the cache."""
    from whisperkit_tpu_torch.models import whisper as model

    write = model._self_kv_write

    def stale(cache, new, pos):
        if new.shape[2] > 1:  # the prompt's rows only
            write(cache, new, pos)

    monkeypatch.setattr(model, "_self_kv_write", stale)
    out = run(tiny_cell())
    assert not out["correct"] and out["checks"]["gap_max"]["value"] > 0.15, out["checks"]


def test_the_lower_precision_control_fails(louder_embedding, monkeypatch):
    """The program's W4A16 path in place of the W8A16 configuration's."""
    from benchmark.systems import whisper as system

    real = system.System

    class Control(real):
        def __init__(self, config, seed, device="cuda"):
            config = copy.deepcopy(config)
            config["serving"]["weights"] = "w4a16"
            super().__init__(config, seed, device)

    monkeypatch.setattr(system, "System", Control)
    out = run(tiny_cell("lv3-w8a16.longform"))
    assert not out["correct"] and out["checks"]["gap_max"]["value"] > 0.15, out["checks"]


def test_the_reference_runs_in_float32_with_tf32_off():
    from benchmark.references.whisper import float32_mode

    before = torch.backends.cuda.matmul.allow_tf32
    with float32_mode():
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 == before
