"""The port's Qwen3-TTS stack against the benchmark's plain float32
reference (`benchmark/references/qwen3_tts.py`) on the CPU, at the port's
TINY_TTS_DIMS widths, on the reference's seeded random weights (its
`init_weights`, the port's tree layout), and the benchmark's check of the
TTS cell (`benchmark/checks/qwen3_tts.py`) on the port's pipeline.

The port runs here with float32 activations, so that each tolerance is
float32's: a W8A16 weight is its int8 codes times its bf16 scale, exact in
float32 on both sides, and the two sides differ only by their order of
summation (~1e-6 on logits of order 1, TOL = 1e-4 leaves room). W4A16's
weights lie ~1/16 of a column's range from W8A16's and move the logits by
~1e-1: each tolerance fails it, which the tests check.
"""

import copy
import dataclasses
import sys
import time
from pathlib import Path

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.checks import qwen3_tts as check  # noqa: E402
from benchmark.references import qwen3_tts as ref  # noqa: E402
from benchmark.systems import qwen3_tts as system  # noqa: E402
from whisperkit_tpu_torch.models import qwen3_tts as tm  # noqa: E402
from whisperkit_tpu_torch.ops.quant import quantize_tts_params  # noqa: E402

CELL = "qwen3-tts-0.6b-w8a16.batch4"
SEED = 2**31 + 41
TOL = 1e-4  # float32 logits of order 1: both sides' summation orders
WAVE_TOL = 1e-5  # float32 samples of RMS ~0.1: the conv cascade's summation order (~4e-7 here)
# the cell's model block at TINY_TTS_DIMS (and TINY_C2W_DIMS for the vocoder)
TINY = {"talker": dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                       intermediate_size=128, text_vocab_size=512, tts_pad_token_id=510, tts_bos_token_id=511),
        "code_predictor": dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
                               head_dim=16, intermediate_size=32),
        "speech_decoder": dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                               intermediate_size=64, sliding_window=8, decoder_dim=32)}


def tiny_cell(frames: int = 12) -> harness.Cell:
    """The TTS cell at tiny widths, `frames` frames a row, one warm-up
    paragraph, every row of a paragraph judged."""
    base = harness.cell_of(CELL)
    config = copy.deepcopy(base.config)
    for group, values in TINY.items():
        config["model"][group].update(values)
    traffic = copy.deepcopy(base.traffic)
    traffic["options"]["max_new_tokens"] = frames
    traffic.update(warmup_paragraphs=1, sample_rows=4)
    return harness.Cell(base.manifest, base.workload, config, traffic, dict(base.limits))


@pytest.fixture(scope="module")
def model():
    """(reference dims, the port's dims, the float32 weight tree)."""
    dims = ref.Dims.of(tiny_cell().config["model"])
    pdims = system.port_dims(dims)
    assert dataclasses.replace(pdims, max_seq=tm.TINY_TTS_DIMS.max_seq) == tm.TINY_TTS_DIMS
    return dims, pdims, ref.init_weights(dims, SEED, "cpu", torch.float32, torch.float32)


def port_params(tree, weights: str):
    if weights == "bfloat16":
        return tree
    return quantize_tts_params(tree, min_size=1, bits={"w8a16": 8, "w4a16": 4}[weights])


def talker_cached(params, pdims, embeds, prefill: int, slot: str) -> torch.Tensor:
    """The port's talker: a prefill of `prefill` positions, then one cached
    step a position, each step's slot an int or a 0-d tensor → logits [T, V]."""
    t = embeds.shape[1]
    kv_k, kv_v = tm.init_code_kv_cache(pdims, 1, t, torch.float32, "cpu")
    out = [tm.code_decoder_forward(params, embeds[:, :prefill], 0, kv_k, kv_v, pdims)[0][0]]
    for pos in range(prefill, t):
        at = pos if slot == "int" else torch.tensor(pos)
        out.append(tm.code_decoder_forward(params, embeds[:, pos:pos + 1], at, kv_k, kv_v, pdims)[0][0])
    return torch.cat(out)


@pytest.mark.parametrize("slot", ["int", "tensor"])
@pytest.mark.parametrize("weights", ["bfloat16", "w8a16"])
def test_talker_prefill_then_cached_steps_match_the_full_forward(model, weights, slot):
    dims, pdims, tree = model
    g = torch.Generator().manual_seed(3)
    embeds = 0.05 * torch.randn((1, 14, dims.d_model), generator=g)
    want, _ = ref.Reference(tree, dims, {"weights": weights}).talker(embeds[0])
    got = talker_cached(port_params(tree, weights), pdims, embeds, 9, slot)
    assert (got - want).abs().max() < TOL
    if weights == "w8a16":
        lower = talker_cached(port_params(tree, "w4a16"), pdims, embeds, 9, slot)
        assert (lower - want).abs().max() > TOL


def test_code_predictor_heads_and_codes_at_temperature_0(model, monkeypatch):
    dims, pdims, tree = model
    g = torch.Generator().manual_seed(4)
    hidden = torch.randn((3, dims.d_model), generator=g)
    code0 = torch.randint(0, dims.codebook, (3,), generator=g)
    reference = ref.Reference(tree, dims, {"weights": "w8a16"})
    for weights in ("w8a16", "w4a16"):
        seen = []
        mm = tm._mm_f32
        monkeypatch.setattr(tm, "_mm_f32", lambda x, w: seen.append(mm(x, w)) or seen[-1])
        codes, _ = tm.multicode_forward(port_params(tree, weights), hidden, code0, 0.0, dims=pdims)
        monkeypatch.setattr(tm, "_mm_f32", mm)
        with ref.float32_mode():
            want = reference.code_predictor(hidden, torch.cat([code0[:, None], codes], 1))
        err = (torch.stack(seen, 1) - want).abs().max()
        gap = check.gaps(want.reshape(-1, dims.codebook), codes.reshape(-1), None, 0.0, 5)[0].max()
        if weights == "w8a16":
            assert err < TOL and gap < TOL
        else:
            assert err > TOL


def test_code2wav_matches_the_reference(model):
    dims, pdims, tree = model
    codes = torch.randint(0, dims.codebook, (2, 12, dims.groups), generator=torch.Generator().manual_seed(5))
    codes[1, 9:] = ref.CODEC_EOS  # a row's EOS frames, clamped into the codebook
    got = tm.speech_decoder_forward(tree, codes, pdims)
    want = ref.Reference(tree, dims, {"weights": "w8a16"}).code2wav(codes)
    assert got.shape == want.shape == (2, 12 * 1920)
    # neither faded out nor held at the clamp, which would hide a difference
    assert want.pow(2).mean().sqrt() > 0.05 and (want.abs() > 0.999).float().mean() < 1e-3
    assert (got - want).abs().max() < WAVE_TOL


def run(cell, seconds=1.0):
    return harness.run_cell(cell, SEED, seconds, False, time.perf_counter(), device="cpu")


def test_the_pipeline_w8a16_passes_the_check():
    out = run(tiny_cell())
    assert out["correct"], out["checks"]
    assert out["judged"]["codes"] >= 4 * 12 * 16 and out["checks"]["wave_err"]["value"] < 1e-4


def test_an_altered_code_fails_the_check(monkeypatch):
    """One code0 of every row, mid-paragraph, moved to another id."""
    from whisperkit_tpu_torch.decoding import tts_loop

    sample, calls = tts_loop.sample_topk, []

    def altered(logits, *args, **kwargs):
        code = sample(logits, *args, **kwargs)
        calls.append(1)
        return (code + 7) % 2048 if len(calls) % 12 == 6 else code

    monkeypatch.setattr(tts_loop, "sample_topk", altered)
    out = run(tiny_cell())
    assert not out["correct"], out["checks"]
    assert out["checks"]["gap_max"]["value"] > check.TIE or out["checks"]["unmatched"]["value"] > 0


def test_rows_swapped_fail_the_check():
    undo = system.FAULTS["rows_mixed"]()
    try:
        out = run(tiny_cell())
    finally:
        undo()
    assert not out["correct"] and out["checks"]["unmatched"]["value"] > 0, out["checks"]
    assert out["checks"]["wave_err"]["value"] > 1.0
