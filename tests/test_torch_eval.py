"""The port's evaluation modules (whisperkit_tpu_torch/eval/) against the
JAX package's, on the CPU.

The normalizers, `wer`, `align_words` and `evaluate` are copies and must
give JAX's answers exactly on tests/test_eval.py's strings. The
quantization harness's per-scheme teacher-forced logits hold JAX's on a
tiny model (2 layers, width 64, the port's random init carried across as
numpy) at tests/test_torch_quant.py's tolerances, and its scoring holds
JAX's on fixed transcripts. The load generator's completion stamping and
staggered arrivals are held as tests/test_loadgen.py holds JAX's, then
over the port's BatchScheduler. The regression harness runs over a folder
with `.txt` and metadata-JSON transcripts, its fault injection, its
dataset resolution with a stand-in `huggingface_hub`, and its `main` on a
written checkpoint folder.
"""

import concurrent.futures
import dataclasses
import json
import queue
import sys
import threading
import time
import types
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from whisperkit_tpu.eval import loadgen as jloadgen
from whisperkit_tpu.eval import normalize as jnormalize
from whisperkit_tpu.eval import quant_delta as jquant_delta
from whisperkit_tpu.eval import wer as jwer
from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.ops import quant as jquant
from whisperkit_tpu_torch.core.configurations import DecodingOptions, WhisperConfig
from whisperkit_tpu_torch.eval import loadgen, normalize, quant_delta, regression, wer
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.ops import quant
from whisperkit_tpu_torch.pipelines.scheduler import BatchScheduler
from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
from whisperkit_tpu_torch.tools import checkpoint

DIMS = model.WhisperDims(80, 207, 1500, 64, 4, 2, 64, 64, 4, 2)
JDIMS = jmodel.WhisperDims(*dataclasses.astuple(DIMS))

# tests/test_eval.py's strings, and the differential sentences it holds
# against transformers' normalizer
STRINGS = [
    "Hello, World! [applause]", "A (quiet) test...", "I won't go", "it's Mr. Smith's dog",
    "they're gonna leave", "the colour of honour", "twenty two", "one hundred and five",
    "three thousand two hundred", "two million", "one day", "the armoured vapour",
    "they customised the fibres", "she quarrelled", "a genre of four hour tours", "please rise and advise",
    "hello… this is a test over GH₵ 94 million in fees in Hørsholm and Basel grew 10% to one billions, "
    "370 millions",
    "aluminium aeroplane", "the manoeuvre was marvellous", "one point five", "two point five", "twenty first",
    "a hundred and first", "minus twenty", "fifty percent", "fifty per cent", "three dollars",
    "double oh seven", "nineteen sixty four", "one oh one", "sevens", "two millionth",
    "three euros and five cents", "two dollars and seventy five cents", "two and a half hours",
    "Mr. Smith paid $1,250.50 for twenty-one colour TVs", "He came in second place with thirty five percent",
    "It cost one hundred and five dollars and fifty cents", "two and a half hours later, minus three degrees",
    "the one oh one freeway at nineteen sixty four", "double seven triple three, um, that's my number",
    "I organised the programme at the theatre in Hørsholm", "she'll've... they'd been gone by 10.30am",
    "fifty per cent of £3.50 plus seven euros", "The 1st, 2nd, 3rd and 100th runners finished",
    "o o seven said zero zero seven", "a million and one things to do", "I won't let's can't ain't y'all wanna",
]
PAIRS = [
    ("hello world", "Hello, world!"),
    ("the cat sat on the mat", "the cat sit on mat"),
    ("", "something"),
    ("", ""),
    ("the colour of twenty two honours", "the color of 22 honors and more"),
    ("I won't go there today", "i will not go their to day"),
]


# ---------------------------------------------------------------------------
# normalizers and WER (copies)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["BasicTextNormalizer", "EnglishNumberNormalizer", "EnglishTextNormalizer"])
def test_normalizers_match_jax(name):
    ours, ref = getattr(normalize, name)(), getattr(jnormalize, name)()
    for s in STRINGS:
        assert ours(s) == ref(s), s


@pytest.mark.parametrize("ref_text, hyp_text", PAIRS)
def test_wer_align_and_evaluate_match_jax(ref_text, hyp_text):
    assert wer.wer(ref_text, hyp_text) == jwer.wer(ref_text, hyp_text)
    assert dataclasses.asdict(wer.evaluate(ref_text, hyp_text)) == dataclasses.asdict(
        jwer.evaluate(ref_text, hyp_text))
    r, h = ref_text.split(), hyp_text.split()
    assert [dataclasses.astuple(c) for c in wer.align_words(r, h)] == [
        dataclasses.astuple(c) for c in jwer.align_words(r, h)]


# ---------------------------------------------------------------------------
# the quantization harness
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tparams():
    return model.init_params(0, DIMS, torch.float32, "cpu")


@pytest.fixture(scope="module")
def jparams(tparams):
    return jax.tree.map(jnp.asarray, model.params_to_numpy(tparams))


@pytest.mark.parametrize("scheme", ["bf16", *quant_delta.DEFAULT_SCHEMES])
def test_scheme_logits_match_jax(tparams, jparams, scheme):
    """`_scheme_logits` of each scheme (every linear quantized, min_size 1)
    on one teacher sequence: within 1e-4 of JAX's, as the quantized
    encoder of tests/test_torch_quant.py. W8A8's row-quantized activations
    may land across a rounding boundary where float32 summation order
    differs, so it is held by that file's act8 bound (0.05) and must lie
    nearer JAX's W8A8 logits than JAX's W8A16 ones (a skipped or broken A8
    path lies within ~3e-4 of W8A16's)."""
    bits, overrides = (None, {}) if scheme == "bf16" else quant_delta.DEFAULT_SCHEMES[scheme]
    jtree, tree = jparams, tparams
    if bits is not None:
        jtree = jquant.quantize_whisper_params(jparams, min_size=1, bits=bits)
        tree = quant.quantize_whisper_params(tparams, min_size=1, bits=bits)
    mel = np.random.default_rng(0).standard_normal((1, 80, 3000)).astype(np.float32)
    seq = [203, 1, 5, 9, 17, 40, 3, 99]
    ref = jquant_delta._scheme_logits(JDIMS, jtree, jnp.asarray(mel), seq, overrides)
    out = quant_delta._scheme_logits(DIMS, tree, torch.from_numpy(mel), seq, overrides)
    assert out.shape == ref.shape == (len(seq), DIMS.n_vocab) and out.dtype == np.float32
    if overrides.get("quantization") != "w8a8":
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
        return
    assert np.abs(out - ref).max() < 0.05
    ref_w8a16 = jquant_delta._scheme_logits(JDIMS, jtree, jnp.asarray(mel), seq, {"quantize_cross_kv": True})
    assert np.linalg.norm(out - ref) < np.linalg.norm(out - ref_w8a16)


def test_teacher_forced_divergence_matches_jax(tparams, jparams):
    """The whole teacher-forced harness on 3 s of audio, 8 tokens, float32:
    the same steps, flips and margins as JAX's (margins and logit deltas
    to float32 summation order)."""
    audio = (np.random.default_rng(3).standard_normal(48000) * 0.1).astype(np.float32)
    schemes = {k: quant_delta.DEFAULT_SCHEMES[k] for k in ("serving_int8_cross_kv", "int8_self_kv")}
    ours = quant_delta.teacher_forced_divergence(DIMS, tparams, audio, schemes=schemes, max_tokens=8,
                                                 device="cpu")
    ref = jquant_delta.teacher_forced_divergence(JDIMS, jparams, audio, schemes=schemes, max_tokens=8)
    assert [r.scheme for r in ours] == [r.scheme for r in ref] == list(schemes)
    for a, b in zip(ours, ref):
        assert (a.n_steps, a.n_flips, a.tf_agreement) == (b.n_steps, b.n_flips, b.tf_agreement)
        assert a.margin_bf16_median == pytest.approx(b.margin_bf16_median, abs=2e-4)
        assert a.mean_abs_logit_delta == pytest.approx(b.mean_abs_logit_delta, abs=2e-4)


class _FixedPipeline:
    """Stands in for a WhisperPipeline in quant_divergence: each compute
    configuration transcribes to fixed texts and tokens."""

    OUT = {
        (): [("the cat sat on the mat", [1, 2, 3, 4, 5, 6]), ("hello world", [7, 8])],
        (("quantize_cross_kv", True),): [("the cat sat on the mat", [1, 2, 3, 4, 5, 6]),
                                          ("hello world", [7, 8])],
        (("quantize_self_kv", True),): [("the cat sit on mat", [1, 2, 9, 4, 6]), ("hello world", [7, 8])],
        (("quantization", "w8a16"), ("quantize_cross_kv", True)): [
            ("the cat sat on the mat today", [1, 2, 3, 4, 5, 6, 10, 11]), ("hello", [7])],
        (("quantization", "w8a8"), ("quantize_cross_kv", True)): [("", []), ("hello world", [8, 7])],
        (("quantization", "w4a16"), ("quantize_cross_kv", True)): [("a dog", [12]), ("", [])],
    }

    def __init__(self, config=None, **kwargs):
        co = config.compute_options
        key = tuple(sorted((k, v) for k, v in (("quantize_cross_kv", co.quantize_cross_kv),
                                               ("quantize_self_kv", co.quantize_self_kv),
                                               ("quantization", co.quantization)) if v))
        self.out = iter(self.OUT[key])

    def transcribe(self, audio, options):
        text, tokens = next(self.out)
        seg = types.SimpleNamespace(tokens=tokens)
        return types.SimpleNamespace(text=text, segments=[seg])


def test_quant_divergence_arithmetic_matches_jax(monkeypatch):
    """Both packages' quant_divergence over the same fixed transcripts per
    scheme (pipelines and quantizers stood in for): the same WER, token
    edit distance and identity flags, field for field."""
    import whisperkit_tpu.pipelines.whisper as jpipeline
    import whisperkit_tpu_torch.pipelines.whisper as tpipeline

    for mod in (jpipeline, tpipeline):
        monkeypatch.setattr(mod, "WhisperPipeline", _FixedPipeline)
    monkeypatch.setattr(jquant, "quantize_whisper_params", lambda p, bits: p)
    monkeypatch.setattr(quant, "quantize_whisper_params", lambda p, bits: p)
    audio = [np.zeros(16000, np.float32)] * 2
    ours = quant_delta.quant_divergence(DIMS, {}, audio, None, device="cpu")
    ref = jquant_delta.quant_divergence(JDIMS, {}, audio, None)
    assert [dataclasses.asdict(r) for r in ours] == [dataclasses.asdict(r) for r in ref]
    assert ours[0].token_divergence == 0 and ours[0].identical_text
    assert ours[1].n_diverged_tokens == 2 and ours[4].n_diverged_tokens == 8
    for r, h in (([1, 2, 3], [1, 3]), ([], [4, 5]), ([5, 6], [6, 5]), (list(range(30)), list(range(1, 31)))):
        assert quant_delta._token_edit_distance(r, h) == jquant_delta._token_edit_distance(r, h)


def test_quant_divergence_runs_the_pipeline_and_its_control_is_exact(tparams):
    """The port's quant_divergence through its own pipeline on the CPU: a
    control scheme that repeats bf16 gives no divergence; every scheme
    reports the bf16 token count."""
    from whisperkit_tpu_torch.tools.workload import pipeline_options, synth_speechlike_audio

    options = dataclasses.replace(pipeline_options(4), sample_length=6)
    schemes = {"control": (None, {}), "w8a16_int8kv": quant_delta.DEFAULT_SCHEMES["w8a16_int8kv"]}
    out = quant_delta.quant_divergence(DIMS, tparams, [synth_speechlike_audio(4.0)], options, schemes,
                                       device="cpu")
    assert [r.scheme for r in out] == ["control", "w8a16_int8kv"]
    assert out[0].token_divergence == 0 and out[0].wer_vs_bf16 == 0 and out[0].identical_text
    assert out[0].n_ref_tokens == out[1].n_ref_tokens > 0


# ---------------------------------------------------------------------------
# the load generator
# ---------------------------------------------------------------------------


class _StubSched:
    """Minimal BatchScheduler surface for run_load: futures are completed
    externally by the test."""

    def __init__(self):
        self.batches_run = 0
        self.jobs_run = 0
        self.windows_run = 0
        self._queue = queue.Queue()
        self._pending = []
        self.futures: list[concurrent.futures.Future] = []

    def submit(self, clip, options):
        f: concurrent.futures.Future = concurrent.futures.Future()
        self.futures.append(f)
        return f


class _StubPipe:
    timings = None


def test_poisson_gaps_match_jax():
    ours = loadgen.poisson_gaps(np.random.default_rng(0), rate_rps=4.0, n=32)
    assert ours == jloadgen.poisson_gaps(np.random.default_rng(0), rate_rps=4.0, n=32)
    assert all(b > a for a, b in zip(ours, ours[1:]))


def test_latency_stamped_at_completion_not_observation():
    """The second request finishes first, while run_load still waits on
    the first: its latency is its completion's (~0.15 s), not the moment
    the first one's result was read (~0.5 s)."""
    sched = _StubSched()

    def completer():
        while len(sched.futures) < 2:
            time.sleep(0.005)
        time.sleep(0.15)
        sched.futures[1].set_result("b")
        time.sleep(0.35)
        sched.futures[0].set_result("a")

    t = threading.Thread(target=completer, daemon=True)
    t.start()
    out = loadgen.run_load(sched, _StubPipe(), [np.zeros(160), np.zeros(160)], None)
    t.join(timeout=2)
    assert not t.is_alive()
    assert out["p50_s"] < 0.45 and out["p99_s"] >= 0.45 and out["requests"] == 2, out


def test_arrival_gaps_stagger_submissions():
    sched = _StubSched()
    seen_at: list[float] = []
    orig_submit = sched.submit

    def submit(clip, options):
        seen_at.append(time.perf_counter())
        f = orig_submit(clip, options)
        f.set_result("x")
        return f

    sched.submit = submit
    loadgen.run_load(sched, _StubPipe(), [np.zeros(160)] * 3, None, arrival_gaps=[0.0, 0.1, 0.2])
    assert seen_at[1] - seen_at[0] >= 0.08 and seen_at[2] - seen_at[1] >= 0.08


def test_run_load_over_the_port_scheduler(tparams):
    """A burst of three 3 s clips over the port's BatchScheduler: every
    request returns, the three windows share one batch, the counters the
    harness reads (and resets) are the scheduler's, and the depth sampler
    stops."""
    pipe = WhisperPipeline(WhisperConfig(load=False), dims=DIMS, params=tparams, device="cpu")
    sched = BatchScheduler(pipe, max_batch=4, max_wait_ms=200.0)
    sched.batches_run = 7  # run_load counts only its own scenario
    clips = [(np.random.default_rng(s).standard_normal(48000) * 0.1).astype(np.float32) for s in range(3)]
    try:
        out = loadgen.run_load(sched, pipe, clips, DecodingOptions(sample_length=4, language="en"),
                               sample_queue_depth=True, depth_interval_s=0.01, timeout=300)
    finally:
        sched.shutdown()
    assert out["requests"] == 3 and out["audio_seconds"] == 9.0
    assert out["batches"] == 1 and out["mean_batch_fill"] == 3.0
    assert out["agg_tokens_per_s"] > 0 and out["p50_s"] <= out["p99_s"] <= out["wall_s"] + 0.01
    assert "queue_depth_max" in out


# ---------------------------------------------------------------------------
# the regression harness
# ---------------------------------------------------------------------------


def _write_wav(path, samples, rate=16000):
    pcm = (np.clip(samples, -1, 1) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def test_run_regression_txt_and_metadata_transcripts(tparams, tmp_path):
    """Two WAVs, one with a sibling .txt, one named in a metadata .json
    (RegressionTests.swift:485-510), one with neither: a record per file,
    WER from the port's evaluate against the transcript it found, and the
    JSON-lines file."""
    pipe = WhisperPipeline(WhisperConfig(load=False), dims=DIMS, params=tparams, device="cpu")
    rng = np.random.default_rng(1)
    for name in ("a", "b", "c"):
        _write_wav(tmp_path / f"{name}.wav", rng.standard_normal(16000 * 2) * 0.1)
    (tmp_path / "a.txt").write_text("some reference transcript")
    (tmp_path / "metadata.json").write_text(json.dumps([{"audio": "b.wav", "text": "ground truth words"}]))
    out = tmp_path / "stats.jsonl"
    stats = regression.run_regression(pipe, tmp_path, model_name="tiny-random",
                                      options=DecodingOptions(sample_length=6, language="en"), out_path=out)
    assert [s.file for s in stats] == ["a.wav", "b.wav", "c.wav"]
    texts = [pipe.transcribe(tmp_path / f"{n}.wav", DecodingOptions(sample_length=6, language="en")).text
             for n in ("a", "b")]
    assert stats[0].wer == wer.evaluate("some reference transcript", texts[0]).wer
    assert stats[1].wer == wer.evaluate("ground truth words", texts[1]).wer
    assert stats[2].wer is None
    assert stats[0].input_audio_seconds == pytest.approx(2.0, abs=0.1) and stats[0].windows >= 1
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines == [dataclasses.asdict(s) for s in stats]


def test_regression_fault_injection_and_dataset_resolution(tmp_path, monkeypatch):
    with pytest.raises(regression.CrashTestError):
        regression.run_regression(None, tmp_path, model_name="crash_test")
    with pytest.raises(ValueError):
        regression.run_regression(None, tmp_path, model_name="unknown_model")
    assert regression.resolve_dataset(tmp_path) == tmp_path
    # no huggingface_hub (the card's machine has none): the same error
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(FileNotFoundError, match="librispeech-10mins"):
        regression.resolve_dataset("librispeech-10mins")
    # a stand-in hub: a cache miss, then the dataset from the "network"
    calls = []

    def snapshot_download(repo, repo_type, allow_patterns, local_files_only):
        calls.append((repo, repo_type, allow_patterns, local_files_only))
        if local_files_only:
            raise OSError("not cached")
        (tmp_path / "hub" / "earnings22-10mins").mkdir(parents=True)
        return str(tmp_path / "hub")

    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(snapshot_download=snapshot_download))
    assert regression.resolve_dataset("earnings22-10mins") == tmp_path / "hub" / "earnings22-10mins"
    assert calls == [(regression.DATASET_REPO, "dataset", ["earnings22-10mins/*"], True),
                     (regression.DATASET_REPO, "dataset", ["earnings22-10mins/*"], False)]


def test_regression_main_on_a_checkpoint_folder(tparams, tmp_path, capsys):
    """`python -m whisperkit_tpu_torch.eval.regression <folder> <dataset>
    --device cpu`: a written checkpoint folder and a dataset of two WAVs
    with transcripts; one record per file, the summary line."""
    folder = tmp_path / "model"
    dims = dataclasses.replace(DIMS, n_text_ctx=448)  # room for the default 224-token budget
    checkpoint.write_hf_checkpoint(folder, dims, model.init_params(1, dims, torch.float32, "cpu"))
    data = tmp_path / "data"
    data.mkdir()
    for i in range(2):
        _write_wav(data / f"{i}.wav", np.random.default_rng(i).standard_normal(16000 * 2) * 0.1)
        (data / f"{i}.txt").write_text("a reference")
    out = tmp_path / "stats.jsonl"
    assert regression.main([str(folder), str(data), "--out", str(out), "--device", "cpu", "--max-files", "2",
                            "--language", "en", "--chunking", "none"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    records = [json.loads(x) for x in out.read_text().splitlines()]
    assert summary["files"] == len(records) == 2 and summary["avg_wer"] is not None
    assert all(r["model"] == "model" and r["wer"] is not None for r in records)
