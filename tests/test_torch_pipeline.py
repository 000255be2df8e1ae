"""The PyTorch port's `WhisperPipeline` against the JAX pipeline, on the CPU.

Both pipelines get the same random float32 weights (the JAX `init_params`
tree carried across with `params_from_numpy`) and the same audio, and must
give the same tokens and segments on the VAD path, the single-window seek
path, the long seek path and the batch API. Greedy decoding only, with the
fallback ladder off: JAX keys and torch generators draw different numbers.
"""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperkit_tpu.core import configurations as jconf
from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.ops import quant as jquant
from whisperkit_tpu.pipelines.whisper import WhisperPipeline as JaxPipeline
from whisperkit_tpu_torch.core.configurations import ComputeOptions, DecodingOptions, WhisperConfig
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.ops.mel import log_mel_spectrogram
from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
from whisperkit_tpu_torch.tools.workload import synth_speechlike_audio
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

REPO = Path(__file__).resolve().parent.parent
DIMS = model.WhisperDims(80, 207, 1500, 64, 4, 2, 64, 64, 4, 2)
JDIMS = jmodel.WhisperDims(*dataclasses.astuple(DIMS))

# greedy only, quality ladder off (as tools/workload.pipeline_options), short budget
GREEDY = dict(
    language="en", sample_length=10, temperature_fallback_count=0,
    logprob_threshold=None, compression_ratio_threshold=None,
    no_speech_threshold=None, first_token_log_prob_threshold=None,
)


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(jax.random.PRNGKey(0), JDIMS, dtype=jnp.float32)


def _options(**kwargs):
    """The same decode options as the port's type and as the JAX package's."""
    return DecodingOptions(**kwargs), jconf.DecodingOptions(**kwargs)


def _pipes(jparams, **compute):
    jax_pipe = JaxPipeline(
        jconf.WhisperConfig(compute_options=jconf.ComputeOptions(dp_size=1, **compute), load=False),
        dims=JDIMS, params=jparams,
    )
    tparams = model.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    torch_pipe = WhisperPipeline(
        WhisperConfig(compute_options=ComputeOptions(**compute), load=False),
        dims=DIMS, params=tparams, device="cpu",
    )
    return jax_pipe, torch_pipe


@pytest.fixture(scope="module")
def pipes(jparams):
    return _pipes(jparams)


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)


def _speechlike(seconds):
    """Noise bursts between pauses, so the VAD finds several chunks."""
    return synth_speechlike_audio(seconds, seed=1)


def _assert_same_result(ours, ref, logprob_tol=1e-4, no_speech_tol=1e-5):
    assert ours.language == ref.language
    assert ours.text == ref.text
    assert len(ours.segments) == len(ref.segments) > 0
    for a, b in zip(ours.segments, ref.segments):
        assert a.tokens == b.tokens
        assert (a.id, a.seek, a.text, a.language) == (b.id, b.seek, b.text, b.language)
        assert a.start == pytest.approx(b.start, abs=1e-6)
        assert a.end == pytest.approx(b.end, abs=1e-6)
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=logprob_tol)
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=no_speech_tol)


@pytest.mark.parametrize(
    "case",
    [
        ("vad", 65.0, "vad"),  # VAD chunks, length-sorted groups, tail bucket
        ("seek_short", 5.0, None),  # one window
        ("seek_long", 40.0, None),  # seek loop over the whole-file mel
    ],
    ids=lambda c: c[0],
)
def test_transcribe_matches_jax(pipes, case):
    _, seconds, chunking = case
    jax_pipe, torch_pipe = pipes
    audio = _speechlike(seconds) if chunking else _audio(seconds, 7)
    options, joptions = _options(chunking_strategy=chunking, concurrent_worker_count=2, **GREEDY)
    seen = []
    ours = torch_pipe.transcribe(audio, options, callback=lambda p: seen.append(p.window_id))
    ref = jax_pipe.transcribe(audio, joptions)
    _assert_same_result(ours, ref)
    assert seen and ours.timings.full_pipeline > 0
    assert ours.timings.input_audio_seconds == pytest.approx(seconds)


def test_vad_path_groups_and_tail_bucket(pipes):
    """65 s of speech-like audio at groups of 2: every chunk decodes once,
    and the chunk count is what the JAX pipeline chunks."""
    jax_pipe, torch_pipe = pipes
    audio = _speechlike(65.0)
    options = DecodingOptions(chunking_strategy="vad", concurrent_worker_count=2, **GREEDY)
    chunks = torch_pipe._vad_chunks(audio, options)
    assert len(chunks) >= 3
    res = torch_pipe.transcribe(audio, options)
    assert res.timings.total_decoding_windows == len(chunks)
    assert res.timings.total_encoding_runs == len(chunks)


@pytest.mark.parametrize("workers", [4, 8])
def test_vad_pad_window_shares_the_chunks_mel_launch(pipes, monkeypatch, workers):
    """A partial last group pads its rows with the mel of a zero window,
    computed in the same mel batch as the chunks (one kernel launch for up
    to MEL_BATCH windows), not in a launch of its own; it equals the mel of
    a zero window computed alone."""
    _, torch_pipe = pipes
    audio = _speechlike(65.0)
    options = DecodingOptions(chunking_strategy="vad", concurrent_worker_count=workers, **GREEDY)
    n = len(torch_pipe._vad_chunks(audio, options))
    group = min(workers, 1 << math.ceil(math.log2(n)))
    n_last = n % group or group
    assert n_last & (n_last - 1), f"{n} chunks in groups of {group} leave no partial group to pad"
    batches, pads = [], []
    mel_batch, encode = torch_pipe._mel_batch, torch_pipe._encode
    monkeypatch.setattr(torch_pipe, "_mel_batch", lambda w: (batches.append(len(w)), mel_batch(w))[1])
    monkeypatch.setattr(torch_pipe, "_mel", lambda *a: pytest.fail("the pad window took a mel call of its own"))
    monkeypatch.setattr(torch_pipe, "_encode", lambda mel, o: (pads.append(mel[n_last:]), encode(mel, o))[1])
    res = torch_pipe.transcribe(audio, options)
    assert batches == [n + 1]
    assert res.timings.total_log_mel_runs == n
    alone = log_mel_spectrogram(torch.zeros(480_000), n_mels=DIMS.n_mels)
    torch.testing.assert_close(pads[-1], alone[None].expand_as(pads[-1]), rtol=0, atol=0)


def test_serving_preset_int8_cross_kv_matches_jax(jparams):
    """ComputeOptions.serving(): the int8 cross-KV through the int8
    cross-attention (plain version here) gives JAX's tokens and segments."""
    jax_pipe, torch_pipe = _pipes(jparams, quantize_cross_kv=True)
    audio = _speechlike(65.0)
    options, joptions = _options(chunking_strategy="vad", concurrent_worker_count=4, **GREEDY)
    _assert_same_result(torch_pipe.transcribe(audio, options), jax_pipe.transcribe(audio, joptions))


@pytest.mark.parametrize(
    "compute",
    [  # ComputeOptions.serving(**...) less the serving preset's quantize_cross_kv
        dict(quantization="w8a16", quantize_self_kv=True),
        dict(quantization="w4a16"),
        dict(quantization="w8a8"),
    ],
    ids=["w8a16_int8_self_kv", "w4a16", "w8a8"],
)
def test_quantized_serving_matches_jax(jparams, compute):
    """The int8 side of ComputeOptions on the VAD path: JAX's quantized tree
    (`quantize_whisper_params`, taken by both pipelines as the JAX one takes
    it) under the serving preset with W8A16 weights and the int8 self-KV
    cache (K5's plain version), with W4A16 weights, and with W8A8 (int8
    encoder activations) gives JAX's tokens and segments. W8A8's encoder
    output carries the row-quantization flips that
    test_torch_quant.test_encoder_forward_act8_matches_jax bounds (up to
    ~1% of single entries), so its log-probabilities agree to 2e-3 and its
    no-speech probabilities to 1e-4 instead of 1e-4 and 1e-5."""
    bits = 4 if compute["quantization"] == "w4a16" else 8
    jq = jquant.quantize_whisper_params(jparams, min_size=1, bits=bits)
    jax_pipe, torch_pipe = _pipes(jq, quantize_cross_kv=True, **compute)
    assert torch_pipe._act8 == (compute["quantization"] == "w8a8")
    audio = _speechlike(65.0)
    options, joptions = _options(chunking_strategy="vad", concurrent_worker_count=4, **GREEDY)
    tols = dict(logprob_tol=2e-3, no_speech_tol=1e-4) if torch_pipe._act8 else {}
    _assert_same_result(torch_pipe.transcribe(audio, options), jax_pipe.transcribe(audio, joptions), **tols)


def test_batch_api_matches_jax(pipes):
    jax_pipe, torch_pipe = pipes
    items = [_audio(5.0, 1), "/nonexistent/file.wav", _audio(3.0, 2)]
    options, joptions = _options(**GREEDY)
    ours = torch_pipe.transcribe(items, options)
    ref = jax_pipe.transcribe(items, joptions)
    assert isinstance(ours[1], Exception) and isinstance(ref[1], Exception)
    for i in (0, 2):
        _assert_same_result(ours[i], ref[i])


def test_language_detection_matches_jax(pipes):
    jax_pipe, torch_pipe = pipes
    audio = _audio(5.0, 3)
    lang, probs = torch_pipe.detect_language(audio)
    jlang, jprobs = jax_pipe.detect_language(audio)
    assert lang == jlang
    assert probs.keys() == jprobs.keys()
    for k in probs:
        assert probs[k] == pytest.approx(jprobs[k], abs=1e-5)
    options, joptions = _options(**{**GREEDY, "language": None})
    _assert_same_result(torch_pipe.transcribe(audio, options), jax_pipe.transcribe(audio, joptions))


@pytest.mark.parametrize(
    "kwargs, decode",
    [  # these once raised NotImplementedError; every one now runs on a mesh
        ({"compute_options": ComputeOptions(dp_size=2)}, {"beam_size": 2}),
        ({"compute_options": ComputeOptions(tp_size=2)}, {"word_timestamps": True}),
        ({"compute_options": ComputeOptions(dcn_size=2, segmented_decode=True)}, {}),
        ({"compute_options": ComputeOptions(dp_size=2)}, {}),
        ({"compute_options": ComputeOptions(dp_size=4), "draft_dims": DIMS}, {}),
        # sampled: each cell's rows draw the noise one device draws for them
        ({"compute_options": ComputeOptions(dp_size=2, segmented_decode=True)}, {"temperature": 0.8}),
    ],
)
def test_options_outside_the_slice_raise(jparams, kwargs, decode):
    """More than one device, and each decoding option with it (the name is
    the test's from when these configurations raised): the pipeline on
    four CPU replicas equals the same pipeline on one device, on the VAD
    path (which runs over the mesh) and on a short clip (which runs on the
    first device: with a draft model, speculatively)."""
    tparams = model.init_params(0, DIMS, torch.float32, "cpu")
    compute = kwargs.pop("compute_options", ComputeOptions())
    single = dataclasses.replace(compute, dp_size=1, tp_size=1, dcn_size=1)
    if "draft_dims" in kwargs:
        kwargs["draft_params"] = model.init_params(1, DIMS, torch.float32, "cpu")
    heads = np.array([[0, 1], [1, 3]])
    options = DecodingOptions(**GREEDY, **decode, chunking_strategy="vad", concurrent_worker_count=4)
    runs = []
    for co, devices in ((compute, ["cpu"] * 4), (single, "cpu")):
        pipe = WhisperPipeline(WhisperConfig(compute_options=co, load=False), dims=DIMS, params=tparams,
                               device=devices, alignment_heads=heads, **kwargs)
        runs.append([pipe.transcribe(a, options) for a in (_speechlike(65.0), _audio(1.0, 0))])
        plan = pipe._mesh()
        assert (plan.n_cells * plan.tp > 1) == (devices != "cpu")
    for ours, ref in zip(*runs):
        # a cell decodes its rows at another batch size: float32 sums differ in the last bits
        _assert_same_result(ours, ref)
        if decode.get("word_timestamps"):
            words = [[(w.word, w.start, w.end) for w in s.words] for s in ours.segments]
            assert words == [[(w.word, w.start, w.end) for w in s.words] for s in ref.segments]
            assert any(words)


def test_early_stop_flag_and_checkpoint_loading_raise():
    """An early-stop flag is taken (tests/test_torch_segmented.py holds it
    against JAX); loading a checkpoint is ported, so a folder that does not
    exist raises ModelsUnavailable, as the JAX pipeline does, and no longer
    NotImplementedError."""
    from whisperkit_tpu_torch.core.concurrency import EarlyStopFlag
    from whisperkit_tpu_torch.core.errors import ModelsUnavailable

    tparams = model.init_params(0, DIMS, torch.float32, "cpu")
    pipe = WhisperPipeline(WhisperConfig(load=False), dims=DIMS, params=tparams, device="cpu")
    assert pipe.early_stop_flag is None
    flag = EarlyStopFlag()
    pipe.early_stop_flag = flag
    assert pipe.early_stop_flag is flag
    pipe.early_stop_flag = None
    with pytest.raises(ModelsUnavailable, match="does not exist"):
        WhisperPipeline(WhisperConfig(model_folder=str(REPO / "no-such-model")), device="cpu")
    with pytest.raises(Exception, match="does not exist") as ref:
        JaxPipeline(jconf.WhisperConfig(model_folder=str(REPO / "no-such-model")))
    assert type(ref.value).__name__ == "ModelsUnavailable"


def test_tiny_checkpoint_loads_and_transcribes_as_jax(jparams, tmp_path):
    """The JAX tree written as an HF folder loads in both pipelines (as
    float32, via load_whisper) to the same tensors, heads and tokens; the
    pipeline's own load_models (bf16) takes the same folder, with its BPE
    tokenizer, and prewarms."""
    from whisperkit_tpu.models import loader as jloader
    from whisperkit_tpu_torch.models import loader
    from whisperkit_tpu_torch.tools.checkpoint import write_hf_checkpoint, write_synthetic_tokenizer

    tparams = model.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    write_hf_checkpoint(tmp_path, DIMS, tparams, alignment_heads=[[1, 0], [0, 3]])
    write_synthetic_tokenizer(tmp_path, DIMS.n_vocab)
    dims, params, heads = loader.load_whisper(tmp_path, dtype=torch.float32, device="cpu")
    jdims, jp, jheads = jloader.load_whisper(tmp_path, dtype=jnp.float32)
    assert dims == DIMS and heads.tolist() == jheads.tolist() == [[1, 0], [0, 3]]
    ours = jax.tree.leaves(model.params_to_numpy(params))
    ref = jax.tree.leaves(jax.tree.map(np.asarray, jp))
    assert len(ours) == len(ref) and all(np.array_equal(a, b) for a, b in zip(ours, ref))
    jax_pipe = JaxPipeline(jconf.WhisperConfig(compute_options=jconf.ComputeOptions(dp_size=1), load=False),
                           dims=JDIMS, params=jp)
    torch_pipe = WhisperPipeline(WhisperConfig(load=False), dims=dims, params=params, device="cpu")
    audio = _audio(4.0, 11)
    options, joptions = _options(**GREEDY)
    _assert_same_result(torch_pipe.transcribe(audio, options), jax_pipe.transcribe(audio, joptions))

    loaded = WhisperPipeline(WhisperConfig(model_folder=str(tmp_path), prewarm=True), device="cpu")
    assert type(loaded.tokenizer).__name__ == "WhisperTokenizer"
    assert loaded.params["decoder"]["token_embed"].dtype == torch.bfloat16
    assert loaded.alignment_heads.tolist() == [[1, 0], [0, 3]]
    assert loaded.timings.encoder_specialization_time > 0 and str(loaded.model_state) == "loaded"
    assert loaded.transcribe(audio, options).segments is not None


@pytest.mark.parametrize("flag", [False, True], ids=["flag_off", "int16_forced"])
def test_int16_audio_transfer_matches_jax(jparams, flag):
    """ComputeOptions.int16_audio_transfer: off-grid audio (synth_speechlike,
    which lies on the int16 grid, scaled by 0.9) rounds to the grid before
    the mel in both pipelines, on the VAD path and the long seek path, and
    the tokens are JAX's; without the flag both upload float32."""
    jax_pipe, torch_pipe = _pipes(jparams, int16_audio_transfer=flag)

    def off_grid(seconds):
        audio = _speechlike(seconds) * np.float32(0.9)
        assert not np.array_equal(np.rint(audio * 32768.0), audio * 32768.0)
        return audio

    for seconds, chunking in ((65.0, "vad"), (40.0, None)):
        audio = off_grid(seconds)
        options, joptions = _options(chunking_strategy=chunking, concurrent_worker_count=4, **GREEDY)
        _assert_same_result(torch_pipe.transcribe(audio, options), jax_pipe.transcribe(audio, joptions))
    # one window: the port rounds here too (JAX's `_mel` uploads float32),
    # so its tokens are JAX's on the audio rounded beforehand
    audio = off_grid(8.0)
    rounded = (np.clip(np.rint(audio * 32768.0), -32768, 32767) / 32768.0).astype(np.float32)
    options, joptions = _options(**GREEDY)
    _assert_same_result(torch_pipe.transcribe(audio, options),
                        jax_pipe.transcribe(rounded if flag else audio, joptions))


def test_int16_audio_upload(jparams):
    """Audio on the int16 grid uploads as int16 with the flag on or off and
    gives bit-equal mels and tokens; off-grid audio with the flag rounds
    (np.rint), clips to [-32768, 32767] and maps NaN to 0, never leaving an
    uninitialised value; without the flag it uploads as float32."""
    _, plain = _pipes(jparams)
    _, forced = _pipes(jparams, int16_audio_transfer=True)
    on_grid = (np.round(_speechlike(65.0) * 32768.0).clip(-32768, 32767) / 32768.0).astype(np.float32)
    for pipe in (plain, forced):
        up = pipe._upload_audio(on_grid[None])
        assert torch.equal(up, torch.from_numpy(on_grid[None]))
    options, _ = _options(chunking_strategy="vad", concurrent_worker_count=4, **GREEDY)
    a, b = plain.transcribe(on_grid, options), forced.transcribe(on_grid, options)
    assert [s.tokens for s in a.segments] == [s.tokens for s in b.segments] and a.segments
    torch.testing.assert_close(plain._mel_batch([on_grid[:480_000]]), forced._mel_batch([on_grid[:480_000]]),
                               rtol=0, atol=0)

    odd = np.array([0.1, -0.25, 1.5, -1.5, np.nan, 3e-5, -np.inf, np.inf, 1 / 65536], np.float32)
    up = forced._upload_audio(odd.copy())
    expect = np.clip(np.nan_to_num(np.rint(odd * 32768.0), nan=0.0), -32768, 32767) / 32768.0
    np.testing.assert_array_equal(up.numpy(), expect.astype(np.float32))
    assert torch.isfinite(up).all() and up[4] == 0
    assert torch.equal(plain._upload_audio(odd[:4].copy()), torch.from_numpy(odd[:4]))
    # NaN audio runs through the whole pipeline without an error
    nan_audio = _speechlike(5.0)
    nan_audio[1000:2000] = np.nan
    res = forced.transcribe(nan_audio, DecodingOptions(chunking_strategy="vad", **GREEDY))
    assert all(np.isfinite(s.avg_logprob) for s in res.segments)


def test_cuda_pipeline_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tparams = model.init_params(0, DIMS, torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WhisperPipeline(WhisperConfig(load=False), dims=DIMS, params=tparams, device="cuda")


def test_pipeline_needs_an_explicit_device(monkeypatch):
    """`device` defaults to "cuda": with no card, a pipeline built without
    one raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tparams = model.init_params(0, DIMS, torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WhisperPipeline(WhisperConfig(load=False), dims=DIMS, params=tparams)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import whisperkit_tpu_torch.pipelines.whisper\n"
        "import whisperkit_tpu_torch.ops.attention, whisperkit_tpu_torch.ops.attention_decode\n"
        "import whisperkit_tpu_torch.ops.mel, whisperkit_tpu_torch.ops.quant\n"
        "import whisperkit_tpu_torch.tools.profile_step\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_profile_step_busy_time_is_the_union_of_intervals():
    from whisperkit_tpu_torch.tools.profile_step import _busy_us

    assert _busy_us([]) == 0.0
    # overlapping, nested, touching and disjoint intervals, unsorted
    assert _busy_us([(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (1.5, 1.8), (3.0, 4.0)]) == 6.0


def test_profile_step_reports_k5_per_position_in_launch_order():
    """`_k5_by_position` takes the trace's K5 launches in time order, one
    per layer a step, step j at the mask position first_pos + j, and sets
    each beside its bound: the visible keys' codes and scales of K and V,
    the query, its scale, the output and the mask row over 3.35 TB/s."""
    from types import SimpleNamespace

    from whisperkit_tpu_torch.tools.profile_step import _k5_by_position

    def activity(name, start, us):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=start + us))

    # two steps of three layers, listed out of order, and another kernel between
    device = [activity("self_attend_q8_kernel", 100.0 + 10 * i, 4.0 if i < 3 else 6.0) for i in (5, 0, 3, 1, 4, 2)]
    device.append(activity("cross_attend_q8_kernel<false>", 101.0, 50.0))
    out = _k5_by_position(device, steps=2, first_pos=9, cache_len=16, rows=2)
    assert out["k5_launches_per_step"] == 3
    (p0, us0, b0, r0), (p1, us1, b1, r1) = out["k5_by_position"]
    assert (p0, us0, p1, us1) == (9, 4.0, 10, 6.0)
    assert b0 == pytest.approx((2 * 2 * 10 * 68 + 2 * (64 + 4 + 256) + 16 * 4) / 3.35e12 * 1e6)
    assert b1 == pytest.approx((2 * 2 * 11 * 68 + 2 * (64 + 4 + 256) + 16 * 4) / 3.35e12 * 1e6)
    assert (r0, r1) == (pytest.approx(b0 / 4.0), pytest.approx(b1 / 6.0))
    assert out["k5_share"] == pytest.approx((b0 + b1) / 10.0)
