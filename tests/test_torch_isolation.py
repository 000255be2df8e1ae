"""The PyTorch port stands alone: it imports nothing of the JAX package,
of `bench.py` or of JAX, and its own copies of the JAX package's
framework-free modules (audio, core, text) behave as the originals do.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bench
from whisperkit_tpu.audio import chunker as jchunker
from whisperkit_tpu.core import concurrency as jconcurrency
from whisperkit_tpu.core import configurations as jconf
from whisperkit_tpu.core import results as jresults
from whisperkit_tpu.core import timings as jtimings
from whisperkit_tpu.text import languages as jlanguages
from whisperkit_tpu.text import segment_seeker as jseeker
from whisperkit_tpu.text import tokenizer as jtok
from whisperkit_tpu.text import utils as jutils
from whisperkit_tpu.text import word_timestamps as jword_timestamps
from whisperkit_tpu_torch.audio import chunker
from whisperkit_tpu_torch.audio import io as audio_io
from whisperkit_tpu_torch.core import concurrency
from whisperkit_tpu_torch.core import configurations as conf
from whisperkit_tpu_torch.core import results
from whisperkit_tpu_torch.core import timings
from whisperkit_tpu_torch.text import languages, segment_seeker, tokenizer, utils, word_timestamps
from whisperkit_tpu_torch.tools import workload
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "whisperkit_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    """The JAX package and JAX, and the packages the card's machine lacks
    that a TTS or Whisper port would reach for first."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "whisperkit_tpu", "bench", "tokenizers", "safetensors", "transformers")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_nothing_of_the_jax_package(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_port_modules_load_without_the_jax_package():
    code = (
        "import sys\n"
        "import whisperkit_tpu_torch.pipelines.whisper\n"
        "import whisperkit_tpu_torch.tools.profile_step, whisperkit_tpu_torch.tools.k2_check\n"
        "import whisperkit_tpu_torch.tools.decode_attn_check, whisperkit_tpu_torch.tools.launch_cost\n"
        "import whisperkit_tpu_torch.decoding.beam, whisperkit_tpu_torch.decoding.speculative\n"
        "import whisperkit_tpu_torch.core.concurrency, whisperkit_tpu_torch.text.word_timestamps\n"
        "import whisperkit_tpu_torch.cli.main, whisperkit_tpu_torch.server.openai_api\n"
        "import whisperkit_tpu_torch.pipelines.scheduler, whisperkit_tpu_torch.models.loader\n"
        "import whisperkit_tpu_torch.pipelines.diarize, whisperkit_tpu_torch.pipelines.streaming\n"
        "import whisperkit_tpu_torch.audio.capture, whisperkit_tpu_torch.speaker.results\n"
        "import whisperkit_tpu_torch.speaker.clustering, whisperkit_tpu_torch.models.pyannet\n"
        "import whisperkit_tpu_torch.models.pyannote, whisperkit_tpu_torch.ops.fbank\n"
        "import whisperkit_tpu_torch.pipelines.tts, whisperkit_tpu_torch.models.qwen3_loader\n"
        "import whisperkit_tpu_torch.decoding.tts_loop, whisperkit_tpu_torch.audio.output\n"
        "import whisperkit_tpu_torch.eval.wer, whisperkit_tpu_torch.eval.normalize, whisperkit_tpu_torch.eval.loadgen\n"
        "import whisperkit_tpu_torch.eval.quant_delta, whisperkit_tpu_torch.eval.regression\n"
        "import whisperkit_tpu_torch.tools.eval_quant_wer, whisperkit_tpu_torch.core.signposts\n"
        "import whisperkit_tpu_torch.core.model_manager, whisperkit_tpu_torch.models.params_npz\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'whisperkit_tpu', 'bench'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# packages the card's machine lacks: the port imports none of them, but for
# the registry's download step and the regression harness's dataset
# resolution, which import huggingface_hub when they run, and the
# microphone source, which imports sounddevice when it is asked for
ABSENT_ON_THE_CARD = ("aiohttp", "safetensors", "transformers", "tokenizers", "pydantic", "orbax",
                      "huggingface_hub", "sounddevice")
LAZY_IMPORTS = {
    ("whisperkit_tpu_torch/core/registry.py", "_download_snapshot", "huggingface_hub"),
    ("whisperkit_tpu_torch/eval/regression.py", "resolve_dataset", "huggingface_hub"),
    ("whisperkit_tpu_torch/audio/capture.py", "capture_available", "sounddevice"),
    ("whisperkit_tpu_torch/audio/capture.py", "list_capture_devices", "sounddevice"),
    ("whisperkit_tpu_torch/audio/capture.py", "__init__", "sounddevice"),
    ("whisperkit_tpu_torch/audio/output.py", "play", "sounddevice"),
    ("whisperkit_tpu_torch/audio/output.py", "play_blocking", "sounddevice"),
}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_package_the_card_lacks(path):
    """No import of those packages anywhere in the port or chip_smoke.py,
    at module level or in a function, but the registry's lazy download."""
    tree = ast.parse(path.read_text(), filename=str(path))
    parents = {child: node for node in ast.walk(tree) for child in ast.iter_child_nodes(node)}
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            if name.split(".")[0] not in ABSENT_ON_THE_CARD:
                continue
            scope = node
            while scope in parents and not isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope = parents[scope]
            func = getattr(scope, "name", None)
            if (str(path.relative_to(REPO)), func, name.split(".")[0]) not in LAZY_IMPORTS:
                bad.append(f"{name} (line {node.lineno}, {'in ' + func if func else 'module level'})")
    assert not bad, f"{path.name} imports {bad}"


def test_entry_points_import_with_those_packages_blocked():
    """With every package of ABSENT_ON_THE_CARD made unimportable, the
    port's entry points and the modules they reach still import."""
    code = (
        "import sys\n"
        f"BLOCKED = {ABSENT_ON_THE_CARD!r}\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        "for m in [m for m in sys.modules if m.split('.')[0] in BLOCKED]:\n"
        "    del sys.modules[m]\n"
        "import whisperkit_tpu_torch.cli, whisperkit_tpu_torch.cli.main, whisperkit_tpu_torch.server.openai_api\n"
        "import whisperkit_tpu_torch.server.schema, whisperkit_tpu_torch.server.client\n"
        "import whisperkit_tpu_torch.pipelines.scheduler, whisperkit_tpu_torch.models.loader\n"
        "import whisperkit_tpu_torch.core.registry, whisperkit_tpu_torch.core.model_support\n"
        "import whisperkit_tpu_torch.core.device_probe, whisperkit_tpu_torch.tools.checkpoint\n"
        "import whisperkit_tpu_torch.text.writers, whisperkit_tpu_torch.text.transcription_utils\n"
        "import whisperkit_tpu_torch.pipelines.diarize, whisperkit_tpu_torch.pipelines.streaming\n"
        "import whisperkit_tpu_torch.pipelines.tts, whisperkit_tpu_torch.models.qwen3_loader\n"
        "import whisperkit_tpu_torch.eval.regression, whisperkit_tpu_torch.eval.quant_delta\n"
        "import whisperkit_tpu_torch.tools.eval_quant_wer, whisperkit_tpu_torch.core.signposts\n"
        "from whisperkit_tpu_torch.eval.regression import resolve_dataset\n"
        "try:\n"
        "    resolve_dataset('librispeech-10mins')\n"
        "except FileNotFoundError as e:\n"
        "    assert 'librispeech-10mins' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('resolved a dataset without huggingface_hub')\n"
        "from whisperkit_tpu_torch.audio.capture import capture_available\n"
        "assert not capture_available()\n"
        "from whisperkit_tpu_torch.cli.main import build_parser\n"
        "build_parser().parse_args(['transcribe', '--audio-path', 'a.wav'])\n"
        "from whisperkit_tpu_torch.core import registry\n"
        "from whisperkit_tpu_torch.core.errors import ModelsUnavailable\n"
        "try:\n"
        "    registry._download_snapshot('openai/whisper-tiny', __import__('pathlib').Path('unused'))\n"
        "except ModelsUnavailable as e:\n"
        "    assert 'huggingface_hub unavailable' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('the download step ran without huggingface_hub')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED + ('jax', 'whisperkit_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:
            default = dataclasses.asdict(f.default_factory())
        else:
            default = dataclasses.MISSING
        out[f.name] = default
    return out


@pytest.mark.parametrize("name", ["DecodingOptions", "ComputeOptions", "WhisperConfig"])
def test_configuration_fields_and_defaults_match(name):
    ours, ref = _fields(getattr(conf, name)), _fields(getattr(jconf, name))
    assert list(ours) == list(ref)
    for field in ref:
        assert ours[field] == ref[field], field


def test_configuration_behaviour_matches():
    for kw in ({}, {"temperature": 0.3, "temperature_fallback_count": 2}):
        assert conf.DecodingOptions(**kw).temperatures == jconf.DecodingOptions(**kw).temperatures
    o = conf.DecodingOptions(task="translate", chunking_strategy="vad")
    assert o.task is conf.DecodingTask.TRANSLATE and o.chunking_strategy is conf.ChunkingStrategy.VAD
    assert [m.value for m in conf.ChunkingStrategy] == [m.value for m in jconf.ChunkingStrategy]
    assert [m.value for m in conf.DecodingTask] == [m.value for m in jconf.DecodingTask]
    for bad in ({"sample_length": 0}, {"temperature_fallback_count": -1}, {"priority": "x"}):
        with pytest.raises(ValueError):
            conf.DecodingOptions(**bad)
    assert dataclasses.asdict(conf.ComputeOptions.serving(quantization="w8a16")) == dataclasses.asdict(
        jconf.ComputeOptions.serving(quantization="w8a16")
    )


@pytest.mark.parametrize(
    "ours, ref",
    [
        (results.TranscriptionSegment, jresults.TranscriptionSegment),
        (results.TranscriptionResult, jresults.TranscriptionResult),
        (results.TranscriptionProgress, jresults.TranscriptionProgress),
        (results.WordTiming, jresults.WordTiming),
        (timings.TranscriptionTimings, jtimings.TranscriptionTimings),
    ],
    ids=lambda c: c.__name__,
)
def test_result_types_match(ours, ref):
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]


def test_decoding_fallback_and_timings_match():
    cases = [
        dict(compression_ratio=3.0, avg_logprob=-0.5, first_token_logprob=-0.1, no_speech_prob=0.1),
        dict(compression_ratio=1.0, avg_logprob=-2.0, first_token_logprob=-0.1, no_speech_prob=0.1),
        dict(compression_ratio=1.0, avg_logprob=-0.5, first_token_logprob=-3.0, no_speech_prob=0.1),
        dict(compression_ratio=3.0, avg_logprob=-2.0, first_token_logprob=-3.0, no_speech_prob=0.9),
        dict(compression_ratio=1.0, avg_logprob=-0.5, first_token_logprob=None, no_speech_prob=0.1),
    ]
    thresholds = dict(logprob_threshold=-1.0, first_token_logprob_threshold=-1.5,
                      no_speech_threshold=0.6, compression_ratio_threshold=2.4)
    for c in cases:
        a = results.DecodingFallback.evaluate(**thresholds, **c)
        b = jresults.DecodingFallback.evaluate(**thresholds, **c)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.need_fallback, a.fallback_reason.value) == (b.need_fallback, b.fallback_reason.value)
    t, jt = timings.TranscriptionTimings(), jtimings.TranscriptionTimings()
    for x in (t, jt):
        x.full_pipeline, x.input_audio_seconds, x.total_decoding_loops = 2.0, 60.0, 500
    assert (t.tokens_per_second, t.real_time_factor, t.speed_factor) == (
        jt.tokens_per_second, jt.real_time_factor, jt.speed_factor)


def test_workload_matches_bench():
    for seconds in (7.3, 120.0):
        np.testing.assert_array_equal(workload.synth_speechlike_audio(seconds, seed=3),
                                      bench.synth_speechlike_audio(seconds, seed=3))
    assert dataclasses.asdict(workload.pipeline_options(32)) == dataclasses.asdict(bench.pipeline_options(32))


@pytest.mark.parametrize("seconds", [25.0, 120.0])
def test_vad_chunker_boundaries_match(seconds):
    audio = workload.synth_speechlike_audio(seconds)
    ours = chunker.VADAudioChunker().chunk_all(audio)
    ref = jchunker.VADAudioChunker().chunk_all(audio)
    assert [(c.seek_offset_index, len(c.audio_samples)) for c in ours] == [
        (c.seek_offset_index, len(c.audio_samples)) for c in ref
    ]
    assert len(ours) >= (2 if seconds > 30 else 1)


def test_audio_helpers_match(tmp_path):
    from whisperkit_tpu.audio import io as jio

    x = workload.synth_speechlike_audio(3.0)
    np.testing.assert_array_equal(audio_io.pad_or_trim(x), jio.pad_or_trim(x))
    np.testing.assert_array_equal(audio_io.pad_or_trim(x, start=100, length=500),
                                  jio.pad_or_trim(x, start=100, length=500))
    np.testing.assert_array_equal(audio_io.energy_per_frame(x, 1600), jio.energy_per_frame(x, 1600))
    stereo = np.stack([x, -0.5 * x])
    np.testing.assert_array_equal(audio_io.convert_to_mono(stereo), jio.convert_to_mono(stereo))
    # a 16-bit stereo 22.05 kHz WAV reads, mixes and resamples the same
    import wave

    pcm = (np.stack([x, 0.5 * x], axis=1) * 32767).astype("<i2")
    path = tmp_path / "a.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes(pcm.tobytes())
    np.testing.assert_array_equal(audio_io.load_audio(path), jio.load_audio(path))
    np.testing.assert_array_equal(audio_io.load_audio(path, start_time=0.5, end_time=1.5),
                                  jio.load_audio(path, start_time=0.5, end_time=1.5))


@pytest.mark.parametrize("n_vocab", [207, 51864, 51865, 51866])
def test_special_tokens_and_fake_tokenizer_match(n_vocab):
    sp, jsp = tokenizer.special_tokens_for_vocab(n_vocab, 5), jtok.special_tokens_for_vocab(n_vocab, 5)
    assert dataclasses.asdict(sp) == dataclasses.asdict(jsp)
    assert sp.language_begin == jsp.language_begin
    assert [sp.language_token(c) for c in ("en", "zh")] == [jsp.language_token(c) for c in ("en", "zh")]
    assert sp.timestamp_seconds(sp.timestamp_begin + 50) == jsp.timestamp_seconds(jsp.timestamp_begin + 50)
    fake, jfake = tokenizer.FakeTokenizer(n_vocab), jtok.FakeTokenizer(n_vocab)
    assert dataclasses.asdict(fake.special) == dataclasses.asdict(jfake.special)
    ids = [3, 17, sp.eot, sp.timestamp_begin + 7, 42]
    assert fake.decode(ids) == jfake.decode(ids)
    assert fake.decode_with_timestamps(ids) == jfake.decode_with_timestamps(ids)
    assert fake.encode(" t3 t17 x t42") == jfake.encode(" t3 t17 x t42")
    assert languages.LANGUAGES == jlanguages.LANGUAGES


@pytest.mark.parametrize(
    "tokens",
    [
        "pairs",  # <|0.00|> text <|1.00|><|1.00|> text <|2.00|> EOT
        "single_ending",  # ... text <|2.00|> EOT after a pair
        "no_pairs",  # <|0.00|> text text EOT
        "text_only",
    ],
)
def test_find_seek_point_and_segments_matches(tokens):
    sp = tokenizer.special_tokens_for_vocab(51866, 220)
    ts = sp.timestamp_begin
    seqs = {
        "pairs": [ts, 100, 101, ts + 50, ts + 50, 102, ts + 100, ts + 100, sp.eot],
        "single_ending": [ts, 100, ts + 50, ts + 50, 101, ts + 100, sp.eot],
        "no_pairs": [ts, 100, 101, sp.eot],
        "text_only": [100, 101, 102],
    }
    toks = seqs[tokens]
    lps = [-0.1 * (i + 1) for i in range(len(toks))]
    kw = dict(tokens=toks, token_logprobs=lps, time_offset=12.0, window_frames=2800, seek=1200,
              decode_fn=lambda ids: " ".join(map(str, ids)), temperature=0.2, avg_logprob=-0.3,
              compression_ratio=1.5, no_speech_prob=0.01, segment_id_start=4)
    ours = segment_seeker.find_seek_point_and_segments(special=sp, **kw)
    ref = jseeker.find_seek_point_and_segments(special=jtok.special_tokens_for_vocab(51866, 220), **kw)
    assert ours.seek_advance_frames == ref.seek_advance_frames
    assert [dataclasses.asdict(s) for s in ours.segments] == [dataclasses.asdict(s) for s in ref.segments]
    assert (segment_seeker.FRAMES_PER_SECOND, segment_seeker.WINDOW_FRAMES) == (
        jseeker.FRAMES_PER_SECOND, jseeker.WINDOW_FRAMES)


def test_compression_ratio_matches():
    for text in ("", "hello world", "ab" * 300, " t1 t2 t3 t4"):
        assert utils.compression_ratio_text(text) == jutils.compression_ratio_text(text)
    _same_source(utils, jutils, ["compression_ratio_text", "compression_ratio_tokens"])


def test_native_decoder_matches(tmp_path):
    """The port's binding of native/audio_decoder.cpp (built into the
    git-ignored build directory) decodes as the JAX package's does, and
    `load_audio` takes it for a container that is not WAV by name."""
    import shutil
    import wave

    from whisperkit_tpu.audio import io as jio
    from whisperkit_tpu.audio import native as jnative
    from whisperkit_tpu_torch.audio import native

    assert native.available()
    x = workload.synth_speechlike_audio(2.0)
    path = tmp_path / "a.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((x * 32767).astype("<i2").tobytes())
    ours, rate, channels = native.decode(str(path))
    ref, jrate, jchannels = jnative.decode(str(path))
    assert (rate, channels) == (jrate, jchannels) == (16000, 1)
    np.testing.assert_array_equal(ours, ref)
    other = tmp_path / "a.audio"
    shutil.copy(path, other)
    np.testing.assert_array_equal(audio_io.load_audio(other), jio.load_audio(other))


def _same_source(ours, ref, names):
    """Each named function's source is the original's, line for line, but
    for the imports it was written against."""
    import inspect

    for name in names:
        assert inspect.getsource(getattr(ours, name)) == inspect.getsource(getattr(ref, name)), name


def test_word_timestamps_copy_matches():
    """text/word_timestamps.py is a copy: the same functions and constants,
    the same source, the same words on the same alignment."""
    public = sorted(n for n in vars(jword_timestamps) if not n.startswith("__") and callable(
        getattr(jword_timestamps, n)) and getattr(getattr(jword_timestamps, n), "__module__", "") ==
        jword_timestamps.__name__)
    assert public == sorted(n for n in vars(word_timestamps) if not n.startswith("__") and callable(
        getattr(word_timestamps, n)) and getattr(getattr(word_timestamps, n), "__module__", "") ==
        word_timestamps.__name__)
    _same_source(word_timestamps, jword_timestamps, public)
    for const in ("PREPEND_PUNCTUATIONS", "APPEND_PUNCTUATIONS", "SECONDS_PER_TIME_TOKEN", "MEDFILT_WIDTH",
                  "_SENTENCE_END"):
        assert getattr(word_timestamps, const) == getattr(jword_timestamps, const), const
    assert word_timestamps.WordTiming is results.WordTiming


def test_early_stop_flag_copy_matches():
    import inspect

    assert inspect.getsource(concurrency.EarlyStopFlag).split('"""')[2] == (
        inspect.getsource(jconcurrency.EarlyStopFlag).split('"""')[2])
    for flag in (concurrency.EarlyStopFlag(), jconcurrency.EarlyStopFlag()):
        flag.stop()
        assert flag.should_stop


def test_writer_and_transcription_utils_copies_match():
    """text/writers.py and text/transcription_utils.py are copies: the same
    functions and classes, the same source but for the imports."""
    import inspect

    from whisperkit_tpu.text import transcription_utils as jtu
    from whisperkit_tpu.text import writers as jwriters
    from whisperkit_tpu_torch.text import transcription_utils as tu
    from whisperkit_tpu_torch.text import writers as twriters

    for ours, ref in ((twriters, jwriters), (tu, jtu)):
        names = sorted(n for n, v in vars(ref).items() if (inspect.isfunction(v) or inspect.isclass(v))
                       and v.__module__ == ref.__name__)
        assert names == sorted(n for n, v in vars(ours).items() if (inspect.isfunction(v) or inspect.isclass(v))
                               and v.__module__ == ours.__name__)
        _same_source(ours, ref, names)
    assert sorted(twriters.WRITERS) == sorted(jwriters.WRITERS)


@pytest.mark.parametrize("name", ["speaker.results", "speaker.clustering", "audio.capture", "audio.output"])
def test_speaker_and_capture_copies_match(name):
    """speaker/results.py, speaker/clustering.py, audio/capture.py and
    audio/output.py are copies: the same functions, classes and constants,
    the same source but for the imports; the VAD's `is_voice_detected` too
    (streaming's gate)."""
    import importlib
    import inspect

    from whisperkit_tpu.audio import vad as jvad
    from whisperkit_tpu_torch.audio import vad

    ours = importlib.import_module(f"whisperkit_tpu_torch.{name}")
    ref = importlib.import_module(f"whisperkit_tpu.{name}")
    names = sorted(n for n, v in vars(ref).items() if (inspect.isfunction(v) or inspect.isclass(v))
                   and v.__module__ == ref.__name__)
    assert names == sorted(n for n, v in vars(ours).items() if (inspect.isfunction(v) or inspect.isclass(v))
                           and v.__module__ == ours.__name__)
    _same_source(ours, ref, names)
    consts = [n for n, v in vars(ref).items() if n.isupper() or n.startswith("_SPEAKER")]
    assert all(getattr(ours, n) == getattr(ref, n) for n in consts)
    _same_source(vad, jvad, ["is_voice_detected"])


def _same_source_but_the_package(ours, ref, names):
    """Each named function's or class's source is the original's, with the
    JAX package's name replaced by the port's."""
    import inspect

    for name in names:
        assert inspect.getsource(getattr(ours, name)) == inspect.getsource(getattr(ref, name)).replace(
            "whisperkit_tpu.", "whisperkit_tpu_torch."), name


@pytest.mark.parametrize("name", ["eval.spelling_en", "eval.normalize", "eval.wer", "eval.loadgen"])
def test_eval_copies_match(name):
    """eval/spelling_en.py, normalize.py, wer.py and loadgen.py are copies:
    the same functions, classes and constants, the same source but for the
    package's name."""
    import importlib
    import inspect

    ours = importlib.import_module(f"whisperkit_tpu_torch.{name}")
    ref = importlib.import_module(f"whisperkit_tpu.{name}")

    def defined(mod):
        return sorted(n for n, v in vars(mod).items() if (inspect.isfunction(v) or inspect.isclass(v))
                      and v.__module__ == mod.__name__)

    assert defined(ours) == defined(ref)
    _same_source_but_the_package(ours, ref, defined(ref))
    consts = [n for n, v in vars(ref).items() if n.lstrip("_").isupper()]
    assert all(getattr(ours, n) == getattr(ref, n) for n in consts)


def test_concurrency_and_model_manager_copies_match():
    """PropertyLock and CoalescingLoader are the originals' source; the
    ModelManager's methods too (its docstring names the port's prewarm)."""
    import inspect

    from whisperkit_tpu.core import model_manager as jmodel_manager
    from whisperkit_tpu_torch.core import model_manager

    _same_source_but_the_package(concurrency, jconcurrency, ["PropertyLock", "CoalescingLoader"])
    methods = [n for n, v in vars(jmodel_manager.ModelManager).items() if inspect.isfunction(v)
               or isinstance(v, property)]
    assert methods == [n for n, v in vars(model_manager.ModelManager).items() if inspect.isfunction(v)
                       or isinstance(v, property)]
    for n in methods:
        a, b = vars(model_manager.ModelManager)[n], vars(jmodel_manager.ModelManager)[n]
        a, b = (a.fget, b.fget) if isinstance(a, property) else (a, b)
        assert inspect.getsource(a) == inspect.getsource(b), n
