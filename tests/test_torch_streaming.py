"""The port's AudioStreamTranscriber against the JAX package's, on the CPU,
over pipelines with the same random float32 weights and alignment heads:
the confirmed segments, the VAD gate, the early stop that aborts a pass,
no early stop on healthy windows, and eager word confirmation (the JAX
package's own streaming tests are the templates). The capture module's
copy keeps the original's functions.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperkit_tpu.audio import capture as jcapture
from whisperkit_tpu.core import configurations as jconf
from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.pipelines import streaming as jstreaming
from whisperkit_tpu.pipelines.whisper import WhisperPipeline as JaxPipeline
from whisperkit_tpu_torch.audio import capture
from whisperkit_tpu_torch.core import configurations as conf
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.pipelines import streaming
from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

DIMS = model.WhisperDims(80, 207, 1500, 64, 4, 2, 64, 64, 4, 2)
HEADS = np.asarray([[0, 1], [1, 2]], np.int32)


@pytest.fixture(scope="module")
def pipes():
    """One float32 tree drawn by the port's init_params, in JAX's layout for
    the JAX pipeline (JAX's own random init compiles once per shape)."""
    tparams = model.init_params(0, DIMS, torch.float32, "cpu")
    jparams = jax.tree.map(jnp.asarray, model.params_to_numpy(tparams))
    jpipe = JaxPipeline(jconf.WhisperConfig(compute_options=jconf.ComputeOptions(dp_size=1), load=False),
                        dims=jmodel.WhisperDims(*dataclasses.astuple(DIMS)), params=jparams, alignment_heads=HEADS)
    pipe = WhisperPipeline(conf.WhisperConfig(load=False), dims=DIMS, params=tparams, alignment_heads=HEADS,
                           device="cpu")
    return jpipe, pipe


def _noise(seed, seconds):
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds)) * 0.2).astype(np.float32)


def _segments(segs):
    return [(s.start, s.end, s.text, s.tokens) for s in segs]


def _words(words):
    return [(w.word, w.start, w.end, w.tokens) for w in words]


def _both(pipes, options, **kw):
    jpipe, pipe = pipes
    return (jstreaming.AudioStreamTranscriber(jpipe, jconf.DecodingOptions(**options), **kw),
            streaming.AudioStreamTranscriber(pipe, conf.DecodingOptions(**options), **kw))


def _spy(monkeypatch, pipe):
    """Record what the streamer's progress callback returns per window."""
    calls = []
    orig = pipe.transcribe

    def spying(audio, options, callback=None):
        def counting(p):
            r = callback(p)
            calls.append(r)
            return r

        return orig(audio, options, callback=counting)

    monkeypatch.setattr(pipe, "transcribe", spying)
    return calls


def test_streaming_confirms_segments_as_jax(pipes):
    """Each pass's state over a 12 s stream in 4 s slices: the same confirmed
    and unconfirmed segments, current text and confirmation point."""
    audio = _noise(0, 12)
    jst, st = _both(pipes, dict(sample_length=6, language="en", temperature_fallback_count=0), use_vad=False)
    ours = [(_segments(s.confirmed_segments), _segments(s.unconfirmed_segments), s.current_text,
             s.last_confirmed_segment_end_seconds)
            for s in st.stream(streaming.simulate_stream(audio, chunk_seconds=4.0))]
    ref = [(_segments(s.confirmed_segments), _segments(s.unconfirmed_segments), s.current_text,
            s.last_confirmed_segment_end_seconds)
           for s in jst.stream(jstreaming.simulate_stream(audio, chunk_seconds=4.0))]
    assert ours == ref and len(ours) >= 3
    assert st.confirmed_text == jst.confirmed_text


def test_streaming_vad_gates_silence_as_jax(pipes):
    jst, st = _both(pipes, dict(sample_length=6, language="en"), use_vad=True)
    for s in (jst, st):
        s.feed(np.zeros(16000 * 6, np.float32))
        assert s.process_pending() is False  # gated, no decode
        assert s.state.last_buffer_size == 16000 * 6
        s.feed(np.zeros(16000 // 2, np.float32))
        assert s.process_pending() is False  # < 1 s of new audio


def test_streaming_early_stop_aborts_pass_as_jax(pipes, monkeypatch):
    """logprob_threshold=+1e9: the first window's progress callback returns
    False and ends the pass of a 40 s buffer in both packages."""
    jst, st = _both(pipes, dict(sample_length=6, language="en", logprob_threshold=1e9,
                                temperature_fallback_count=0), use_vad=False)
    audio = _noise(5, 40)
    calls = [_spy(monkeypatch, s.pipeline) for s in (jst, st)]
    for s in (jst, st):
        s.feed(audio)
        assert s._transcribe_current_buffer() is True
    assert calls[0] == calls[1] == [False]
    assert st.state.current_text == jst.state.current_text
    assert st.state.current_fallbacks == jst.state.current_fallbacks == 0


def test_streaming_no_early_stop_on_healthy_windows_as_jax(pipes, monkeypatch):
    jst, st = _both(pipes, dict(sample_length=6, language="en", logprob_threshold=None,
                                compression_ratio_threshold=None, temperature_fallback_count=0), use_vad=False)
    audio = _noise(6, 40)
    calls = [_spy(monkeypatch, s.pipeline) for s in (jst, st)]
    for s in (jst, st):
        s.feed(audio)
        assert s._transcribe_current_buffer() is True
    assert calls[0] == calls[1] and len(calls[1]) >= 2 and all(r is None for r in calls[1])
    assert _segments(st.state.unconfirmed_segments) == _segments(jst.state.unconfirmed_segments)


def test_streaming_eager_word_confirmation_as_jax(pipes):
    """Eager mode over 10 s in 1 s slices, re-decoding from the last agreed
    word (no tolerance before it): after every pass the same confirmed and
    hypothesis words, and the same trimmed buffer (seconds dropped behind
    the confirmation point, samples kept); the confirmed words are only
    ever extended."""
    audio = _noise(1, 10)
    jst, st = _both(pipes, dict(sample_length=6, language="en", temperature_fallback_count=0), use_vad=False,
                    eager=True, eager_tolerance_seconds=0.0)
    ours, prev = [], []
    for s in st.stream(streaming.simulate_stream(audio, chunk_seconds=1.0)):
        confirmed = _words(s.confirmed_words)
        assert confirmed[: len(prev)] == prev
        prev = confirmed
        ours.append((confirmed, _words(s.hypothesis_words), s.last_agreed_seconds, st._dropped_seconds,
                     len(st._buffer)))
    ref = [(_words(s.confirmed_words), _words(s.hypothesis_words), s.last_agreed_seconds, jst._dropped_seconds,
            len(jst._buffer)) for s in jst.stream(jstreaming.simulate_stream(audio, chunk_seconds=1.0))]
    assert ours == ref and len(ours) >= 9 and ours[-1][0] and ours[-1][3] > 0
    assert st.options.word_timestamps and st.confirmed_text == jst.confirmed_text


def test_capture_copy_matches():
    """audio/capture.py is a copy: the same functions and class, the same
    source but for the imports; no backend on this host."""
    names = sorted(n for n, v in vars(jcapture).items()
                   if (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == jcapture.__name__)
    assert names == ["MicrophoneSource", "capture_available", "list_capture_devices"]
    for name in names:
        assert inspect.getsource(getattr(capture, name)) == inspect.getsource(getattr(jcapture, name)), name
    assert capture.capture_available() == jcapture.capture_available()
    if not capture.capture_available():
        with pytest.raises(RuntimeError, match="sounddevice"):
            capture.MicrophoneSource()
