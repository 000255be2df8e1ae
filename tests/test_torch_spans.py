"""The port's stage spans (core/signposts.py) on the CPU: the span tree of
a VAD-chunked transcription, of the batcher's batches and of a TTS
paragraph (`TTSPipeline.generate`), the ring's
bound, and the profiler annotations that the spans enter only while a
profiler session runs.

The pipeline runs at the tiny widths of tests/test_torch_pipeline.py with
the port's own random weights; the decode's CUDA graph runs with the CUDA
calls stood in (as tests/test_torch_decode_graph.py stands them in), so
that `graph.StepGraph` records its spans on the CPU.
"""

import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch

from whisperkit_tpu_torch.core import signposts
from whisperkit_tpu_torch.core.configurations import DecodingOptions, WhisperConfig
from whisperkit_tpu_torch.decoding import graph, loop
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.ops import _build
from whisperkit_tpu_torch.pipelines.scheduler import BatchScheduler
from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
from whisperkit_tpu_torch.tools.workload import synth_speechlike_audio
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

DIMS = model.WhisperDims(80, 207, 1500, 64, 4, 2, 64, 64, 4, 2)
# greedy, quality ladder off; 20 positions, so the loop reads `done` once (at 16)
OPTIONS = dict(
    language="en", sample_length=20, temperature_fallback_count=0, logprob_threshold=None,
    compression_ratio_threshold=None, no_speech_threshold=None, first_token_log_prob_threshold=None,
)
STAGES = ("vad", "mel", "encode", "prefill", "decode", "readback", "fallback_eval", "segments")


@pytest.fixture(scope="module")
def pipe():
    params = model.init_params(0, DIMS, torch.float32, "cpu")
    return WhisperPipeline(WhisperConfig(load=False), dims=DIMS, params=params, device="cpu")


@pytest.fixture
def graphs_on(monkeypatch):
    """The decode loop on a CUDA graph, its CUDA calls stood in: the
    warm-up and the capture run the step, a replay runs nothing."""

    class Stream:
        cuda_stream = 0

        def __init__(self, *_):
            pass

        def wait_stream(self, _):
            pass

        def synchronize(self):
            pass

    class Graph:
        def capture_begin(self, capture_error_mode):
            pass

        def capture_end(self):
            pass

        def replay(self):
            pass

        def reset(self):
            pass

    monkeypatch.setattr(loop, "_graphs_on", lambda device: True)
    monkeypatch.setattr(torch.cuda, "device", lambda _: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda _: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *_: Stream())
    monkeypatch.setattr(torch.cuda, "default_stream", lambda *_: Stream())
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    yield
    _build.reset_launches()
    graph.reset_stats()


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_vad_transcribe_records_the_stage_tree(pipe, graphs_on):
    """transcribe ⊃ vad, mel, encode, prefill, decode ⊃ (graph.warmup,
    graph.capture, graph.first_replay, decode.stop_check, graph.release),
    readback, fallback_eval, segments;
    every span carries the request's id, and the stage timings are the
    spans' seconds."""
    signposts.reset()
    options = DecodingOptions(chunking_strategy="vad", concurrent_worker_count=2, **OPTIONS)
    result = pipe.transcribe(synth_speechlike_audio(65.0, seed=1), options)
    spans = signposts.spans_between(0.0, time.perf_counter())
    (root,) = [s for s in spans if s.name == "transcribe"]
    assert root.parent is None and root.request is not None and root.attrs["audio_s"] == 65.0
    assert all(s.request == root.request and s.thread == root.thread for s in spans)
    assert all(root.t0 <= s.t0 <= s.t1 <= root.t1 for s in spans)

    top = _children(spans, root)
    assert {s.name for s in top} == set(STAGES)
    by = {name: [s for s in top if s.name == name] for name in STAGES}
    chunks = by["vad"][0].attrs["chunks"]
    groups = -(-chunks // 2)
    assert chunks >= 3 and len(by["vad"]) == len(by["mel"]) == len(by["segments"]) == 1
    assert len(by["encode"]) == len(by["prefill"]) == len(by["decode"]) == len(by["readback"]) == groups
    assert by["mel"][0].attrs["windows"] >= chunks
    # the stages follow one another, each group's in order
    assert [s.name for s in top][:2] == ["vad", "mel"] and top[-1].name == "segments"
    for i in range(groups):
        group = [s.name for s in top if s.name in ("encode", "prefill", "decode", "readback", "fallback_eval")]
        assert group[5 * i:5 * i + 5] == ["encode", "prefill", "decode", "readback", "fallback_eval"]
    for decode in by["decode"]:
        assert decode.attrs["rung"] == 0 and decode.attrs["positions"] == 20
        inner = _children(spans, decode)
        assert [s.name for s in inner] == ["graph.warmup", "graph.capture", "graph.first_replay",
                                           "decode.stop_check", "graph.release"]
        assert inner[3].attrs["position"] == len(pipe._build_prompt(options, "en")[0]) + 16
        assert not any(_children(spans, s) for s in inner)
    assert by["segments"][0].attrs["segments"] == len(result.segments)

    t = result.timings
    assert t.full_pipeline == root.seconds and t.pipeline_start == root.t0
    assert t.audio_processing == by["vad"][0].seconds and t.log_mels == by["mel"][0].seconds
    assert t.encoding == pytest.approx(sum(s.seconds for s in by["encode"]), rel=1e-12)
    assert t.prefill == pytest.approx(sum(s.seconds for s in by["prefill"]), rel=1e-12)
    assert t.decoding_loop == pytest.approx(sum(s.seconds for s in by["decode"] + by["readback"]), rel=1e-12)
    assert t.decoding_windowing == by["segments"][0].seconds


@pytest.mark.parametrize("seconds", [5.0, 40.0], ids=["one_window", "seek_loop"])
def test_seek_path_spans(pipe, seconds):
    """The seek path: one mel for the file (or the window), then per window
    encode, prefill, decode, readback, fallback_eval and segments, all
    under the request's root; no graph spans where no graph runs."""
    signposts.reset()
    audio = (np.random.default_rng(7).standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)
    result = pipe.transcribe(audio, DecodingOptions(**OPTIONS))
    spans = signposts.spans_between(0.0, time.perf_counter())
    (root,) = [s for s in spans if s.name == "transcribe"]
    names = [s.name for s in _children(spans, root)]
    windows = names.count("encode")
    assert windows == result.timings.total_decoding_windows >= 1
    assert names.count("mel") == (1 if seconds > 30 else windows)
    for stage in ("prefill", "decode", "readback", "fallback_eval", "segments"):
        assert names.count(stage) == windows, stage
    assert not [s for s in spans if s.name.startswith("graph.")]
    assert result.timings.encoding == pytest.approx(sum(s.seconds for s in spans if s.name == "encode"), rel=1e-12)


def test_scheduler_batches_carry_their_windows_and_queue_wait(pipe, monkeypatch):
    """Each batch span names its windows' requests; its queue wait is the
    sum and the max of (batch start − each window's `enqueued_at`), ≥ 0;
    a long request's VAD runs inside the gather and carries its id."""
    signposts.reset()
    seen = []
    orig = BatchScheduler._process_group

    def spy(self, group):
        seen.append([(w.request, w.enqueued_at) for w in group])
        return orig(self, group)

    monkeypatch.setattr(BatchScheduler, "_process_group", spy)
    sched = BatchScheduler(pipe, max_batch=4, max_wait_ms=300.0)
    options = DecodingOptions(**OPTIONS)
    try:
        futures = [sched.submit(synth_speechlike_audio(s, seed=i), options) for i, s in enumerate((5.0, 8.0, 45.0))]
        for f in futures:
            f.result(timeout=300)
    finally:
        sched.shutdown()
    spans = signposts.spans_between(0.0, time.perf_counter())
    batches = [s for s in spans if s.name == "batch"]
    assert len(batches) == len(seen) == sched.batches_run >= 1
    assert sum(b.attrs["windows"] for b in batches) == sched.windows_run
    ids = {r for group in seen for r, _ in group}
    assert len(ids) == 3
    for b, group in zip(batches, seen):
        waits = [b.t0 - at for _, at in group]
        assert b.parent is None and b.attrs["windows"] == len(group) == len(b.attrs["requests"])
        assert b.attrs["requests"] == tuple(r for r, _ in group)
        assert min(waits) >= 0.0
        assert b.attrs["wait_sum_s"] == pytest.approx(sum(waits), abs=1e-9)
        assert b.attrs["wait_max_s"] == pytest.approx(max(waits), abs=1e-9)
        assert b.attrs["rows"] == sched._bucket(len(group))
        inner = [s.name for s in _children(spans, b)]
        assert inner[:2] == ["mel", "encode"] and inner[-1] == "segments"
        assert {"prefill", "decode", "readback", "fallback_eval"} <= set(inner)
    (vad,) = [s for s in spans if s.name == "vad"]
    gathers = {s.id: s for s in spans if s.name == "batch.gather"}
    assert vad.parent in gathers and vad.request in ids and vad.attrs["chunks"] >= 2
    assert sum(b.attrs["segments"] for b in spans if b.name == "segments") >= 1


def test_the_ring_keeps_its_newest_spans(monkeypatch):
    """The store is a ring: past RING_SIZE spans the oldest go."""
    signposts.reset()
    extra = 100
    for i in range(signposts.RING_SIZE + extra):
        with signposts.signpost("x", i=i):
            pass
    assert len(signposts._ring) == signposts.RING_SIZE == signposts._ring.maxlen
    assert signposts._ring[0].attrs["i"] == extra
    assert len(signposts.intervals("x")) == signposts.RING_SIZE
    signposts.reset()
    assert not signposts._ring


def test_spans_between_and_the_span_object():
    signposts.reset()
    with signposts.signpost("outer", request=7, rows=3) as outer:
        time.sleep(0.002)
        with signposts.signpost("inner") as inner:
            time.sleep(0.002)
        inner.attrs["late"] = True
    assert outer.seconds >= inner.seconds > 0.0
    assert (inner.parent, inner.request, outer.parent) == (outer.id, 7, None)
    assert inner.attrs == {"late": True} and outer.attrs == {"rows": 3}
    assert signposts.spans_between(outer.t0, outer.t1) == [outer, inner]  # oldest start first
    assert signposts.spans_between(inner.t1 + 1e-7, outer.t1) == [outer]
    assert signposts.spans_between(outer.t1 + 1.0, outer.t1 + 2.0) == []
    assert signposts.new_request() != signposts.new_request()


def test_a_span_on_another_thread_has_its_own_parent():
    signposts.reset()
    def work():
        with signposts.signpost("worker"):
            pass

    with signposts.signpost("main") as main:
        t = threading.Thread(target=work)
        t.start()
        t.join()
    (worker,) = [s for s in signposts.spans_between(0.0, time.perf_counter()) if s.name == "worker"]
    assert worker.parent is None and worker.thread != main.thread


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler session a span enters no `record_function`."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with signposts.signpost("quiet") as span:
        pass
    assert span.seconds >= 0.0


def test_spans_are_user_annotations_on_the_profilers_clock(tmp_path):
    """Under a CPU profiler session each span is a user annotation; its
    start in the trace lies within 2 ms of its ring stamp mapped through
    one clock mark."""
    from torch.profiler import ProfilerActivity, profile, record_function

    signposts.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mark = time.perf_counter()
        with record_function("clock.mark"):
            pass
        made = []
        for name in ("stage.a", "stage.b", "stage.c"):
            with signposts.signpost(name) as span:
                time.sleep(0.005)
                torch.ones(32, 32) @ torch.ones(32, 32)
            made.append(span)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    starts = {e["name"]: float(e["ts"]) for e in events if e.get("cat") == "user_annotation"}
    offset = starts["clock.mark"] - mark * 1e6
    for span in made:
        assert span.name in starts
        assert abs(starts[span.name] - (span.t0 * 1e6 + offset)) < 2000.0, span


def test_tts_generate_records_its_stage_tree(monkeypatch):
    """tts ⊃ tts.tokenize, tts.prefill, tts.frames ⊃ tts.stop_check (one a
    segment of 16 frames), readback, tts.vocode, readback, tts.crossfade;
    build_prompt_cache ⊃ tts.prefill; the frames stepped as `tts.frames`
    counts them, and the loop's `TTSLoopOutput.steps`."""
    from whisperkit_tpu_torch.models.qwen3_tts import TINY_TTS_DIMS
    from whisperkit_tpu_torch.pipelines import tts as tts_module
    from whisperkit_tpu_torch.pipelines.tts import GenerationOptions, TTSPipeline

    loop, outs = tts_module.tts_generate_loop, []
    monkeypatch.setattr(tts_module, "tts_generate_loop", lambda *a, **k: outs.append(loop(*a, **k)) or outs[-1])

    pipe = TTSPipeline(TINY_TTS_DIMS, seed=0, device="cpu")
    options = GenerationOptions(max_new_tokens=20, seed=3)
    sentence = "A quiet morning settled over the harbor while the old keeper counted boats and wrote the " \
               "weather into his small notebook."
    signposts.reset()
    pipe.build_prompt_cache(options)
    result = pipe.generate(f"{sentence} {sentence}", options)
    spans = signposts.spans_between(0.0, time.perf_counter())
    cache, root = [s for s in spans if s.parent is None]
    assert cache.name == "tts.prompt_cache" and root.name == "tts"
    (prefix,) = _children(spans, cache)
    assert prefix.name == "tts.prefill" and prefix.attrs == {"rows": 1, "positions": cache.attrs["positions"],
                                                             "cached": 0}
    assert root.attrs == {"text_chars": 2 * len(sentence) + 1, "chunks": 2, "rows": 2}
    assert all(s.request == root.request for s in spans if s is not cache and s is not prefix)
    top = _children(spans, root)
    assert [s.name for s in top] == ["tts.tokenize", "tts.prefill", "tts.frames", "readback", "tts.vocode",
                                     "readback", "tts.crossfade"]
    prefill, frames, vocode = top[1], top[2], top[4]
    assert prefill.attrs == {"rows": 2, "positions": 1, "cached": cache.attrs["positions"]}
    assert vocode.attrs == {"rows": 2, "frames": 20}
    checks = _children(spans, frames)
    assert [s.name for s in checks] == ["tts.stop_check"] * len(checks)
    assert [s.attrs["frame"] for s in checks] == [16, 20][:len(checks)] and frames.attrs["frames"] == 20
    assert [o.steps for o in outs] == [20]
    t = result.timings
    assert t.tokenize_seconds == top[0].seconds and t.chunks == 2
