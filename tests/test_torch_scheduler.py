"""The port's continuous-batching scheduler (pipelines/scheduler.py)
against the JAX package's `BatchScheduler`, on the CPU.

Both schedulers drive pipelines with the same random float32 weights (the
JAX `init_params` tree carried across with `params_from_numpy`) over the
same requests, and must give the same tokens per request; the batching
rules (bucketed batches, the latency class at batch 1, the demotion of long
latency requests, progress callbacks, `close()`) are held with the cases of
tests/test_scheduler.py. Greedy decoding with the fallback ladder off where
tokens are compared: JAX keys and torch generators draw different numbers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperkit_tpu.core import configurations as jconf
from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.pipelines.scheduler import BatchScheduler as JaxScheduler
from whisperkit_tpu.pipelines.whisper import WhisperPipeline as JaxPipeline
from whisperkit_tpu_torch.core.configurations import DecodingOptions, WhisperConfig
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.pipelines.scheduler import BatchScheduler
from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

DIMS = model.WhisperDims(80, 207, 1500, 64, 4, 2, 64, 64, 4, 2)
JDIMS = jmodel.WhisperDims(*dataclasses.astuple(DIMS))
OPTS = dict(sample_length=6, language="en")
GREEDY = dict(
    temperature_fallback_count=0, logprob_threshold=None, compression_ratio_threshold=None,
    no_speech_threshold=None, first_token_log_prob_threshold=None, **OPTS,
)


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(jax.random.PRNGKey(0), JDIMS, dtype=jnp.float32)


@pytest.fixture(scope="module")
def pipes(jparams):
    jax_pipe = JaxPipeline(
        jconf.WhisperConfig(compute_options=jconf.ComputeOptions(dp_size=1), load=False),
        dims=JDIMS, params=jparams,
    )
    tparams = model.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jax_pipe, WhisperPipeline(WhisperConfig(load=False), dims=DIMS, params=tparams, device="cpu")


@pytest.fixture
def pipe(pipes):
    return pipes[1]


def _audio(seconds, seed):
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)


def _tokens(result):
    return [s.tokens for s in result.segments]


def _both(pipes, requests, max_batch=8, max_wait_ms=300.0):
    """Submit `requests` [(audio, options kwargs)] to both schedulers
    together; (port results, JAX results, port stats, JAX counters)."""
    jax_pipe, torch_pipe = pipes
    out = []
    for sched_cls, p, conf in ((BatchScheduler, torch_pipe, None), (JaxScheduler, jax_pipe, jconf)):
        sched = sched_cls(p, max_batch=max_batch, max_wait_ms=max_wait_ms)
        opts = DecodingOptions if conf is None else conf.DecodingOptions
        futures = [sched.submit(a, opts(**kw)) for a, kw in requests]
        results = [f.result(timeout=600) for f in futures]
        out.append((results, (sched.batches_run, sched.jobs_run, sched.windows_run)))
        sched.shutdown()
    return out[0][0], out[1][0], out[0][1], out[1][1]


def test_concurrent_mixed_length_requests_match_jax(pipes):
    """Short requests and a 65 s VAD-chunked one share one bucket-8 batch
    in both schedulers, and each request's tokens are JAX's."""
    long_audio = _audio(65, 4)
    requests = [(long_audio, dict(chunking_strategy="vad", **GREEDY))]
    requests += [(_audio(s, 10 + i), dict(chunking_strategy="vad", **GREEDY)) for i, s in enumerate((3, 1.5))]
    ours, ref, counts, jcounts = _both(pipes, requests)
    assert counts == jcounts == (1, 3, 5)  # 3 long windows + 2 short, one batch
    for a, b in zip(ours, ref):
        assert _tokens(a) == _tokens(b) and a.text == b.text and a.language == b.language
        assert [round(s.start, 3) for s in a.segments] == [round(s.start, 3) for s in b.segments]
        assert a.timings.input_audio_seconds == pytest.approx(b.timings.input_audio_seconds)
    # and the long request equals the pipeline's own VAD path
    solo = pipes[1].transcribe(long_audio, DecodingOptions(chunking_strategy="vad", **GREEDY))
    assert _tokens(ours[0]) == _tokens(solo)


def test_latency_class_and_incompatible_options_match_jax(pipes):
    """Latency requests decode alone at batch 1; options that differ never
    share a batch; tokens equal JAX's."""
    a = _audio(2, 5)
    requests = [(a, dict(priority="latency", **GREEDY)), (_audio(2, 6), dict(priority="latency", **GREEDY)),
                (a, dict(**GREEDY)), (a, dict(without_timestamps=True, **GREEDY))]
    ours, ref, counts, jcounts = _both(pipes, requests)
    assert counts == jcounts == (4, 4, 4)
    for x, y in zip(ours, ref):
        assert _tokens(x) == _tokens(y)
    sp = pipes[1].tokenizer.special
    assert all(t < sp.timestamp_begin for s in ours[3].segments for t in s.tokens)
    assert _tokens(ours[0]) == _tokens(pipes[1].transcribe(a, DecodingOptions(**GREEDY)))


def test_long_latency_request_demoted_like_jax(pipes):
    """A latency request longer than one window is demoted to throughput:
    its 3 windows batch with the short request (≤ 2 batches, not 4)."""
    requests = [(_audio(65, 12), dict(priority="latency", chunking_strategy="vad", **GREEDY)),
                (_audio(2, 13), dict(chunking_strategy="vad", **GREEDY))]
    ours, ref, counts, jcounts = _both(pipes, requests)
    assert counts[0] <= 2 and counts == jcounts
    for x, y in zip(ours, ref):
        assert _tokens(x) == _tokens(y)


def test_batches_concurrent_requests_and_stats(pipe):
    sched = BatchScheduler(pipe, max_batch=8, max_wait_ms=200.0)
    futures = [sched.submit(_audio(3, 20 + i), DecodingOptions(**OPTS)) for i in range(6)]
    results = [f.result(timeout=300) for f in futures]
    assert all(r.segments is not None for r in results)
    stats = sched.stats
    assert stats["jobs_run"] == 6 and stats["batches_run"] <= 3
    assert sum(stats["windows_per_batch"]) == stats["windows_run"] == 6
    assert len(stats["windows_per_batch"]) == stats["batches_run"]
    sched.close()
    assert not sched._thread.is_alive()


def test_transcribe_sync_api_and_close_with_backlog(pipe):
    import time

    sched = BatchScheduler(pipe, max_batch=4, max_wait_ms=20.0)
    res = sched.transcribe(_audio(1, 3), DecodingOptions(**OPTS), timeout=300)
    assert res.timings.input_audio_seconds == pytest.approx(1.0, abs=0.05)
    futs = [sched.submit(_audio(1, 30 + i), DecodingOptions(**OPTS)) for i in range(3)]
    for f in futs:
        f.result(timeout=300)
    t0 = time.perf_counter()
    sched.close()
    assert time.perf_counter() - t0 < 10.0


def test_latency_runs_speculative_with_draft(pipes, monkeypatch):
    """A latency request on a draft-armed pipeline takes the lossless
    draft-verify loop: tokens equal the plain greedy decode."""
    from whisperkit_tpu_torch.pipelines import whisper as wp

    pipe = pipes[1]
    draft = model.init_params(9, DIMS, torch.float32, "cpu")
    spec_pipe = WhisperPipeline(WhisperConfig(load=False), dims=DIMS, params=pipe.params, draft_dims=DIMS,
                                draft_params=draft, device="cpu")
    calls = []
    orig = wp.speculative_decode_loop
    monkeypatch.setattr(wp, "speculative_decode_loop", lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1])
    sched = BatchScheduler(spec_pipe, max_batch=8, max_wait_ms=50.0)
    a = _audio(2, 7)
    res = sched.submit(a, DecodingOptions(priority="latency", **OPTS)).result(timeout=300)
    sched.close()
    assert calls, "the latency request did not take the speculative path"
    assert _tokens(res) == _tokens(pipe.transcribe(a, DecodingOptions(**OPTS)))


def test_latency_stream_does_not_starve_throughput(pipe, monkeypatch):
    order = []
    orig = BatchScheduler._process_group

    def spy(self, group):
        classes = {w.options.priority for w in group}
        assert len(classes) == 1, "a batch mixed latency and throughput windows"
        if "latency" in classes:
            assert len(group) == 1
        order.append(group[0].options.priority)
        return orig(self, group)

    monkeypatch.setattr(BatchScheduler, "_process_group", spy)
    sched = BatchScheduler(pipe, max_batch=8, max_wait_ms=100.0)
    a = _audio(1, 8)
    futs = []
    for _ in range(4):
        futs.append(sched.submit(a, DecodingOptions(priority="latency", **OPTS)))
        futs.append(sched.submit(a, DecodingOptions(**OPTS)))
    for f in futs:
        f.result(timeout=300)
    sched.close()
    assert "throughput" in order and "latency" in order
    assert order.index("throughput") < len(order) - 1 - order[::-1].index("latency")


def test_failure_reaches_the_future_and_collector_survives(pipe, monkeypatch):
    calls = {"n": 0}
    orig = BatchScheduler._process_group

    def failing(self, group):
        if group[0].options.priority == "latency" and calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("injected decode failure")
        return orig(self, group)

    monkeypatch.setattr(BatchScheduler, "_process_group", failing)
    sched = BatchScheduler(pipe, max_batch=4, max_wait_ms=50.0)
    a = _audio(1, 9)
    with pytest.raises(RuntimeError, match="injected"):
        sched.submit(a, DecodingOptions(priority="latency", **OPTS)).result(timeout=300)
    assert sched.submit(a, DecodingOptions(priority="latency", **OPTS)).result(timeout=300).segments is not None
    assert sched.submit(a, DecodingOptions(**OPTS)).result(timeout=300).segments is not None
    # a long request whose clip selects nothing resolves empty
    r = sched.submit(_audio(40, 7), DecodingOptions(chunking_strategy="vad", clip_timestamps=[39.0, 39.0],
                                                    **OPTS)).result(timeout=60)
    assert r.segments == [] and r.text == ""
    sched.close()


def test_progress_callbacks_stream_in_order_and_cancel(pipe):
    sched = BatchScheduler(pipe, max_batch=4, max_wait_ms=50.0)
    long_audio = _audio(65, 8)
    deltas: list[str] = []
    res = sched.submit(long_audio, DecodingOptions(chunking_strategy="vad", **OPTS),
                       progress_callback=deltas.append).result(timeout=600)
    assert len(deltas) >= 2 and "".join(deltas).strip() == res.text
    short_deltas: list[str] = []
    r2 = sched.submit(_audio(2, 9), DecodingOptions(**OPTS), progress_callback=short_deltas.append).result(timeout=300)
    assert short_deltas == [r2.text]
    sched.close()

    sched = BatchScheduler(pipe, max_batch=1, max_wait_ms=50.0)
    seen: list[str] = []

    def broken(text):
        seen.append(text)
        raise RuntimeError("event loop is closed")

    f_long = sched.submit(long_audio, DecodingOptions(chunking_strategy="vad", **OPTS), progress_callback=broken)
    f_short = sched.submit(_audio(2, 11), DecodingOptions(**OPTS))
    partial = f_long.result(timeout=600)  # cancelled after its first delta, not failed
    assert len(seen) == 1 and partial.text == seen[0].strip()
    assert f_short.result(timeout=300).segments is not None
    sched.close()


def test_mixed_language_batch_and_segment_languages(pipe, monkeypatch):
    """Requests with no language in one batch detect and decode in their own
    language (per-row prompts); a long job decodes every window in its
    first window's language; segments carry it."""
    det = dict(GREEDY, language=None)
    monkeypatch.setattr(WhisperPipeline, "_detect_languages_per_row",
                        lambda self, ck, cv, n_rows=None: (["en", "zh"] * n_rows)[:n_rows])
    built = []
    orig_build = WhisperPipeline._build_prompt

    def spy(self, options, language):
        built.append(language)
        return orig_build(self, options, language)

    monkeypatch.setattr(WhisperPipeline, "_build_prompt", spy)
    a = _audio(2, 5)
    sched = BatchScheduler(pipe, max_batch=8, max_wait_ms=300.0)
    f1, f2 = sched.submit(a, DecodingOptions(**det)), sched.submit(a.copy(), DecodingOptions(**det))
    r1, r2 = f1.result(timeout=300), f2.result(timeout=300)
    assert sched.batches_run == 1 and (r1.language, r2.language) == ("en", "zh")
    assert _tokens(r2) == _tokens(pipe.transcribe(a, DecodingOptions(**dict(det, language="zh"))))
    assert all(s.language == "zh" for s in r2.segments)
    built.clear()
    res = sched.submit(_audio(65, 6), DecodingOptions(chunking_strategy="vad", **det)).result(timeout=600)
    sched.close()
    assert res.language == "en" and set(built) == {"en"}
    assert res.segments and all(s.language == "en" for s in res.segments)
