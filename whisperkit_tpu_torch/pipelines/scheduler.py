"""Continuous batching: concurrent transcription requests share one decode
(port of whisperkit_tpu/pipelines/scheduler.py).

Reference: the reference serves concurrent requests by running independent
batch-of-1 pipelines on TaskGroups (WhisperKit.swift:716-812,
`concurrentWorkerCount`). That wastes the batch dimension — the card's
GEMMs and the decode kernels want all concurrent 30 s windows STACKED.
This scheduler stacks them (SURVEY.md §7.7 "continuous batching of 30 s
windows across concurrent streams"):

  * `submit()` enqueues a request from any thread, returns a Future
  * a collector thread gathers compatible work for up to `max_wait_ms`,
    up to `max_batch` WINDOWS per batch
  * requests longer than one window are VAD-chunked into per-window units
    that batch TOGETHER with other requests' windows (r4: previously a
    long job decoded alone through the pipeline's fixed-size groups,
    wasting up to 12/16 rows — measured mixed-load p99 28 s); the parent
    request resolves when its last window lands
  * one batched mel → encode → decode runs per group; results fan back out

Batch sizes are bucketed to powers of two (padding with silent windows), so
the decode runs a handful of batch shapes, not one per arrival pattern.

All pipeline use, device work included, runs on the collector thread: the
pipeline is not thread-safe, and each kernel launches on the current
stream of the thread that calls it, so one window's work never spans
threads.

Latency class (r8): `DecodingOptions(priority="latency")` requests skip
the batching wait and decode ALONE at batch 1 — which arms the pipeline's
lossless speculative draft-verify loop when a draft model is attached
(pipelines/whisper._encode + decoding/speculative.py). The throughput
class is unaffected: latency windows never merge into its batches
(priority is part of the options signature), the classes alternate under
contention, and requests longer than one window are demoted to
throughput (serial b=1 decodes would be slower than their own batched
path AND monopolize the collector).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from whisperkit_tpu_torch.audio.io import SAMPLE_RATE
from whisperkit_tpu_torch.core.configurations import DecodingOptions
from whisperkit_tpu_torch.core.logging import logging
from whisperkit_tpu_torch.core.results import TranscriptionResult, TranscriptionSegment
from whisperkit_tpu_torch.core.signposts import new_request, signpost
from whisperkit_tpu_torch.text.segment_seeker import (
    WINDOW_FRAMES,
    find_seek_point_and_segments,
)

WINDOW_SAMPLES = 480_000


def _options_key(options: DecodingOptions) -> tuple:
    """Units share one batched decode ONLY when every decode-affecting
    option matches (the whole group is decoded with one options object)."""
    return (
        options.priority,
        options.language,
        options.task,
        options.without_timestamps,
        options.word_timestamps,
        options.sample_length,
        options.beam_size,
        options.top_k,
        options.suppress_blank,
        tuple(options.prompt_tokens or ()),
        tuple(options.prefix_tokens or ()),
        options.temperature,
        options.temperature_increment_on_fallback,
        options.temperature_fallback_count,
        tuple(options.suppress_tokens or ()),
        options.compression_ratio_threshold,
        options.logprob_threshold,
        options.first_token_log_prob_threshold,
        options.no_speech_threshold,
        options.max_initial_timestamp,
        options.length_penalty,
        options.seed,
        options.detect_language,
    )


@dataclasses.dataclass
class _LongJob:
    """A >1-window request awaiting its VAD-chunked windows."""

    future: concurrent.futures.Future
    options: DecodingOptions
    audio_seconds: float
    metas: list[tuple[int, int]]  # per window: (seek_offset samples, frames)
    decodes: dict[int, object] = dataclasses.field(default_factory=dict)
    languages: dict[int, str] = dataclasses.field(default_factory=dict)
    language: Optional[str] = None
    # per-window progress stream (server SSE): called with each window's
    # text in CHRONOLOGICAL order (windows land out of order across
    # batches; `emitted` tracks the contiguous-from-0 frontier). Returning
    # False cancels the job's not-yet-decoded windows.
    callback: Optional[Callable[[str], Optional[bool]]] = None
    emitted: int = 0
    cancelled: bool = False

    @property
    def complete(self) -> bool:
        return len(self.decodes) == len(self.metas)


@dataclasses.dataclass
class _Window:
    """One ≤30 s decode unit: a whole short request, or one chunk of a
    long request."""

    audio: np.ndarray
    options: DecodingOptions
    enqueued_at: float
    future: Optional[concurrent.futures.Future] = None  # short requests
    parent: Optional[_LongJob] = None  # long-request chunks
    index: int = 0
    seek_offset: int = 0
    callback: Optional[Callable[[str], Optional[bool]]] = None  # short requests
    request: Optional[int] = None  # the request's id (core/signposts.new_request)


@dataclasses.dataclass
class _Request:
    audio: np.ndarray
    options: DecodingOptions
    future: concurrent.futures.Future
    enqueued_at: float
    progress_callback: Optional[Callable[[str], Optional[bool]]] = None
    request: Optional[int] = None  # the request's id (core/signposts.new_request)


class BatchScheduler:
    """Batches ≤30 s windows across requests; long audio is VAD-chunked
    into windows that join the same batches."""

    def __init__(
        self,
        pipeline,
        *,
        max_batch: int = 16,
        max_wait_ms: float = 30.0,
    ):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._pending: list[_Window] = []  # windows awaiting a batch slot
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._running = True
        self._thread.start()
        self.batches_run = 0
        self.jobs_run = 0
        self.windows_run = 0
        self.batch_windows: list[int] = []  # real windows of each batch run
        self._served_latency_last = False

    # -- public API ----------------------------------------------------------

    def submit(
        self,
        audio: np.ndarray,
        options: Optional[DecodingOptions] = None,
        progress_callback: Optional[Callable[[str], Optional[bool]]] = None,
    ) -> "concurrent.futures.Future[TranscriptionResult]":
        """`progress_callback`, when given, receives each decoded window's
        text in chronological order (fired on the collector thread — the
        server marshals it onto its event loop). Returning False cancels
        the request's not-yet-decoded windows; the future then resolves
        with the partial result (window granularity — a window already in
        a batch completes)."""
        options = options or DecodingOptions()
        future: concurrent.futures.Future = concurrent.futures.Future()
        audio = np.asarray(audio, np.float32)
        # ALL pipeline use (including VAD chunking of long requests) is
        # serialized on the collector thread: the pipeline object is not
        # thread-safe (timings, language cache, lazy mesh)
        self._queue.put(
            _Request(audio, options, future, time.perf_counter(), progress_callback, new_request())
        )
        return future

    def transcribe(self, audio, options=None, timeout: Optional[float] = None):
        return self.submit(audio, options).result(timeout)

    @property
    def stats(self) -> dict:
        """Batches, jobs and windows run so far, and each batch's count of
        real windows (pad rows excluded)."""
        return {
            "batches_run": self.batches_run,
            "jobs_run": self.jobs_run,
            "windows_run": self.windows_run,
            "windows_per_batch": list(self.batch_windows),
        }

    def shutdown(self) -> None:
        self._running = False
        self._queue.put(None)
        self._thread.join(timeout=5)

    close = shutdown

    # -- collector loop -------------------------------------------------------

    def _expand(self, req: _Request) -> list[_Window]:
        """A request becomes one window, or (long) its VAD-chunked windows
        sharing a _LongJob accumulator (the pipeline's chunking semantics:
        pipelines/whisper._transcribe_vad_chunked).

        The latency class applies to SINGLE-WINDOW requests only: a long
        request's windows would otherwise decode serially at b=1 —
        slower than its own batched path AND monopolizing the collector
        for N decodes. Long latency requests are demoted to throughput
        (their windows batch together, which is also their fastest path).
        """
        if len(req.audio) <= WINDOW_SAMPLES:
            return [
                _Window(
                    req.audio, req.options, req.enqueued_at,
                    future=req.future, callback=req.progress_callback, request=req.request,
                )
            ]
        if req.options.priority == "latency":
            req = dataclasses.replace(
                req,
                options=dataclasses.replace(
                    req.options, priority="throughput"
                ),
            )
        from whisperkit_tpu_torch.audio.chunker import VADAudioChunker

        pipe = self.pipeline
        chunker = VADAudioChunker()
        content_frames = len(req.audio) // 160
        clips = pipe._prepare_seek_clips(req.options, content_frames)
        chunks = []
        with signpost("vad", request=req.request) as span:
            for clip_start_f, clip_end_f in clips:
                region = req.audio[clip_start_f * 160 : clip_end_f * 160]
                for c in chunker.chunk_all(region, max_chunk_length=WINDOW_SAMPLES):
                    c.seek_offset_index += clip_start_f * 160
                    chunks.append(c)
            span.attrs["chunks"] = len(chunks)
        if not chunks:
            # e.g. clip_timestamps selecting an empty region: the pipeline's
            # own VAD path yields an empty result for zero chunks — mirror
            # it here, or the future would never resolve (and an empty
            # window list downstream would kill the collector thread)
            from whisperkit_tpu_torch.core.results import TranscriptionResult

            req.future.set_result(
                TranscriptionResult(
                    text="", segments=[],
                    language=req.options.language or "en",
                )
            )
            return []
        job = _LongJob(
            future=req.future,
            options=req.options,
            audio_seconds=len(req.audio) / SAMPLE_RATE,
            callback=req.progress_callback,
            metas=[
                (
                    c.seek_offset_index,
                    min(WINDOW_FRAMES, math.ceil(len(c.audio_samples) / 160)),
                )
                for c in chunks
            ],
        )
        return [
            _Window(
                c.audio_samples, req.options, req.enqueued_at,
                parent=job, index=i, seek_offset=c.seek_offset_index, request=req.request,
            )
            for i, c in enumerate(chunks)
        ]

    def _gather(self) -> None:
        """Wait for work: block for the first unit unless windows are
        pending, then gather more compatible work for up to max_wait_ms.
        With a latency-class window pending the gather never BLOCKS (those
        requests don't wait to batch) but the queue is still drained
        non-blockingly — queued work must become visible to the
        class-alternation logic in `_run`, or a latency stream would
        starve everything sitting in the queue."""
        if not self._pending:
            req = self._queue.get()
            if req is None:
                return
            try:
                self._pending.extend(self._expand(req))
            except Exception as e:
                req.future.set_exception(e)
                return
        deadline = time.perf_counter() + self.max_wait_ms / 1000.0
        while len(self._pending) < self.max_batch:
            lat_pending = any(
                w.options.priority == "latency" for w in self._pending
            )
            remaining = (
                0.0 if lat_pending else deadline - time.perf_counter()
            )
            try:
                if remaining <= 0:
                    req = self._queue.get_nowait()
                else:
                    req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req is None:
                break
            try:
                self._pending.extend(self._expand(req))
            except Exception as e:
                req.future.set_exception(e)

    def _run(self) -> None:
        while self._running:
            with signpost("batch.gather") as span:
                self._gather()
                span.attrs["pending"] = len(self._pending)

            if not self._pending:
                # every gathered request expanded to zero windows (resolved
                # inline by _expand) or failed — nothing to select; a bare
                # selection here would raise and kill the collector thread
                continue

            # latency-class windows decode ALONE at batch 1, oldest first
            # (b=1 also arms the pipeline's speculative draft-verify loop
            # when a draft model is attached — _encode/_decode_with_fallback).
            # Under contention the classes ALTERNATE: a continuous latency
            # stream must not starve batched throughput work (and vice
            # versa — a latency request waits at most one batch decode).
            lat = [w for w in self._pending if w.options.priority == "latency"]
            tp_pending = len(lat) < len(self._pending)
            if lat and not (self._served_latency_last and tp_pending):
                group = [lat[0]]
                self._served_latency_last = True
            else:
                self._served_latency_last = False
                # one batch = up to max_batch pending windows with ONE
                # options signature (first THROUGHPUT unit's — pending[0]
                # may be a deferred latency window); the rest stay pending
                first_tp = next(
                    w for w in self._pending
                    if w.options.priority != "latency"
                )
                key = _options_key(first_tp.options)
                group = [
                    w for w in self._pending if _options_key(w.options) == key
                ]
                group = group[: self.max_batch]
            taken = set(map(id, group))
            self._pending = [w for w in self._pending if id(w) not in taken]
            try:
                n = len(group)
                with signpost("batch", windows=n, rows=self._bucket(n), pending=len(self._pending)) as span:
                    # each window's queue wait: from its request's submit to this batch
                    waits = [span.t0 - w.enqueued_at for w in group]
                    span.attrs.update(wait_sum_s=sum(waits), wait_max_s=max(waits),
                                      requests=tuple(w.request for w in group))
                    self._process_group(group)
            except Exception as e:
                for w in group:
                    fut = w.future or (w.parent.future if w.parent else None)
                    if fut is not None and not fut.done():
                        fut.set_exception(e)

    # -- batched execution -----------------------------------------------------

    def _bucket(self, n: int) -> int:
        return min(self.max_batch, 1 << max(0, math.ceil(math.log2(max(n, 1)))))

    def _process_group(self, group: list[_Window]) -> None:
        pipe = self.pipeline
        options = group[0].options
        n = len(group)
        bucket = self._bucket(n)

        # one batched mel dispatch for the whole group (+ silent pad rows)
        audios = [w.audio for w in group] + [
            np.zeros(WINDOW_SAMPLES, np.float32)
        ] * (bucket - n)
        with signpost("mel", windows=bucket):
            mel_batch = pipe._mel_batch(audios)

        # pipe._encode honors the serving config (fused int8 cross-KV)
        with signpost("encode", rows=bucket):
            _, ck, cv = pipe._encode(mel_batch, options)
        # rows belong to DIFFERENT requests: each job detects its own
        # language (per-row argmax via the pipeline's shared resolution
        # ladder), and per-row prompts carry it into ONE shared batched
        # decode — never average detection across unrelated jobs
        # (reference: each transcription detects independently,
        # TextDecoder.swift:420)
        langs = pipe._group_languages(options, ck, cv, n, per_row=True)
        if not options.language and pipe.is_multilingual:
            if not options.detect_language:
                # ONE language per multi-window job (reference: a single
                # detection per transcription; only detect_language=True
                # re-detects per window): a job's language is decided by
                # its lowest-index window — windows enqueue in order and
                # groups process FIFO, so that is window 0's batch — and
                # every other window of the job decodes with it (r5
                # review: per-row detection let one noisy window
                # code-switch mid-transcript).
                choice: dict[int, tuple[int, str]] = {}
                for w, lg in zip(group, langs):
                    if w.parent is not None and w.parent.language is None:
                        cur = choice.get(id(w.parent))
                        if cur is None or w.index < cur[0]:
                            choice[id(w.parent)] = (w.index, lg)
                for w in group:
                    if w.parent is not None and w.parent.language is None:
                        picked = choice.get(id(w.parent))
                        if picked is not None:
                            w.parent.language = picked[1]
                langs = [
                    w.parent.language
                    if w.parent is not None and w.parent.language
                    else lg
                    for w, lg in zip(group, langs)
                ]
        pad_langs = [langs[0]] * (bucket - n)  # pad rows are discarded
        decodes = pipe._decode_with_fallback(
            ck, cv, options, langs + pad_langs, 0
        )[:n]

        # count the batch BEFORE resolving futures: a caller that resets the
        # counters the moment its last result() returns (eval/loadgen.py)
        # must not see this batch's accounting land after its reset
        self.batches_run += 1
        self.windows_run += n
        self.batch_windows.append(n)
        with signpost("segments") as span:
            segments = 0
            for w, wd, language in zip(group, decodes, langs):
                if w.parent is None:
                    segments += self._finish_short(w, wd, language)
                    self.jobs_run += 1
                else:
                    w.parent.decodes[w.index] = wd
                    w.parent.languages[w.index] = language
                    # the job's reported language is its FIRST window's (windows
                    # of one job can land in different batches in any order)
                    if w.index == 0 or w.parent.language is None:
                        w.parent.language = language
                    self._emit_progress(w.parent)
                    if w.parent.complete and not w.parent.future.done():
                        segments += self._finish_long(w.parent)
                        self.jobs_run += 1
            span.attrs["segments"] = segments

    def _emit_progress(self, job: _LongJob) -> None:
        """Fire the job's progress callback for every window whose decode
        has landed AND whose chronological predecessors have all been
        emitted (deltas must append in order even though windows land out
        of order across batches). A False return cancels the job: its
        undecoded windows are dropped from the pending list and the future
        resolves with the partial (contiguously decoded) result. A callback
        that RAISES (e.g. the server's call_soon_threadsafe after its event
        loop closed) is treated as a cancellation: the breakage belongs to
        this job's consumer and must not propagate into _process_group's
        error path, which would fail every OTHER request sharing the batch."""
        if job.callback is None or job.cancelled or job.future.done():
            return
        text_options = dataclasses.replace(job.options, word_timestamps=False)
        while job.emitted in job.decodes:
            i = job.emitted
            seek_offset, window_frames = job.metas[i]
            text = "".join(
                s.text
                for s in self._segments_for_window(
                    job.decodes[i], text_options,
                    seek_offset=seek_offset, window_frames=window_frames,
                )
            )
            job.emitted += 1
            try:
                verdict = job.callback(text)
            except Exception as e:  # noqa: BLE001 — consumer is broken
                logging.debug(f"progress callback raised ({e!r}); cancelling job")
                verdict = False
            if verdict is False:
                job.cancelled = True
                self._pending = [p for p in self._pending if p.parent is not job]
                self._finish_long(job, partial=True)
                self.jobs_run += 1
                return

    def _segments_for_window(
        self, wd, options, *, seek_offset: int, window_frames: int,
        segment_id_start: int = 0,
    ) -> list[TranscriptionSegment]:
        pipe = self.pipeline
        if pipe._should_skip_silent(wd, options):
            return []
        res = find_seek_point_and_segments(
            tokens=wd.tokens,
            token_logprobs=wd.logprobs,
            special=pipe.tokenizer.special,
            time_offset=seek_offset / SAMPLE_RATE,
            window_frames=window_frames,
            seek=seek_offset // 160,
            decode_fn=pipe.tokenizer.decode,
            temperature=wd.temperature,
            avg_logprob=wd.avg_logprob,
            compression_ratio=wd.compression_ratio,
            no_speech_prob=wd.no_speech_prob,
            segment_id_start=segment_id_start,
        )
        segments = res.segments
        if options.word_timestamps and wd.alignment is not None:
            segments = pipe._add_word_timestamps(
                segments, wd, seek_offset / SAMPLE_RATE, window_frames
            )
        return segments

    def _finish_short(self, w: _Window, wd, language: str) -> int:
        """Resolve a short request's future; → its segments (0 on failure)."""
        try:
            window_frames = min(WINDOW_FRAMES, math.ceil(len(w.audio) / 160))
            segments = self._segments_for_window(
                wd, w.options, seek_offset=0, window_frames=window_frames
            )
            for s in segments:  # match the pipeline's per-segment metadata
                s.language = language
            result = TranscriptionResult(
                text="".join(s.text for s in segments).strip(),
                segments=segments, language=language,
            )
            result.timings.input_audio_seconds = len(w.audio) / SAMPLE_RATE
            if w.callback is not None:
                try:
                    w.callback(result.text)  # one window: one delta, then done
                except Exception as e:  # noqa: BLE001 — consumer is broken;
                    # the result still resolves (nothing left to cancel)
                    logging.debug(f"progress callback raised ({e!r}); ignoring")
            w.future.set_result(result)
            return len(segments)
        except Exception as e:
            w.future.set_exception(e)
            return 0

    def _finish_long(self, job: _LongJob, partial: bool = False) -> int:
        """`partial=True` (progress-callback cancellation) resolves with the
        contiguously decoded prefix; later-landing windows are ignored.
        → the result's segments (0 where none resolves)."""
        if job.future.done():  # an earlier window's batch already failed it
            return 0
        try:
            indices = range(job.emitted if partial else len(job.metas))
            all_segments: list[TranscriptionSegment] = []
            window_langs: list[str] = []
            for i in indices:
                seek_offset, window_frames = job.metas[i]
                lang = job.languages.get(i, job.language) or "en"
                window_langs.append(lang)
                segs = self._segments_for_window(
                    job.decodes[i], job.options,
                    seek_offset=seek_offset, window_frames=window_frames,
                    segment_id_start=len(all_segments),
                )
                for s in segs:  # per-window decode language, like the
                    s.language = lang  # pipeline's VAD/seek paths
                all_segments.extend(segs)
            result = TranscriptionResult(
                text="".join(s.text for s in all_segments).strip(),
                segments=all_segments,
                # majority across decoded windows (the pipeline's rule) —
                # not first-window-wins
                language=self.pipeline._majority_language(
                    window_langs, job.options
                ),
            )
            result.timings.input_audio_seconds = job.audio_seconds
            job.future.set_result(result)
            return len(all_segments)
        except Exception as e:
            job.future.set_exception(e)
            return 0
