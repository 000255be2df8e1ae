"""Real-time streaming transcription over a rolling audio buffer (port of
whisperkit_tpu/pipelines/streaming.py, over the port's WhisperPipeline).

Reference: Sources/WhisperKit/Core/Audio/AudioStreamTranscriber.swift —
`State` (:7-18), `startStreamTranscription` (:76-90),
`transcribeCurrentBuffer` (:126-193), `shouldStopEarly` (:208-227) — plus
the CLI's eager `--stream-simulated` mode (TranscribeCLI.swift:322-430):
word-prefix confirmation via longest-common-prefix of consecutive
hypotheses' WordTimings.

The source is any iterator of float32 sample chunks (a mic via
audio/capture.py, a file replayed in slices by `simulate_stream`, a
network stream). Each pass re-transcribes the buffer from the last
confirmed point via clip timestamps; the pipeline's progress callback
updates the live text and, on a looping or low-confidence window, returns
False, which cancels the pass's remaining windows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from whisperkit_tpu_torch.audio.io import SAMPLE_RATE
from whisperkit_tpu_torch.audio.vad import is_voice_detected
from whisperkit_tpu_torch.core.configurations import DecodingOptions
from whisperkit_tpu_torch.core.results import (
    TranscriptionProgress,
    TranscriptionSegment,
    WordTiming,
)
from whisperkit_tpu_torch.text.transcription_utils import (
    find_longest_common_prefix,
    update_segment_timings,
)
from whisperkit_tpu_torch.text.utils import compression_ratio_tokens


@dataclasses.dataclass
class StreamState:
    """Reference: AudioStreamTranscriber.State (:7-18)."""

    is_recording: bool = False
    current_fallbacks: int = 0
    last_buffer_size: int = 0
    last_confirmed_segment_end_seconds: float = 0.0
    buffer_seconds: float = 0.0
    current_text: str = ""
    confirmed_segments: list[TranscriptionSegment] = dataclasses.field(default_factory=list)
    unconfirmed_segments: list[TranscriptionSegment] = dataclasses.field(default_factory=list)
    # eager mode
    confirmed_words: list[WordTiming] = dataclasses.field(default_factory=list)
    hypothesis_words: list[WordTiming] = dataclasses.field(default_factory=list)
    last_agreed_seconds: float = 0.0


class AudioStreamTranscriber:
    """Rolling-buffer streaming transcriber."""

    def __init__(
        self,
        pipeline,
        decode_options: Optional[DecodingOptions] = None,
        *,
        required_segments_for_confirmation: int = 2,
        use_vad: bool = True,
        silence_threshold: float = 0.022,  # AudioStreamTranscriber default
        compression_check_window: int = 60,  # AudioStreamTranscriber.swift:53
        eager: bool = False,
        eager_tolerance_seconds: float = 1.0,
        state_callback: Optional[Callable[[StreamState], None]] = None,
    ):
        self.pipeline = pipeline
        base = decode_options or DecodingOptions()
        if eager and not base.word_timestamps:
            base = dataclasses.replace(base, word_timestamps=True)
        self.options = base
        self.required_segments_for_confirmation = required_segments_for_confirmation
        self.use_vad = use_vad
        self.silence_threshold = silence_threshold
        self.compression_check_window = compression_check_window
        self.eager = eager
        self.eager_tolerance_seconds = eager_tolerance_seconds
        self.state_callback = state_callback
        self.state = StreamState()
        self._buffer = np.zeros(0, np.float32)
        # absolute seconds already trimmed off the front of the buffer —
        # audio before the confirmed point can never change the output, so
        # the buffer stays bounded on long sessions
        self._dropped_seconds = 0.0

    # -- feeding ------------------------------------------------------------

    def feed(self, samples: np.ndarray) -> None:
        self._buffer = np.concatenate([self._buffer, np.asarray(samples, np.float32)])
        self.state.buffer_seconds = self._dropped_seconds + len(self._buffer) / SAMPLE_RATE

    def reset(self) -> None:
        self._buffer = np.zeros(0, np.float32)
        self._dropped_seconds = 0.0
        self.state = StreamState()

    # -- driving ------------------------------------------------------------

    def stream(self, source: Iterable[np.ndarray]) -> Iterator[StreamState]:
        """Consume chunks from `source`, yielding state after each pass.

        Reference: `realtimeLoop` (:98-107) — but pull-based: the caller's
        iterator provides pacing (a mic source blocks on capture; a file
        replay yields slices immediately).
        """
        self.state.is_recording = True
        for chunk in source:
            self.feed(chunk)
            if self.process_pending():
                yield self.state
        # final pass over whatever remains
        self.state.is_recording = False
        if self._transcribe_current_buffer(force=True):
            yield self.state

    def process_pending(self) -> bool:
        """One gate+transcribe pass; returns True if a pass ran.

        Reference: `transcribeCurrentBuffer` (:126-193).
        """
        next_size = len(self._buffer)
        if next_size - self.state.last_buffer_size < SAMPLE_RATE:  # < 1 s new audio
            return False
        if self.use_vad:
            tail = self._buffer[-SAMPLE_RATE:]
            if not is_voice_detected(
                tail, silence_threshold=self.silence_threshold
            ):
                self.state.last_buffer_size = next_size
                return False
        return self._transcribe_current_buffer()

    def _transcribe_current_buffer(self, force: bool = False) -> bool:
        if len(self._buffer) < SAMPLE_RATE and not force:
            return False
        if len(self._buffer) == 0:
            return False
        self.state.last_buffer_size = len(self._buffer)
        confirm_point = (
            self.state.last_agreed_seconds - self.eager_tolerance_seconds
            if self.eager
            else self.state.last_confirmed_segment_end_seconds
        )
        # absolute → buffer-relative clip
        clip_rel = confirm_point - self._dropped_seconds
        clip_rel = max(0.0, min(clip_rel, len(self._buffer) / SAMPLE_RATE - 0.1))
        options = dataclasses.replace(self.options, clip_timestamps=[clip_rel])
        result = self.pipeline.transcribe(
            self._buffer, options, callback=self._on_progress
        )
        if self._dropped_seconds > 0:
            result.segments = [
                update_segment_timings(s, self._dropped_seconds)
                for s in result.segments
            ]
        self.state.current_text = result.text
        if self.eager:
            self._confirm_words(result)
        else:
            self._confirm_segments(result.segments)
        self._trim_buffer(confirm_point)
        if self.state_callback is not None:
            self.state_callback(self.state)
        return True

    def _on_progress(self, progress: TranscriptionProgress):
        """Per-window progress during a pass: mirror the reference's
        decodingCallback (AudioStreamTranscriber.swift:195-206) — update
        live text/fallback state and abort the pass on quality collapse.
        Returning False cancels the REMAINING windows of this pass (window
        granularity; the reference breaks its token loop mid-window) — the
        next pass re-transcribes from the last confirmed point anyway."""
        self.state.current_text = progress.text
        self.state.current_fallbacks = int(
            progress.timings.total_decoding_fallbacks
        )
        return self._should_stop_early(progress)

    def _should_stop_early(self, progress: TranscriptionProgress):
        """Reference: AudioStreamTranscriber.shouldStopEarly (:208-227) —
        stop when the tail of the token stream stops compressing (looping)
        or the window's average logprob falls below threshold."""
        tokens = progress.tokens
        if len(tokens) > self.compression_check_window:
            ratio = compression_ratio_tokens(
                tokens[-self.compression_check_window :]
            )
            if ratio > (self.options.compression_ratio_threshold or 0.0):
                return False
        if (
            progress.avg_logprob is not None
            and self.options.logprob_threshold is not None
            and progress.avg_logprob < self.options.logprob_threshold
        ):
            return False
        return None

    def _trim_buffer(self, confirm_point: float) -> None:
        """Drop samples that can no longer affect output (bounded memory)."""
        keep_from = confirm_point - 2.0  # safety margin before the clip point
        drop = int((keep_from - self._dropped_seconds) * SAMPLE_RATE)
        if drop > SAMPLE_RATE:  # only trim in >=1 s steps
            drop = min(drop, len(self._buffer))
            self._buffer = self._buffer[drop:]
            self._dropped_seconds += drop / SAMPLE_RATE
            self.state.last_buffer_size = max(
                0, self.state.last_buffer_size - drop
            )

    # -- confirmation -------------------------------------------------------

    def _confirm_segments(self, segments: list[TranscriptionSegment]) -> None:
        """Confirm all but the last N segments (reference :169-192)."""
        n = self.required_segments_for_confirmation
        if len(segments) > n:
            to_confirm = segments[:-n]
            for seg in to_confirm:
                if seg.end > self.state.last_confirmed_segment_end_seconds:
                    self.state.last_confirmed_segment_end_seconds = seg.end
                    if seg not in self.state.confirmed_segments:
                        self.state.confirmed_segments.append(seg)
            self.state.unconfirmed_segments = segments[-n:]
        else:
            self.state.unconfirmed_segments = segments

    def _confirm_words(self, result) -> None:
        """Eager word-prefix confirmation (TranscribeCLI.swift:322-430):
        the longest common prefix of consecutive hypotheses is committed;
        decoding restarts just before the last agreed word. Words at or
        before last_agreed_seconds are already confirmed and must be
        dropped first (re-decoding starts `tolerance` earlier, so the new
        hypothesis re-includes them)."""
        current = [
            w
            for s in result.segments
            for w in (s.words or [])
            if w.start >= self.state.last_agreed_seconds - 1e-6
        ]
        prefix = find_longest_common_prefix(self.state.hypothesis_words, current)
        if prefix:
            self.state.confirmed_words.extend(prefix)
            self.state.last_agreed_seconds = prefix[-1].end
            current = current[len(prefix):]
        self.state.hypothesis_words = current

    @property
    def confirmed_text(self) -> str:
        if self.eager:
            return "".join(w.word for w in self.state.confirmed_words)
        return "".join(s.text for s in self.state.confirmed_segments)


def simulate_stream(
    audio: np.ndarray, chunk_seconds: float = 1.0
) -> Iterator[np.ndarray]:
    """Replay an array as a stream of fixed-size chunks (the CLI's
    --stream-simulated source)."""
    step = int(chunk_seconds * SAMPLE_RATE)
    for i in range(0, len(audio), step):
        yield audio[i : i + step]
