"""Transcription result value types (the port's copy of
whisperkit_tpu/core/results.py, trimmed to the types the pipeline returns).

Reference: Sources/WhisperKit/Core/Models.swift — `TranscriptionResult`
(:447-540), `TranscriptionSegment`/`WordTiming` (:574-641),
`TranscriptionProgress` (:643-683), `DecodingFallback` (:357-381).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from whisperkit_tpu_torch.core.timings import TranscriptionTimings


@dataclasses.dataclass
class WordTiming:
    word: str
    tokens: list[int]
    start: float
    end: float
    probability: float

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class TranscriptionSegment:
    id: int = 0
    seek: int = 0  # samples offset of the window this segment came from
    start: float = 0.0
    end: float = 0.0
    text: str = ""
    tokens: list[int] = dataclasses.field(default_factory=list)
    token_log_probs: list[dict[int, float]] = dataclasses.field(default_factory=list)
    temperature: float = 0.0
    avg_logprob: float = 0.0
    compression_ratio: float = 0.0
    no_speech_prob: float = 0.0
    words: Optional[list[WordTiming]] = None
    speaker: Optional[str] = None  # set by DiarizationResult.add_speaker_info
    # language the segment's window decoded with (per-window detection on
    # code-switched audio makes this vary within one result; the reference
    # records language per DecodingResult, Models.swift:383-439)
    language: Optional[str] = None


class FallbackReason(str, enum.Enum):
    COMPRESSION_RATIO = "compressionRatioThreshold"
    LOG_PROB = "logProbThreshold"
    SILENCE = "silence"
    FIRST_TOKEN_LOG_PROB = "firstTokenLogProbThreshold"


@dataclasses.dataclass
class DecodingFallback:
    """Whether/why a window needs re-decode at higher temperature.

    Reference: Models.swift:357-381 `DecodingFallback` — note the reference's
    rule ordering: a compression-ratio failure or logprob failure triggers a
    fallback UNLESS the no-speech probability says the window is silence, in
    which case decoding is accepted as silent.
    """

    need_fallback: bool
    fallback_reason: FallbackReason

    @staticmethod
    def evaluate(
        *,
        logprob_threshold: Optional[float],
        first_token_logprob_threshold: Optional[float],
        no_speech_threshold: Optional[float],
        compression_ratio_threshold: Optional[float],
        compression_ratio: float,
        avg_logprob: float,
        first_token_logprob: Optional[float],
        no_speech_prob: float,
    ) -> Optional["DecodingFallback"]:
        need = False
        reason = FallbackReason.SILENCE
        if compression_ratio_threshold is not None and compression_ratio > compression_ratio_threshold:
            need = True
            reason = FallbackReason.COMPRESSION_RATIO
        elif (
            first_token_logprob_threshold is not None
            and first_token_logprob is not None
            and first_token_logprob < first_token_logprob_threshold
        ):
            need = True
            reason = FallbackReason.FIRST_TOKEN_LOG_PROB
        elif logprob_threshold is not None and avg_logprob < logprob_threshold:
            need = True
            reason = FallbackReason.LOG_PROB
        if need and no_speech_threshold is not None and no_speech_prob > no_speech_threshold:
            # window is silence: accept as-is, skip fallback
            return DecodingFallback(need_fallback=False, fallback_reason=FallbackReason.SILENCE)
        if not need:
            return None
        return DecodingFallback(need_fallback=True, fallback_reason=reason)


@dataclasses.dataclass
class TranscriptionResult:
    text: str = ""
    segments: list[TranscriptionSegment] = dataclasses.field(default_factory=list)
    language: str = "en"
    timings: TranscriptionTimings = dataclasses.field(default_factory=TranscriptionTimings)
    seek_time: Optional[float] = None

    @property
    def all_words(self) -> list[WordTiming]:
        out: list[WordTiming] = []
        for seg in self.segments:
            if seg.words:
                out.extend(seg.words)
        return out


@dataclasses.dataclass
class TranscriptionProgress:
    """Streaming progress snapshot passed to per-token callbacks.

    Reference: Models.swift:643-683.
    """

    timings: TranscriptionTimings
    text: str = ""
    tokens: list[int] = dataclasses.field(default_factory=list)
    temperature: float = 0.0
    avg_logprob: Optional[float] = None
    compression_ratio: Optional[float] = None
    window_id: int = 0
    # batched VAD path only: windows are length-sorted into groups, so
    # window_id (original chunk index) arrives out of chronological order;
    # windows_decoded is the monotonically increasing progress count
    windows_decoded: int = 0
