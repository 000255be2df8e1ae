"""Transcription result helpers (the port's copy of
whisperkit_tpu/text/transcription_utils.py).

Reference: Sources/WhisperKit/Utilities/TranscriptionUtilities.swift:16-157 —
`formatSegments`, `findLongestCommonPrefix` (streaming word confirmation),
`findLongestDifferentSuffix`, `updateSegmentTimings`, and
`mergeTranscriptionResults`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from whisperkit_tpu_torch.core.results import (
    TranscriptionResult,
    TranscriptionSegment,
    WordTiming,
)
from whisperkit_tpu_torch.core.timings import TranscriptionTimings


def format_segments(segments: Sequence[TranscriptionSegment], with_timestamps: bool = True) -> list[str]:
    out = []
    for seg in segments:
        if with_timestamps:
            out.append(f"[{seg.start:.2f} --> {seg.end:.2f}] {seg.text}")
        else:
            out.append(seg.text)
    return out


def _words_equal(a: WordTiming, b: WordTiming) -> bool:
    return a.word.strip().lower() == b.word.strip().lower()


def find_longest_common_prefix(
    previous: Sequence[WordTiming], current: Sequence[WordTiming]
) -> list[WordTiming]:
    """Longest common word prefix of two hypotheses (case/whitespace-
    insensitive). Used by eager streaming to confirm words.

    Reference: TranscriptionUtilities.swift `findLongestCommonPrefix`.
    """
    out: list[WordTiming] = []
    for a, b in zip(previous, current):
        if not _words_equal(a, b):
            break
        out.append(b)
    return out


def find_longest_different_suffix(
    previous: Sequence[WordTiming], current: Sequence[WordTiming]
) -> list[WordTiming]:
    prefix = len(find_longest_common_prefix(previous, current))
    return list(current[prefix:])


def update_segment_timings(
    segment: TranscriptionSegment, seek_offset_seconds: float
) -> TranscriptionSegment:
    """Re-base one segment's times by a chunk's seek offset.

    Reference: TranscriptionUtilities.swift `updateSegmentTimings` /
    AudioChunker.swift:14-39 `updateSeekOffsetsForResults`.
    """
    seg = dataclasses.replace(segment)
    seg.seek += int(seek_offset_seconds * 100)
    seg.start += seek_offset_seconds
    seg.end += seek_offset_seconds
    if segment.words:
        seg.words = [
            dataclasses.replace(w, start=w.start + seek_offset_seconds, end=w.end + seek_offset_seconds)
            for w in segment.words
        ]
    return seg


def merge_transcription_results(
    results: Sequence[Optional[TranscriptionResult]],
    confirmed_words: Optional[Sequence[WordTiming]] = None,
) -> TranscriptionResult:
    """Merge per-chunk results into one, de-overlapping concurrent timings.

    Reference: TranscriptionUtilities.swift `mergeTranscriptionResults`.
    """
    valid = [r for r in results if r is not None]
    if confirmed_words is not None:
        text = "".join(w.word for w in confirmed_words)
    else:
        text = " ".join(r.text for r in valid if r.text)

    segments: list[TranscriptionSegment] = []
    for r in valid:
        segments.extend(r.segments)
    segments.sort(key=lambda s: (s.start, s.end))
    for i, seg in enumerate(segments):
        seg.id = i

    merged_timings = TranscriptionTimings()
    for r in valid:
        t = r.timings
        merged_timings.model_loading = max(merged_timings.model_loading, t.model_loading)
        merged_timings.audio_loading += t.audio_loading
        merged_timings.audio_processing += t.audio_processing
        merged_timings.log_mels += t.log_mels
        merged_timings.encoding += t.encoding
        merged_timings.decoding_loop += t.decoding_loop
        merged_timings.full_pipeline += t.full_pipeline
        merged_timings.total_decoding_loops += t.total_decoding_loops
        merged_timings.total_decoding_windows += t.total_decoding_windows
        merged_timings.total_encoding_runs += t.total_encoding_runs
        merged_timings.total_log_mel_runs += t.total_log_mel_runs
        merged_timings.input_audio_seconds += t.input_audio_seconds

    return TranscriptionResult(
        text=text.strip(),
        segments=segments,
        language=valid[0].language if valid else "en",
        timings=merged_timings,
    )
