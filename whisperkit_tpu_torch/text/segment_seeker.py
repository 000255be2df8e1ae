"""Timestamp-token pairing → segments + next seek point (the port's copy of
whisperkit_tpu/text/segment_seeker.py).

Reference: Sources/WhisperKit/Core/Text/SegmentSeeker.swift:41-189
(`findSeekPointAndSegments`), which follows openai/whisper's transcribe loop
semantics: windows are sliced at consecutive-timestamp boundaries; a
"single timestamp ending" consumes the whole window; seek advances to the
last paired timestamp, never backwards (TranscribeTask.swift:194).

This is host-side control logic on short int lists.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from whisperkit_tpu_torch.core.results import TranscriptionSegment
from whisperkit_tpu_torch.text.tokenizer import SpecialTokens

# 3000 mel frames / 30 s window → seek is measured in mel frames like the
# reference (TranscribeTask advances `seek` in units of 0.01 s frames).
FRAMES_PER_SECOND = 100
WINDOW_FRAMES = 3000
SAMPLES_PER_FRAME = 160


@dataclasses.dataclass
class SeekResult:
    seek_advance_frames: int  # how many mel frames the window consumed
    segments: list[TranscriptionSegment]


def find_seek_point_and_segments(
    *,
    tokens: Sequence[int],  # sampled tokens for this window (no prompt), may end with EOT
    token_logprobs: Sequence[float],
    special: SpecialTokens,
    time_offset: float,  # seconds at window start
    window_frames: int,  # frames of real audio in this window (<= 3000)
    seek: int,  # current absolute seek (mel frames)
    decode_fn,  # token list -> text (tokenizer.decode)
    temperature: float = 0.0,
    avg_logprob: float = 0.0,
    compression_ratio: float = 0.0,
    no_speech_prob: float = 0.0,
    segment_id_start: int = 0,
) -> SeekResult:
    ts_begin = special.timestamp_begin
    toks = [t for t in tokens if t != special.eot]
    lps = list(token_logprobs)[: len(toks)]

    is_ts = [t >= ts_begin for t in toks]
    single_timestamp_ending = len(toks) >= 2 and is_ts[-1] and not is_ts[-2]

    # indices i where toks[i-1] and toks[i] are both timestamps
    consecutive = [
        i for i in range(1, len(toks)) if is_ts[i] and is_ts[i - 1]
    ]

    segments: list[TranscriptionSegment] = []

    def make_segment(seg_tokens: list[int], seg_lps: list[float], sid: int) -> Optional[TranscriptionSegment]:
        ts_in = [t for t in seg_tokens if t >= ts_begin]
        if not ts_in:
            return None
        start_ts = special.timestamp_seconds(ts_in[0])
        end_ts = special.timestamp_seconds(ts_in[-1])
        text_tokens = [t for t in seg_tokens if t < special.eot]
        return TranscriptionSegment(
            id=sid,
            seek=seek,
            start=time_offset + start_ts,
            end=time_offset + end_ts,
            text=decode_fn(text_tokens),
            tokens=list(seg_tokens),
            token_log_probs=[
                {t: lp} for t, lp in zip(seg_tokens, seg_lps)
            ],
            temperature=temperature,
            avg_logprob=avg_logprob,
            compression_ratio=compression_ratio,
            no_speech_prob=no_speech_prob,
        )

    if consecutive:
        # slice at pair boundaries
        sid = segment_id_start
        last_slice = 0
        for boundary in consecutive:
            seg = make_segment(toks[last_slice:boundary], lps[last_slice:boundary], sid)
            if seg is not None:
                segments.append(seg)
                sid += 1
            last_slice = boundary
        if single_timestamp_ending:
            # trailing lone timestamp: the rest of the window is consumed
            seg = make_segment(toks[last_slice:], lps[last_slice:], sid)
            if seg is not None:
                segments.append(seg)
            seek_advance = window_frames
        else:
            last_ts = next(t for t in reversed(toks[:last_slice]) if t >= ts_begin)
            seek_advance = int(
                (last_ts - ts_begin) * 0.02 * FRAMES_PER_SECOND
            )
    else:
        # no paired timestamps: one segment spanning the window (or up to the
        # last timestamp if any), consume the whole window
        duration = window_frames / FRAMES_PER_SECOND
        ts_in = [t for t in toks if t >= ts_begin]
        if ts_in and ts_in[-1] != ts_begin:
            duration = special.timestamp_seconds(ts_in[-1])
        text_tokens = [t for t in toks if t < special.eot]
        segments.append(
            TranscriptionSegment(
                id=segment_id_start,
                seek=seek,
                start=time_offset,
                end=time_offset + duration,
                text=decode_fn(text_tokens),
                tokens=list(toks),
                token_log_probs=[{t: lp} for t, lp in zip(toks, lps)],
                temperature=temperature,
                avg_logprob=avg_logprob,
                compression_ratio=compression_ratio,
                no_speech_prob=no_speech_prob,
            )
        )
        seek_advance = window_frames

    # never advance backwards; always make progress (reference
    # TranscribeTask.swift:194 and the maxWindowSeek cap is applied by caller)
    seek_advance = max(1, min(seek_advance, window_frames))
    return SeekResult(seek_advance_frames=seek_advance, segments=segments)
