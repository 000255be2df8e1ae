"""Word-level timestamps: alignment-head DTW + the openai timing heuristics
(the port's copy of whisperkit_tpu/text/word_timestamps.py).

Reference: Sources/WhisperKit/Core/Text/SegmentSeeker.swift —
`dynamicTimeWarping` (:194-278), `mergePunctuations` (:280-338),
`findAlignment` (:340-408), `addWordTimestamps` (:410-496),
`calculateWordDurationConstraints`/`truncateLongWordsAtSentenceBoundaries`
(:498-526), `updateSegmentsWithWordTimings` (:528-659). Those in turn port
openai/whisper timing.py, including its documented "hack" heuristics.

The alignment weights come out of the decode loop (cross-attention probs
of the alignment heads, captured at every step — decoding/loop.py), so the
only host work here is the DTW + bookkeeping. The DTW is vectorized over
anti-diagonals in NumPy (the classic wavefront trick) — the ~230×1500 matrix
costs ~1700 small vector ops instead of 345k Python iterations.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from whisperkit_tpu_torch.core.results import TranscriptionSegment, WordTiming

# Constants.defaultPrependPunctuations / defaultAppendPunctuations
# (Models.swift:1459-1460)
PREPEND_PUNCTUATIONS = "\"'“¿([{-"
APPEND_PUNCTUATIONS = "\"'.。,，!！?？:：”)]}、"
SECONDS_PER_TIME_TOKEN = 0.02
MEDFILT_WIDTH = 7


def median_filter(x: np.ndarray, width: int = MEDFILT_WIDTH) -> np.ndarray:
    """Median filter along the last axis with edge padding (openai
    timing.py `median_filter`)."""
    if width <= 1 or x.shape[-1] <= width:
        return x
    pad = width // 2
    padded = np.concatenate(
        [x[..., :1].repeat(pad, -1), x, x[..., -1:].repeat(pad, -1)], axis=-1
    )
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW over cost matrix [N, M] → (text_indices, time_indices).

    Reference: SegmentSeeker.swift:194-278. Wavefront-vectorized: cells on
    anti-diagonal d depend only on diagonals d-1 and d-2.
    """
    n, m = cost.shape
    big = np.float64(np.inf)
    c = np.full((n + 1, m + 1), big)
    trace = np.full((n + 1, m + 1), -1, np.int8)
    c[0, 0] = 0.0
    trace[0, 1:] = 2
    trace[1:, 0] = 1

    cost64 = cost.astype(np.float64)
    for d in range(2, n + m + 1):
        i_lo = max(1, d - m)
        i_hi = min(n, d - 1)
        if i_lo > i_hi:
            continue
        i = np.arange(i_lo, i_hi + 1)
        j = d - i
        diag = c[i - 1, j - 1]
        up = c[i - 1, j]
        left = c[i, j - 1]
        val = cost64[i - 1, j - 1]
        best = np.minimum(diag, np.minimum(up, left))
        c[i, j] = best + val
        # trace encoding matches the reference: 0=diag, 1=up, 2=left, with
        # ties resolved toward "left" like minCostAndTrace's strict <
        t = np.full(i.shape, 2, np.int8)
        t[(up < diag) & (up < left)] = 1
        t[(diag < up) & (diag < left)] = 0
        trace[i, j] = t

    # backtrace
    i, j = n, m
    text_idx, time_idx = [], []
    while i > 0 or j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(text_idx[::-1]), np.asarray(time_idx[::-1])


def find_alignment(
    word_token_ids: Sequence[int],
    alignment_weights: np.ndarray,  # [T_text, F] processed matrix
    token_logprobs: Sequence[float],
    tokenizer,
    language: str,
) -> list[WordTiming]:
    """Reference: SegmentSeeker.swift:340-408 `findAlignment`."""
    text_indices, time_indices = dtw(-alignment_weights)
    words, word_tokens = tokenizer.split_to_word_tokens(list(word_token_ids), language)
    if len(word_tokens) <= 1:
        return []

    start_times = [0.0]
    end_times: list[float] = []
    current = text_indices[0] if len(text_indices) else 0
    for k in range(len(text_indices)):
        if text_indices[k] != current:
            current = text_indices[k]
            t = float(time_indices[k]) * SECONDS_PER_TIME_TOKEN
            start_times.append(t)
            end_times.append(t)
    end_times.append(
        float(time_indices[-1] if len(time_indices) else 1500) * SECONDS_PER_TIME_TOKEN
    )

    timings: list[WordTiming] = []
    idx = 0
    lps = list(token_logprobs)
    for word, toks in zip(words, word_tokens):
        start_index = idx
        start = start_times[min(idx, len(start_times) - 1)]
        idx += len(toks) - 1
        end = end_times[min(idx, len(end_times) - 1)]
        idx += 1
        probs = lps[start_index:idx]
        probability = float(np.exp(sum(probs) / max(len(probs), 1))) if probs else 0.0
        timings.append(
            WordTiming(word=word, tokens=list(toks), start=start, end=end, probability=probability)
        )
    return timings


def merge_punctuations(
    alignment: list[WordTiming],
    prepended: str = PREPEND_PUNCTUATIONS,
    appended: str = APPEND_PUNCTUATIONS,
) -> list[WordTiming]:
    """Reference: SegmentSeeker.swift:280-338."""
    if not alignment:
        return []
    pre: list[WordTiming] = []
    if alignment[0].word.strip() not in prepended:
        pre.append(alignment[0])
    for i in range(1, len(alignment)):
        cur = alignment[i]
        prev = alignment[i - 1]
        if prev.word[:1].isspace() and prev.word.strip() in prepended:
            merged = WordTiming(
                word=prev.word + cur.word,
                tokens=prev.tokens + cur.tokens,
                start=cur.start,
                end=cur.end,
                probability=cur.probability,
            )
            if pre:
                pre[-1] = merged
            else:
                pre.append(merged)
        else:
            pre.append(cur)

    out: list[WordTiming] = []
    if pre:
        out.append(pre[0])
    for i in range(1, len(pre)):
        cur = pre[i]
        prev = out[-1]
        if not prev.word.endswith(" ") and cur.word.strip() in appended:
            out[-1] = WordTiming(
                word=prev.word + cur.word,
                tokens=prev.tokens + cur.tokens,
                start=prev.start,
                end=prev.end,
                probability=prev.probability,
            )
        else:
            out.append(cur)
    return [
        w
        for w in out
        if w.word and w.word not in appended and w.word not in prepended
    ]


def _round2(x: float) -> float:
    return round(x, 2)


def add_word_timestamps(
    *,
    segments: list[TranscriptionSegment],
    alignment: np.ndarray,  # [T_buffer, A, 1500] probs (prompt+sampled rows)
    sample_begin: int,
    tokens: Sequence[int],  # sampled tokens (no prompt/EOT)
    tokenizer,
    language: str,
    time_offset: float,
    window_frames: int,
    last_speech_timestamp: float = 0.0,
) -> list[TranscriptionSegment]:
    """Reference: SegmentSeeker.swift:410-496 `addWordTimestamps`."""
    if not segments or alignment is None:
        return segments
    sp = tokenizer.special

    # Collect token ids + logprobs + their row indices in the decode buffer.
    word_token_ids: list[int] = []
    logprobs: list[float] = []
    rows: list[int] = []
    offset = 0
    for seg in segments:
        for k, tok in enumerate(seg.tokens):
            word_token_ids.append(tok)
            rows.append(sample_begin + offset + k)
            lp = seg.token_log_probs[k].get(tok, 0.0) if k < len(seg.token_log_probs) else 0.0
            logprobs.append(lp)
        offset += len(seg.tokens)

    rows_arr = [r for r in rows if r < alignment.shape[0]]
    if len(rows_arr) < len(rows):
        word_token_ids = word_token_ids[: len(rows_arr)]
        logprobs = logprobs[: len(rows_arr)]
    if not rows_arr:
        return segments

    weights = alignment[rows_arr]  # [T_text, A, 1500]
    n_frames = max(2, window_frames // 2)
    weights = weights[:, :, :n_frames].transpose(1, 0, 2)  # [A, T, F]

    # openai timing.py normalization: per-head standardize over tokens, then
    # median filter over time, then mean over heads.
    mean = weights.mean(axis=1, keepdims=True)
    std = weights.std(axis=1, keepdims=True) + 1e-8
    weights = (weights - mean) / std
    weights = median_filter(weights)
    matrix = weights.mean(axis=0)  # [T_text, F]

    align = find_alignment(word_token_ids, matrix, logprobs, tokenizer, language)

    med, mx = calculate_word_duration_constraints(align)
    align = truncate_long_words_at_sentence_boundaries(align, mx)
    if align:
        align = merge_punctuations(align)

    return update_segments_with_word_timings(
        segments=segments,
        merged_alignment=align,
        time_offset=time_offset,
        last_speech_timestamp=last_speech_timestamp,
        constrained_median_duration=med,
        max_duration=mx,
        tokenizer=tokenizer,
    )


def calculate_word_duration_constraints(alignment: list[WordTiming]) -> tuple[float, float]:
    """Reference: SegmentSeeker.swift:498-509."""
    durations = sorted(w.duration for w in alignment if w.duration > 0)
    median = durations[len(durations) // 2] if durations else 0.0
    constrained = min(0.7, median)
    return constrained, constrained * 2


_SENTENCE_END = {".", "。", "!", "！", "?", "？"}


def truncate_long_words_at_sentence_boundaries(
    alignment: list[WordTiming], max_duration: float
) -> list[WordTiming]:
    """Reference: SegmentSeeker.swift:511-526."""
    out = list(alignment)
    for i in range(1, len(out)):
        if out[i].duration > max_duration:
            if out[i].word in _SENTENCE_END:
                out[i] = dataclasses.replace(out[i], end=out[i].start + max_duration)
            elif out[i - 1].word in _SENTENCE_END:
                out[i] = dataclasses.replace(out[i], start=out[i].end - max_duration)
    return out


def update_segments_with_word_timings(
    *,
    segments: list[TranscriptionSegment],
    merged_alignment: list[WordTiming],
    time_offset: float,
    last_speech_timestamp: float,
    constrained_median_duration: float,
    max_duration: float,
    tokenizer,
) -> list[TranscriptionSegment]:
    """Reference: SegmentSeeker.swift:528-659."""
    sp = tokenizer.special
    word_index = 0
    last_ts = last_speech_timestamp
    updated: list[TranscriptionSegment] = []

    for seg_index, segment in enumerate(segments):
        saved = 0
        text_tokens = [t for t in segment.tokens if t < sp.eot]
        words_in_segment: list[WordTiming] = []

        while word_index < len(merged_alignment) and saved < len(text_tokens):
            timing = merged_alignment[word_index]
            word_index += 1
            timing_tokens = [t for t in timing.tokens if t < sp.eot]
            if not timing_tokens:
                continue
            word = (
                tokenizer.decode(timing_tokens)
                if len(timing_tokens) < len(timing.tokens)
                else timing.word
            )
            start = _round2(time_offset + timing.start)
            end = _round2(time_offset + timing.end)

            # short-word start adjustment (reference :565-596)
            if end - start < constrained_median_duration / 4:
                if words_in_segment:
                    prev_end = words_in_segment[-1].end
                    if start > prev_end:
                        space = start - prev_end
                        start = _round2(start - min(space, constrained_median_duration / 2))
                elif not words_in_segment and seg_index > 0 and updated and start > updated[seg_index - 1].end:
                    space = start - updated[seg_index - 1].end
                    start = _round2(start - min(space, constrained_median_duration / 2))

            words_in_segment.append(
                WordTiming(
                    word=word,
                    tokens=timing_tokens,
                    start=start,
                    end=end,
                    probability=_round2(timing.probability),
                )
            )
            saved += len(timing_tokens)

        new_seg = dataclasses.replace(segment)
        if words_in_segment:
            first = words_in_segment[0]
            # long-first-word after pause hack (reference :604-625)
            pause = first.end - last_ts
            first_too_long = first.duration > max_duration
            both_too_long = (
                len(words_in_segment) > 1
                and words_in_segment[1].end - first.start > max_duration * 2
            )
            if pause > constrained_median_duration * 4 and (first_too_long or both_too_long):
                if len(words_in_segment) > 1 and words_in_segment[1].duration > max_duration:
                    boundary = max(
                        words_in_segment[1].end / 2,
                        words_in_segment[1].end - max_duration,
                    )
                    words_in_segment[0] = dataclasses.replace(words_in_segment[0], end=boundary)
                    words_in_segment[1] = dataclasses.replace(words_in_segment[1], start=boundary)
                words_in_segment[0] = dataclasses.replace(
                    words_in_segment[0],
                    start=max(last_ts, words_in_segment[0].end - max_duration),
                )
            first = words_in_segment[0]

            # prefer segment-level boundaries when words look wrong (:627-645)
            if segment.start < first.end and segment.start - 0.5 > first.start:
                words_in_segment[0] = dataclasses.replace(
                    words_in_segment[0],
                    start=max(0.0, min(first.end - constrained_median_duration, segment.start)),
                )
            else:
                new_seg.start = first.start

            last = words_in_segment[-1]
            if new_seg.end > last.start and segment.end + 0.5 < last.end:
                words_in_segment[-1] = dataclasses.replace(
                    words_in_segment[-1],
                    end=max(last.start + constrained_median_duration, segment.end),
                )
            else:
                new_seg.end = last.end
            last_ts = new_seg.end

        new_seg.words = words_in_segment
        updated.append(new_seg)
    return updated
