"""Diarization result types: segments, RTTM, transcript merging (the
port's copy of whisperkit_tpu/speaker/results.py).

Reference: Sources/SpeakerKit/ — `DiarizationResult.swift` (binary
speaker×frame matrix → segments with gap merging :56-102; `addSpeakerInfo`
merge strategies :106-115), `SpeakerSegment.swift`, `SpeakerInfo.swift`,
`RTTMLine.swift`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from whisperkit_tpu_torch.core.results import TranscriptionResult, TranscriptionSegment


@dataclasses.dataclass
class SpeakerSegment:
    speaker_id: int
    start: float
    end: float

    @property
    def duration(self) -> float:
        return self.end - self.start

    @property
    def label(self) -> str:
        return f"SPEAKER_{self.speaker_id:02d}"


@dataclasses.dataclass
class SpeakerInfo:
    speaker_id: int
    label: str


@dataclasses.dataclass
class RTTMLine:
    """One RTTM record (reference: RTTMLine.swift)."""

    file_id: str
    start: float
    duration: float
    speaker: str

    def render(self) -> str:
        return (
            f"SPEAKER {self.file_id} 1 {self.start:.3f} {self.duration:.3f} "
            f"<NA> <NA> {self.speaker} <NA> <NA>"
        )


class SpeakerMergeStrategy(str, enum.Enum):
    """Reference: addSpeakerInfo strategies (DiarizationResult.swift:106)."""

    SEGMENT = "segment"  # label whole transcript segments by IoU
    SUBSEGMENT = "subsegment"  # split segments at word gaps, label pieces


@dataclasses.dataclass
class DiarizationResult:
    """speaker×frame activity → time segments."""

    segments: list[SpeakerSegment]
    num_speakers: int
    frame_seconds: float = 0.0  # seconds per activity frame
    timings: Optional[dict] = None

    @classmethod
    def from_activity_matrix(
        cls,
        activity: np.ndarray,  # [n_speakers, n_frames] binary
        frame_seconds: float,
        min_active_offset: float = 1.0,
    ) -> "DiarizationResult":
        """Reference: DiarizationResult.updateSegments (:56-102) — runs of
        active frames become segments; gaps shorter than
        `min_active_offset` seconds are merged."""
        segments: list[SpeakerSegment] = []
        n_speakers = activity.shape[0]
        for spk in range(n_speakers):
            row = activity[spk].astype(bool)
            runs = _runs(row)
            merged: list[list[float]] = []
            for s, e in runs:
                start_t, end_t = s * frame_seconds, e * frame_seconds
                if merged and start_t - merged[-1][1] < min_active_offset:
                    merged[-1][1] = end_t
                else:
                    merged.append([start_t, end_t])
            segments.extend(SpeakerSegment(spk, s, e) for s, e in merged)
        segments.sort(key=lambda x: (x.start, x.speaker_id))
        return cls(
            segments=segments, num_speakers=n_speakers, frame_seconds=frame_seconds
        )

    def speaker_at(self, start: float, end: float) -> Optional[int]:
        """Speaker with the largest overlap with [start, end)."""
        best, best_ov = None, 0.0
        for seg in self.segments:
            ov = min(end, seg.end) - max(start, seg.start)
            if ov > best_ov:
                best, best_ov = seg.speaker_id, ov
        return best

    # -- RTTM ---------------------------------------------------------------

    def to_rttm(self, file_id: str = "audio") -> str:
        """Reference: SpeakerKit.generateRTTM (SpeakerKit.swift:80-108)."""
        lines = [
            RTTMLine(file_id, s.start, s.duration, s.label).render()
            for s in self.segments
        ]
        return "\n".join(lines) + ("\n" if lines else "")

    @staticmethod
    def rttm_from_words(
        result: TranscriptionResult, file_id: str = "audio"
    ) -> str:
        """Word-aligned RTTM from a diarization-merged transcript
        (reference: RTTMLine.fromWords)."""
        lines = []
        for seg in result.segments:
            speaker = getattr(seg, "speaker", None) or "SPEAKER_00"
            lines.append(
                RTTMLine(file_id, seg.start, seg.end - seg.start, speaker).render()
            )
        return "\n".join(lines) + ("\n" if lines else "")

    # -- transcript merging -------------------------------------------------

    def add_speaker_info(
        self,
        result: TranscriptionResult,
        strategy: SpeakerMergeStrategy = SpeakerMergeStrategy.SEGMENT,
    ) -> TranscriptionResult:
        """Attach speaker labels to transcription segments.

        Reference: DiarizationResult.addSpeakerInfo(to:)
        (DiarizationResult.swift:106-115): `.segment` labels each transcript
        segment by max overlap; `.subsegment` splits segments at word gaps
        and labels each piece.
        """
        if strategy == SpeakerMergeStrategy.SEGMENT:
            for seg in result.segments:
                spk = self.speaker_at(seg.start, seg.end)
                seg.speaker = f"SPEAKER_{spk:02d}" if spk is not None else None
            return result

        # subsegment: split at word gaps > 1 s and label pieces
        new_segments: list[TranscriptionSegment] = []
        for seg in result.segments:
            if not seg.words:
                spk = self.speaker_at(seg.start, seg.end)
                seg.speaker = f"SPEAKER_{spk:02d}" if spk is not None else None
                new_segments.append(seg)
                continue
            groups: list[list] = [[]]
            for w in seg.words:
                if groups[-1] and w.start - groups[-1][-1].end > 1.0:
                    groups.append([])
                groups[-1].append(w)
            for gi, group in enumerate(g for g in groups if g):
                sub = dataclasses.replace(
                    seg,
                    id=len(new_segments),
                    start=group[0].start,
                    end=group[-1].end,
                    text="".join(w.word for w in group),
                    words=list(group),
                )
                spk = self.speaker_at(sub.start, sub.end)
                sub.speaker = f"SPEAKER_{spk:02d}" if spk is not None else None
                new_segments.append(sub)
        result.segments = new_segments
        return result


def _runs(mask: np.ndarray) -> list[tuple[int, int]]:
    """[start, end) index pairs of True runs."""
    if not mask.any():
        return []
    padded = np.concatenate([[False], mask, [False]])
    diff = np.diff(padded.astype(np.int8))
    starts = np.nonzero(diff == 1)[0]
    ends = np.nonzero(diff == -1)[0]
    return list(zip(starts.tolist(), ends.tolist()))
