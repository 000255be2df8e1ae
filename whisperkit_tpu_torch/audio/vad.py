"""Voice activity detection on a fixed frame grid (the port's copy of
whisperkit_tpu/audio/vad.py, trimmed to what the VAD chunker and
streaming use).

Reference: Sources/WhisperKit/Core/Audio/VoiceActivityDetector.swift (base
frame-grid ops, :37-162) and EnergyVAD.swift (:7-57) — 0.1 s frames with an
RMS-energy threshold of 0.02.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from whisperkit_tpu_torch.audio.io import SAMPLE_RATE, energy_per_frame


class VoiceActivityDetector:
    """Base class: maps per-frame boolean activity to chunk/seek utilities."""

    def __init__(self, sample_rate: int = SAMPLE_RATE, frame_length_samples: int = 1600):
        self.sample_rate = sample_rate
        self.frame_length_samples = frame_length_samples

    # subclasses implement
    def voice_activity(self, waveform: np.ndarray) -> np.ndarray:
        """Return boolean array: one entry per frame."""
        raise NotImplementedError

    def find_longest_silence(self, activity: Sequence[bool]) -> Optional[tuple[int, int]]:
        """Longest run of inactive frames as (start_frame, end_frame_exclusive).

        Reference: VoiceActivityDetector.swift:95-125.
        """
        best: Optional[tuple[int, int]] = None
        start: Optional[int] = None
        n = len(activity)
        for i in range(n + 1):
            inactive = i < n and not activity[i]
            if inactive and start is None:
                start = i
            elif not inactive and start is not None:
                if best is None or (i - start) > (best[1] - best[0]):
                    best = (start, i)
                start = None
        return best

    def voice_activity_index_to_sample(self, index: int) -> int:
        return index * self.frame_length_samples


class EnergyVAD(VoiceActivityDetector):
    """RMS-energy-threshold VAD (reference: EnergyVAD.swift:7-57).

    Defaults: 0.1 s frames at 16 kHz (1600 samples), threshold 0.02.
    """

    def __init__(
        self,
        sample_rate: int = SAMPLE_RATE,
        frame_length_seconds: float = 0.1,
        energy_threshold: float = 0.02,
    ):
        super().__init__(sample_rate, int(frame_length_seconds * sample_rate))
        self.energy_threshold = energy_threshold

    def voice_activity(self, waveform: np.ndarray) -> np.ndarray:
        if waveform.size == 0:
            return np.zeros(0, dtype=bool)
        energies = energy_per_frame(waveform, self.frame_length_samples)
        return energies > self.energy_threshold


def is_voice_detected(
    waveform: np.ndarray,
    next_buffer_seconds: float = 1.0,
    silence_threshold: float = 0.02,
    sample_rate: int = SAMPLE_RATE,
) -> bool:
    """Is there voice in the last `next_buffer_seconds` of the buffer?

    Reference: AudioProcessor.swift:636-655 `isVoiceDetected`.
    """
    n = int(next_buffer_seconds * sample_rate)
    tail = waveform[-n:] if n < waveform.shape[0] else waveform
    vad = EnergyVAD(sample_rate=sample_rate, energy_threshold=silence_threshold)
    return bool(vad.voice_activity(tail).any())
