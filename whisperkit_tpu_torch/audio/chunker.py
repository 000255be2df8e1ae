"""VAD-based audio chunking for long-form transcription (the port's copy of
whisperkit_tpu/audio/chunker.py, trimmed to `chunk_all`).

Reference: Sources/WhisperKit/Core/Audio/AudioChunker.swift — `chunkAll`
(:66-107), `splitOnMiddleOfLongestSilence` (:53-64). The chunks become a
batch dimension for one batched decode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from whisperkit_tpu_torch.audio.io import WINDOW_SAMPLES
from whisperkit_tpu_torch.audio.vad import EnergyVAD, VoiceActivityDetector


@dataclasses.dataclass
class AudioChunk:
    seek_offset_index: int  # sample offset of this chunk in the full audio
    audio_samples: np.ndarray


class VADAudioChunker:
    """Split audio into ≤30 s chunks at the middle of the longest silence."""

    def __init__(self, vad: Optional[VoiceActivityDetector] = None):
        self.vad = vad or EnergyVAD()

    def chunk_all(
        self,
        audio: np.ndarray,
        max_chunk_length: int = WINDOW_SAMPLES,
        min_chunk_length: int = 0,
    ) -> list[AudioChunk]:
        """Reference: AudioChunker.swift:66-107 `chunkAll`."""
        chunks: list[AudioChunk] = []
        start = 0
        n = int(audio.shape[0])
        while start < n:
            remaining = n - start
            if remaining <= max_chunk_length:
                chunks.append(AudioChunk(start, audio[start:n]))
                break
            window_end = start + max_chunk_length
            split = self._split_on_middle_of_longest_silence(audio, start, window_end)
            if split <= start + max(min_chunk_length, 0):
                split = window_end  # no usable silence: hard cut at window edge
            chunks.append(AudioChunk(start, audio[start:split]))
            start = split
        return chunks

    def _split_on_middle_of_longest_silence(
        self, audio: np.ndarray, start: int, window_end: int
    ) -> int:
        """Find the longest silence in the second half of [start, window_end)
        and return the sample index of its middle.

        Reference: AudioChunker.swift:53-64.
        """
        half = start + (window_end - start) // 2
        segment = audio[half:window_end]
        activity = self.vad.voice_activity(segment)
        silence = self.vad.find_longest_silence(list(activity))
        if silence is None:
            return window_end
        mid_frame = (silence[0] + silence[1]) // 2
        return half + self.vad.voice_activity_index_to_sample(mid_frame)
