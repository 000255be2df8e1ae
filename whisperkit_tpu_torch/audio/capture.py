"""Live microphone capture source for streaming transcription (the port's
copy of whisperkit_tpu/audio/capture.py).

Reference: Sources/WhisperKit/Core/Audio/AudioProcessor.swift —
AVAudioEngine input tap with 100 ms buffers, resample to 16 kHz, energy
tracking, pause/resume, device enumeration (:904-1114). On Linux hosts the
capture backend is PortAudio via `sounddevice` (optional); the yielded
chunks plug straight into `AudioStreamTranscriber.stream()`.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from whisperkit_tpu_torch.audio.io import SAMPLE_RATE, resample_audio


def capture_available() -> bool:
    try:
        import sounddevice  # noqa: F401

        return True
    except Exception:
        return False


def list_capture_devices() -> list[dict]:
    """Reference: AudioProcessor device enumeration (CoreAudio)."""
    import sounddevice

    return [
        {"index": i, "name": d["name"], "channels": d["max_input_channels"]}
        for i, d in enumerate(sounddevice.query_devices())
        if d["max_input_channels"] > 0
    ]


class MicrophoneSource:
    """Iterator of 16 kHz float32 chunks from the default input device.

    100 ms buffers like the reference's tap; `pause()`/`resume()` mirror
    AudioProcessor's input suppression; `stop()` ends the iterator.
    """

    def __init__(
        self,
        device: Optional[int] = None,
        chunk_seconds: float = 0.1,
        capture_rate: Optional[int] = None,
    ):
        if not capture_available():
            raise RuntimeError(
                "microphone capture needs the sounddevice (PortAudio) backend"
            )
        import sounddevice

        self._sd = sounddevice
        self.device = device
        info = sounddevice.query_devices(device, "input")
        self.capture_rate = capture_rate or int(info["default_samplerate"])
        self.chunk_frames = int(chunk_seconds * self.capture_rate)
        # bounded: ~60 s of backlog; drop-oldest if the consumer stalls
        # (same bounded-buffer policy as pipelines/streaming.py)
        self._queue: queue.Queue = queue.Queue(maxsize=int(60 / chunk_seconds))
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._stream = None

    def _callback(self, indata, frames, time_info, status):
        if self._paused.is_set():
            return
        mono = np.asarray(indata, np.float32).mean(axis=1)
        if self.capture_rate != SAMPLE_RATE:
            mono = resample_audio(mono, self.capture_rate, SAMPLE_RATE)
        try:
            self._queue.put_nowait(mono)
        except queue.Full:  # consumer stalled: drop the oldest chunk
            try:
                self._queue.get_nowait()
            except queue.Empty:
                pass
            try:
                self._queue.put_nowait(mono)
            except queue.Full:
                pass

    def start(self) -> "MicrophoneSource":
        self._stream = self._sd.InputStream(
            device=self.device,
            samplerate=self.capture_rate,
            blocksize=self.chunk_frames,
            channels=1,
            callback=self._callback,
        )
        self._stream.start()
        return self

    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def stop(self) -> None:
        self._stop.set()
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._stream is None:
            self.start()
        while not self._stop.is_set():
            try:
                yield self._queue.get(timeout=0.5)
            except queue.Empty:
                continue
