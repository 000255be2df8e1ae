"""Audio output utilities: crossfade, WAV export, playback strategies (the
port's copy of whisperkit_tpu/audio/output.py, the whole module).

Reference: Sources/TTSKit/Utilities/AudioOutput.swift — equal-power
`crossfade` of chunk arrays (:292-353), WAV/M4A export (:227-272),
pre-buffer gating + playback strategies (`PlaybackStrategy` + required-
buffer math, TTSKit/Models.swift:144-218). Playback hardware is optional on
a server host: `play` uses `sounddevice` when importable and otherwise raises
with a pointer to `save_wav`.
"""

from __future__ import annotations

import enum
import wave
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np


class PlaybackStrategy(str, enum.Enum):
    """Reference: TTSKit/Models.swift:144-218."""

    AUTO = "auto"  # pre-buffer sized from first measured step time
    STREAM = "stream"  # play as chunks arrive
    BUFFERED = "buffered"  # wait for the full chunk
    GENERATE_FIRST = "generateFirst"  # synthesize everything, then play


def required_buffer_seconds(
    strategy: PlaybackStrategy,
    seconds_per_frame_generated: float,
    frame_seconds: float,
) -> float:
    """Pre-buffer needed so playback never starves.

    Reference: Models.swift `requiredBuffer` — if generation is slower than
    real time, buffer the shortfall; AUTO measures the first step.
    """
    if strategy == PlaybackStrategy.STREAM:
        return 0.0
    if strategy == PlaybackStrategy.GENERATE_FIRST:
        return float("inf")
    ratio = seconds_per_frame_generated / max(frame_seconds, 1e-9)
    if ratio <= 1.0:
        return 0.0
    # enough head start that (gen time - playback time) never goes negative
    return min(10.0, (ratio - 1.0) * 10.0)


def crossfade(
    chunks: Sequence[np.ndarray],
    sample_rate: int,
    crossfade_seconds: float = 0.1,
) -> np.ndarray:
    """Equal-power crossfade between consecutive chunks.

    Reference: AudioOutput.swift:292-353 (100 ms default, equal-power
    sin/cos ramps).
    """
    chunks = [np.asarray(c, np.float32) for c in chunks if len(c)]
    if not chunks:
        return np.zeros(0, np.float32)
    if len(chunks) == 1:
        return chunks[0]
    n_fade = int(crossfade_seconds * sample_rate)
    out = chunks[0]
    for nxt in chunks[1:]:
        fade = min(n_fade, len(out), len(nxt))
        if fade == 0:
            out = np.concatenate([out, nxt])
            continue
        t = np.linspace(0.0, np.pi / 2, fade, dtype=np.float32)
        fade_out = np.cos(t)
        fade_in = np.sin(t)
        blended = out[-fade:] * fade_out + nxt[:fade] * fade_in
        out = np.concatenate([out[:-fade], blended, nxt[fade:]])
    return out


def save_wav(
    samples: np.ndarray, path: Union[str, Path], sample_rate: int
) -> Path:
    """Reference: AudioOutput.swift:227-272 (WAV export branch)."""
    path = Path(path)
    pcm = (np.clip(np.asarray(samples, np.float32), -1.0, 1.0) * 32767).astype(
        np.int16
    )
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return path


def save_audio(
    samples: np.ndarray, path: Union[str, Path], sample_rate: int
) -> Path:
    """Format-inferring export: WAV natively, anything else (m4a/mp3/flac/
    ogg) through the ffmpeg binary (reference: AudioOutput's WAV/M4A(AAC)
    export, AudioOutput.swift:227-272)."""
    path = Path(path)
    if path.suffix.lower() in ("", ".wav"):
        return save_wav(samples, path, sample_rate)
    import shutil
    import subprocess
    import tempfile

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            f"exporting {path.suffix} needs the ffmpeg binary; use .wav instead"
        )
    with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
        save_wav(samples, tmp.name, sample_rate)
        subprocess.run(
            [ffmpeg, "-y", "-loglevel", "error", "-i", tmp.name, str(path)],
            check=True,
        )
    return path


def play(samples: np.ndarray, sample_rate: int) -> None:
    try:
        import sounddevice
    except ImportError as e:
        raise RuntimeError(
            "no audio playback backend on this host (sounddevice missing); "
            "use save_wav() instead"
        ) from e
    sounddevice.play(np.asarray(samples, np.float32), samplerate=sample_rate)
    sounddevice.wait()


class StreamingAudioOutput:
    """Non-blocking chunk-scheduled playback engine with pre-buffer gating.

    Reference: AudioOutput.swift:38-700 — `setBufferDuration` pre-buffer
    gating, chunk scheduling with fade-in/out, and `.auto` buffer sizing
    from the first measured generation step (TTSKit.swift:994-1063).

    Pull-based so it is testable without audio hardware: a sink (the
    sounddevice callback, or a test) calls `pull(n)` on its own clock while
    the generator thread calls `enqueue(chunk)`. Playback does not start
    until the buffer holds `required_buffer_seconds` of audio (or `finish`
    is called); an underrun pauses output and playback resumes with a
    fade-in once the buffer refills past the gate, exactly like the
    reference's scheduling engine.
    """

    def __init__(
        self,
        sample_rate: int,
        strategy: PlaybackStrategy = PlaybackStrategy.AUTO,
        fade_seconds: float = 0.005,
    ):
        import collections
        import threading

        self.sample_rate = sample_rate
        self.strategy = PlaybackStrategy(strategy)
        self._fade = max(1, int(fade_seconds * sample_rate))
        self._lock = threading.Lock()
        self._queue: collections.deque = collections.deque()
        self._queued = 0  # samples currently buffered
        self._required: Optional[float] = None  # seconds; None = unsized
        self._finished = False
        self._playing = False
        self._needs_fade_in = True
        # stats (observable by tests and the timing report)
        self.underruns = 0
        self.started_after_seconds: Optional[float] = None
        self.pulled_samples = 0

    # -- sizing ---------------------------------------------------------------

    def set_buffer_duration(self, seconds: float) -> None:
        """Explicit pre-buffer (reference `setBufferDuration`)."""
        with self._lock:
            self._required = max(0.0, float(seconds))

    def set_measured_step(
        self, seconds_per_frame_generated: float, frame_seconds: float
    ) -> None:
        """`.auto` sizing from the FIRST measured generation step
        (TTSKit.swift:994-1063); later calls don't resize."""
        with self._lock:
            if self.strategy != PlaybackStrategy.AUTO or self._required is not None:
                return
            self._required = required_buffer_seconds(
                self.strategy, seconds_per_frame_generated, frame_seconds
            )

    @property
    def required_buffer_seconds(self) -> float:
        if self.strategy == PlaybackStrategy.STREAM:
            return 0.0
        if self.strategy == PlaybackStrategy.GENERATE_FIRST:
            return float("inf")
        if self._required is not None:
            return self._required
        # AUTO before the first measurement, or BUFFERED: hold until sized/
        # first chunk respectively
        return float("inf") if self.strategy == PlaybackStrategy.AUTO else 0.0

    @property
    def buffered_seconds(self) -> float:
        return self._queued / self.sample_rate

    # -- producer side ----------------------------------------------------------

    def enqueue(self, chunk: np.ndarray) -> None:
        chunk = np.asarray(chunk, np.float32)
        if len(chunk) == 0:
            return
        with self._lock:
            self._queue.append(chunk)
            self._queued += len(chunk)

    def finish(self) -> None:
        """Generation done: the gate opens regardless of buffer fill."""
        with self._lock:
            self._finished = True

    # -- consumer side ----------------------------------------------------------

    def _gate_open(self) -> bool:
        if self._queued == 0:
            return False
        if self._finished:
            return True
        return self.buffered_seconds >= self.required_buffer_seconds

    def pull(self, n: int) -> np.ndarray:
        """Deliver n samples to the sink; silence while gated or starved.
        Fade-in is applied whenever output (re)starts from silence and a
        fade-out when the stream drains, so chunk scheduling never clicks."""
        out = np.zeros(n, np.float32)
        with self._lock:
            if not self._playing:
                if not self._gate_open():
                    return out  # still pre-buffering: silence, not underrun
                self._playing = True
                if self.started_after_seconds is None:
                    self.started_after_seconds = self.buffered_seconds
            filled = 0
            while filled < n and self._queue:
                head = self._queue[0]
                take = min(len(head), n - filled)
                out[filled : filled + take] = head[:take]
                if take == len(head):
                    self._queue.popleft()
                else:
                    self._queue[0] = head[take:]
                self._queued -= take
                filled += take
            if self._needs_fade_in and filled:
                ramp = min(self._fade, filled)
                out[:ramp] *= np.linspace(0.0, 1.0, ramp, dtype=np.float32)
                self._needs_fade_in = False
            if filled < n and filled:
                # drained mid-pull: fade the tail out
                ramp = min(self._fade, filled)
                out[filled - ramp : filled] *= np.linspace(
                    1.0, 0.0, ramp, dtype=np.float32
                )
                self._needs_fade_in = True
            if filled < n and not self._finished:
                self.underruns += 1
                self._playing = False  # re-gate until the buffer refills
            self.pulled_samples += filled
            return out

    @property
    def drained(self) -> bool:
        return self._finished and self._queued == 0

    # -- hardware sink ------------------------------------------------------

    def play_blocking(self, poll_seconds: float = 0.05) -> None:
        """Drive a real sounddevice output stream until drained."""
        import time as _time

        try:
            import sounddevice
        except ImportError as e:
            raise RuntimeError(
                "no audio playback backend on this host (sounddevice "
                "missing); use pull() with your own sink or save_wav()"
            ) from e

        def callback(outdata, frames, _time_info, _status):
            outdata[:, 0] = self.pull(frames)

        with sounddevice.OutputStream(
            samplerate=self.sample_rate, channels=1, callback=callback
        ):
            while not self.drained:
                _time.sleep(poll_seconds)
