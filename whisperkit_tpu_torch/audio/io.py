"""Host-side audio loading, mono conversion, resampling and windowing (the
port's copy of whisperkit_tpu/audio/io.py, trimmed to what the port uses).

Reference: Sources/WhisperKit/Core/Audio/AudioProcessor.swift — `loadAudio`
(:229-305), `resampleAudio` (:381-450), `convertToMono` (:526-625),
`padOrTrimAudio` (:151-174), energy functions (:674-741).

Any container decodes through the native FFmpeg decoder (audio/native.py);
PCM/float WAV also reads with a NumPy RIFF parser, so WAV always works.
Files load whole: the JAX package's chunked long-WAV path and
`stream_audio` are not part of the port.
"""

from __future__ import annotations

import dataclasses
import enum
import struct
from pathlib import Path
from typing import Optional, Union

import numpy as np

from whisperkit_tpu_torch.core.errors import LoadAudioFailed
from whisperkit_tpu_torch.core.logging import logging

SAMPLE_RATE = 16_000
WINDOW_SAMPLES = 480_000  # 30 s (reference: Models.swift:1457 `windowSamples`)


class ChannelMode(enum.Enum):
    """Multichannel handling (reference: AudioProcessor.swift:526-625).

    SUM_CHANNELS sums all channels then renormalizes so the mono peak matches
    the original per-channel peak; SELECT picks one channel.
    """

    SUM_CHANNELS = "sumChannels"
    SELECT = "selectChannel"


@dataclasses.dataclass
class AudioFile:
    samples: np.ndarray  # float32 [channels, n] before mono mix
    sample_rate: int


def load_audio(
    path: Union[str, Path],
    sample_rate: int = SAMPLE_RATE,
    channel_mode: ChannelMode = ChannelMode.SUM_CHANNELS,
    channel: int = 0,
    start_time: Optional[float] = None,
    end_time: Optional[float] = None,
) -> np.ndarray:
    """Load any audio file → mono float32 at `sample_rate` (default 16 kHz):
    decode, optional time range, mono conversion, resample."""
    path = Path(path)
    if not path.exists():
        raise LoadAudioFailed(f"no such file: {path}")
    audio = _decode_file(path)
    mono = convert_to_mono(audio.samples, mode=channel_mode, channel=channel)
    if start_time is not None or end_time is not None:
        s = int((start_time or 0.0) * audio.sample_rate)
        e = int(end_time * audio.sample_rate) if end_time is not None else mono.shape[0]
        mono = mono[max(s, 0) : max(e, 0)]
    if audio.sample_rate != sample_rate:
        mono = resample_audio(mono, audio.sample_rate, sample_rate)
    return np.ascontiguousarray(mono, dtype=np.float32)


def _decode_file(path: Path) -> AudioFile:
    suffix = path.suffix.lower()
    if suffix in (".wav", ".wave"):
        try:
            return _read_wav(path)
        except LoadAudioFailed:
            pass  # fall through to the native decoder (e.g. non-PCM wav)
    native = _native_decode(path)
    if native is not None:
        return native
    if suffix in (".wav", ".wave"):
        return _read_wav(path)
    raise LoadAudioFailed(
        f"cannot decode {path}: native FFmpeg decoder unavailable and file is not PCM WAV"
    )


def _native_decode(path: Path) -> Optional[AudioFile]:
    try:
        from whisperkit_tpu_torch.audio import native

        if not native.available():
            return None
        samples, rate, channels = native.decode(str(path))
        return AudioFile(samples=samples.reshape(channels, -1, order="F"), sample_rate=rate)
    except Exception as e:  # noqa: BLE001
        logging.debug(f"native decode failed for {path}: {e}")
        return None


@dataclasses.dataclass
class _WavMeta:
    """Header-only WAV description: enough to read any frame range."""

    audio_format: int  # 1 = PCM, 3 = IEEE float (after EXTENSIBLE unwrap)
    channels: int
    sample_rate: int
    bits: int
    data_offset: int  # byte offset of the data chunk's samples
    n_frames: int  # frames actually present (declared size ∩ file size)

    @property
    def block_align(self) -> int:
        return self.channels * (self.bits // 8)


def _wav_meta(path: Path) -> _WavMeta:
    """Parse the RIFF headers with seeks only."""
    file_size = path.stat().st_size
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise LoadAudioFailed(f"not a RIFF/WAVE file: {path}")
        fmt = None
        fmt_ext = b""
        data_offset = None
        data_size = 0
        pos = 12
        while pos + 8 <= file_size:
            f.seek(pos)
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            chunk_id = hdr[:4]
            (size,) = struct.unpack_from("<I", hdr, 4)
            if chunk_id == b"fmt ":
                body = f.read(min(size, 4096))
                fmt = struct.unpack_from("<HHIIHH", body, 0)
                fmt_ext = body[18:] if len(body) > 18 else b""
            elif chunk_id == b"data":
                data_offset = pos + 8
                data_size = min(size, file_size - data_offset)
            pos += 8 + size + (size & 1)
    if fmt is None or data_offset is None:
        raise LoadAudioFailed(f"missing fmt/data chunk: {path}")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: real tag is the
        # first 2 bytes of the SubFormat GUID; fmt_ext starts after cbSize,
        # so validBits(2) + channelMask(4) precede the GUID
        if len(fmt_ext) >= 8:
            (audio_format,) = struct.unpack_from("<H", fmt_ext, 6)
        else:
            audio_format = 1
    if audio_format == 1 and bits not in (8, 16, 24, 32):
        raise LoadAudioFailed(f"unsupported PCM bit depth {bits}")
    if audio_format == 3 and bits not in (32, 64):
        raise LoadAudioFailed(f"unsupported float bit depth {bits}")
    if audio_format not in (1, 3):
        raise LoadAudioFailed(f"unsupported WAV format tag {audio_format}")
    if channels <= 0 or rate <= 0:
        raise LoadAudioFailed(f"invalid WAV fmt (channels={channels}, rate={rate})")
    block = channels * (bits // 8)
    return _WavMeta(
        audio_format=audio_format, channels=channels, sample_rate=rate,
        bits=bits, data_offset=data_offset, n_frames=data_size // block,
    )


def _decode_pcm(raw: bytes, audio_format: int, bits: int) -> np.ndarray:
    """Raw sample bytes → float32 interleaved 1-D (whole frames only)."""
    if audio_format == 1:  # PCM
        if bits == 16:
            return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        if bits == 32:
            return np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        if bits == 8:
            return (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        # 24-bit
        b = np.frombuffer(raw, dtype=np.uint8)
        b = b[: (b.shape[0] // 3) * 3].reshape(-1, 3)
        x = (
            (b[:, 0].astype(np.int32))
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        return (x << 8 >> 8).astype(np.float32) / 8388608.0
    # IEEE float
    dtype = "<f4" if bits == 32 else "<f8"
    return np.frombuffer(raw, dtype=dtype).astype(np.float32)


def _read_wav(path: Path) -> AudioFile:
    """Minimal RIFF/WAVE reader: PCM 8/16/24/32-bit and IEEE float32/64."""
    m = _wav_meta(path)
    with open(path, "rb") as f:
        f.seek(m.data_offset)
        raw = f.read(m.n_frames * m.block_align)
    x = _decode_pcm(raw, m.audio_format, m.bits)
    n = (x.shape[0] // m.channels) * m.channels
    return AudioFile(samples=x[:n].reshape(-1, m.channels).T, sample_rate=m.sample_rate)


def convert_to_mono(
    samples: np.ndarray, mode: ChannelMode = ChannelMode.SUM_CHANNELS, channel: int = 0
) -> np.ndarray:
    """Reference: AudioProcessor.swift:526-625."""
    if samples.ndim == 1:
        return samples.astype(np.float32)
    channels = samples.shape[0]
    if channels == 1:
        return samples[0].astype(np.float32)
    if mode == ChannelMode.SELECT:
        if not 0 <= channel < channels:
            raise LoadAudioFailed(f"channel {channel} out of range (0..{channels - 1})")
        return samples[channel].astype(np.float32)
    # sum + peak renormalization: keep the mono peak equal to the original peak
    summed = samples.sum(axis=0).astype(np.float32)
    orig_peak = float(np.abs(samples).max()) if samples.size else 0.0
    new_peak = float(np.abs(summed).max()) if summed.size else 0.0
    if new_peak > 0 and orig_peak > 0:
        summed *= orig_peak / new_peak
    return summed


def resample_audio(x: np.ndarray, from_rate: int, to_rate: int) -> np.ndarray:
    """Polyphase resample (host), Kaiser-windowed (scipy). Reference:
    AudioProcessor.swift:381-450."""
    if from_rate == to_rate:
        return x.astype(np.float32)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(from_rate, to_rate)
    up, down = to_rate // g, from_rate // g
    return resample_poly(x.astype(np.float64), up, down).astype(np.float32)


def pad_or_trim(
    x: np.ndarray, *, start: int = 0, length: int = WINDOW_SAMPLES
) -> np.ndarray:
    """Slice [start, start+length) zero-padded to exactly `length` samples.

    Reference: AudioProcessor.swift:151-174 `padOrTrimAudio`. `start` is
    keyword-only, so that `pad_or_trim(x, WINDOW_SAMPLES)` cannot parse as
    a start offset and return silence.
    """
    seg = x[start : start + length]
    if seg.shape[0] < length:
        seg = np.concatenate([seg, np.zeros(length - seg.shape[0], dtype=np.float32)])
    return seg.astype(np.float32)


# ---- energy utilities (reference: AudioProcessor.swift:674-741) ----


def rms_energy(x: np.ndarray) -> float:
    if x.size == 0:
        return 0.0
    return float(np.sqrt(np.mean(np.square(x.astype(np.float64)))))


def energy_per_frame(x: np.ndarray, frame_length: int) -> np.ndarray:
    """RMS energy of consecutive frames (last partial frame included)."""
    n_frames = int(np.ceil(x.shape[0] / frame_length)) if x.shape[0] else 0
    out = np.zeros(n_frames, dtype=np.float32)
    for i in range(n_frames):
        out[i] = rms_energy(x[i * frame_length : (i + 1) * frame_length])
    return out
