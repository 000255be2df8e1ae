"""Kaldi-style log-mel filterbank features, the WeSpeaker front end (port of
whisperkit_tpu/ops/fbank.py).

Reference: the reference's SpeakerPreEmbedderModel.swift is a CoreML
"fbank-style preprocessor" feeding the WeSpeaker embedder. WeSpeaker
trains on kaldi fbank (torchaudio.compliance.kaldi.fbank: 25 ms frames /
10 ms hop with snip edges, samples scaled to the int16 range, DC removal,
0.97 pre-emphasis, povey window, 512-point power spectrum, 80 mel bins
spanning 20 Hz..Nyquist, natural log, per-utterance mean subtraction).

The transform is a chain of torch ops on the input's device: the framing
is a strided view (`unfold`), the power spectrum two float32 products
against the 400x257 cos/sin bases, the mel banks a third. The JAX package
computes it in XLA, not in a Pallas kernel, so no kernel of the port
stands behind it. The samples reach about ±32768 before the products, so
on the card they need full float32 products: TF32 matmuls would cost
about three decimal digits of the power, and `kaldi_fbank` runs under
`core.device.ieee_float32` whatever the process's flags.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from whisperkit_tpu_torch.core.device import ieee_float32

SAMPLE_RATE = 16_000
FRAME_LEN = 400  # 25 ms
FRAME_HOP = 160  # 10 ms
N_FFT = 512  # next_pow2(400)
PREEMPH = 0.97
LOG_FLOOR = 1.1920929e-07  # kaldi's epsilon (float32 eps)


def _mel_scale(hz):
    return 1127.0 * np.log(1.0 + hz / 700.0)


def _mel_banks(n_mels: int, low_hz: float = 20.0, high_hz: float = 0.0) -> np.ndarray:
    """Kaldi mel banks [n_mels, N_FFT//2+1] (triangular in mel space)."""
    nyquist = SAMPLE_RATE / 2.0
    high = nyquist + high_hz if high_hz <= 0 else high_hz
    low_mel, high_mel = _mel_scale(low_hz), _mel_scale(high)
    # kaldi computes bins on the full fft grid in mel space
    mel_points = np.linspace(low_mel, high_mel, n_mels + 2)
    bins = N_FFT // 2 + 1
    fft_hz = np.arange(bins) * SAMPLE_RATE / N_FFT
    fft_mel = _mel_scale(fft_hz)
    banks = np.zeros((n_mels, bins), np.float32)
    for m in range(n_mels):
        left, center, right = mel_points[m], mel_points[m + 1], mel_points[m + 2]
        up = (fft_mel - left) / (center - left)
        down = (right - fft_mel) / (right - center)
        banks[m] = np.clip(np.minimum(up, down), 0.0, None)
    return banks


def _povey_window(n: int) -> np.ndarray:
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    return (hann**0.85).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _bases(device: torch.device, n_mels: int):
    """(povey window [400], cos [400, 257], sin [400, 257], mel banks
    transposed [257, n_mels]) float32 on `device`."""
    n = np.arange(FRAME_LEN)
    k = np.arange(N_FFT // 2 + 1)
    angle = 2.0 * np.pi * np.outer(n, k) / N_FFT
    mats = (_povey_window(FRAME_LEN), np.cos(angle), np.sin(angle), np.ascontiguousarray(_mel_banks(n_mels).T))
    return tuple(torch.from_numpy(np.asarray(m, np.float32)).to(device) for m in mats)


@ieee_float32()
def kaldi_fbank(
    audio: torch.Tensor,  # [B, T] float32 in [-1, 1]
    n_mels: int = 80,
    mean_norm: bool = True,
) -> torch.Tensor:
    """[B, T] → log-mel fbank [B, F, n_mels] float32 on audio's device.

    snip_edges framing (kaldi default): F = 1 + (T - 400) // 160. Samples
    are scaled to the int16 range like torchaudio/kaldi before the power
    spectrum, so absolute log energies line up with WeSpeaker's training
    features.
    """
    window, cos_m, sin_m, banks = _bases(audio.device, n_mels)
    frames = (audio.float() * 32768.0).unfold(1, FRAME_LEN, FRAME_HOP)  # [B, F, 400]
    # per-frame DC offset removal (kaldi remove_dc_offset=True)
    frames = frames - frames.mean(-1, keepdim=True)
    # pre-emphasis: x[n] - 0.97 * x[n-1] (kaldi replicates the first sample)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = (frames - PREEMPH * prev) * window
    re = frames @ cos_m
    im = -(frames @ sin_m)
    power = re * re + im * im  # [B, F, 257]
    fb = torch.log(torch.clamp_min(power @ banks, LOG_FLOOR))
    if mean_norm:
        fb = fb - fb.mean(dim=1, keepdim=True)
    return fb
