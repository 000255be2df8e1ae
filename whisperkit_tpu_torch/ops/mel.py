"""Whisper log-mel spectrogram (port of whisperkit_tpu/ops/mel.py).

  reflect-pad → frame (400 window / 160 hop) → Hann → DFT → power →
  slaney mel → log10 → per-row (max − 8) clamp → (x + 4) / 4

`log_mel_frames` is the fused part (framing through log10). For a CUDA
tensor it launches the hand-written kernel in csrc/mel.cu (the DFT on the
tensor cores in 3xTF32); for a CPU tensor it runs
`log_mel_frames_reference`, the plain torch version of the same math in
float32. `log_mel_frames_3xtf32` is the kernel's split-product numerics in
plain torch, for the tests. `log_mel_spectrogram` adds the clamp, the
normalisation and the transpose in torch, as the JAX wrapper does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from whisperkit_tpu_torch.ops import _build

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
N_FRAMES = 3000  # 30 s window
WINDOW_SAMPLES = 480_000


@functools.lru_cache(maxsize=4)
def mel_filters(n_mels: int, n_fft: int = N_FFT, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-style mel filterbank [n_mels, n_fft//2 + 1] (librosa defaults:
    slaney scale + slaney area norm — what Whisper's mel_filters.npz holds)."""

    def hz_to_mel(f: np.ndarray) -> np.ndarray:
        f = np.asarray(f, dtype=np.float64)
        f_sp = 200.0 / 3
        mels = f / f_sp
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = math.log(6.4) / 27.0
        log_region = f >= min_log_hz
        mels = np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
        return mels

    def mel_to_hz(m: np.ndarray) -> np.ndarray:
        m = np.asarray(m, dtype=np.float64)
        f_sp = 200.0 / 3
        freqs = m * f_sp
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = math.log(6.4) / 27.0
        log_region = m >= min_log_mel
        freqs = np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
        return freqs

    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # slaney area normalization
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=2)
def _dft_window_matrices(n_fft: int = N_FFT) -> tuple[np.ndarray, np.ndarray]:
    """Hann-windowed DFT basis: cos/sin matrices [n_fft, n_fft//2 + 1]."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    # periodic Hann window (matches torch.hann_window(periodic=True))
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    angle = 2.0 * np.pi * n * k / n_fft
    cos_m = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_m = (-np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_m, sin_m


@functools.lru_cache(maxsize=8)
def _bases(device: torch.device, n_mels: int):
    """(cos [400,201], sin [400,201], mel_w [201,n_mels]) f32 on `device`."""
    cos_m, sin_m = _dft_window_matrices()
    mel_w = np.ascontiguousarray(mel_filters(n_mels).T)
    return tuple(torch.from_numpy(m).to(device) for m in (cos_m, sin_m, mel_w))


def dft_basis_fragments() -> np.ndarray:
    """The kernel's DFT basis [50, 52, 32, 2] f32: for k-step ks (8
    samples), n-tile nt (cos, for nt even, or sin of the 8 frequencies
    8 (nt // 2) .. + 7; zero past the 201st) and lane 4 g + t of the
    mma.sync.m16n8k8 B fragment, the basis at (sample 8 ks + t, column g)
    and at (sample 8 ks + t + 4, column g)."""
    cos_m, sin_m = _dft_window_matrices()
    n_freq = cos_m.shape[1]
    groups = -(-n_freq // 8)
    w = np.zeros((N_FFT, 2 * groups, 8), np.float32)  # [sample, n-tile, column]
    for s, m in enumerate((cos_m, sin_m)):
        padded = np.zeros((N_FFT, 8 * groups), np.float32)
        padded[:, :n_freq] = m
        w[:, s::2] = padded.reshape(N_FFT, groups, 8)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    ks = np.arange(N_FFT // 8)[:, None, None]
    nt = np.arange(2 * groups)[None, :, None]
    return np.stack([w[8 * ks + t, nt, g], w[8 * ks + t + 4, nt, g]], axis=-1)


def mel_spans(mel_w: np.ndarray) -> np.ndarray:
    """[n_mels, 2] int32: each filter's nonzero frequency rows [lo, hi) of
    mel_w [n_freq, n_mels] (an empty filter gives [0, 0))."""
    spans = np.zeros((mel_w.shape[1], 2), np.int32)
    for m in range(mel_w.shape[1]):
        nz = np.nonzero(mel_w[:, m])[0]
        if len(nz):
            spans[m] = nz[0], nz[-1] + 1
    return spans


@functools.lru_cache(maxsize=8)
def _kernel_bases(device: torch.device, n_mels: int):
    """(basis fragments, mel_w [201, n_mels], mel spans [n_mels, 2]) on
    `device`, as csrc/mel.cu takes them."""
    mel_w = np.ascontiguousarray(mel_filters(n_mels).T)
    return tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device)
                 for m in (dft_basis_fragments(), mel_w, mel_spans(mel_w)))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as cvt.rna.tf32.f32 rounds (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def log_mel_frames_3xtf32(padded: torch.Tensor, n_mels: int, n_frames: int, products: int = 3) -> torch.Tensor:
    """The kernel's DFT numerics in plain torch: each frame sample and basis
    value split into TF32 parts x = x_hi + x_lo, and the products summed as
    x_lo w_hi + x_hi w_lo + x_hi w_hi (exactly, in float64, then float32);
    `products=1` keeps only x_hi w_hi (plain TF32), to show what the split
    buys. The rest as `log_mel_frames_reference`."""
    cos_m, sin_m, mel_w = _bases(padded.device, n_mels)
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]

    def parts(x):
        hi = tf32_round(x)
        return hi.double(), tf32_round(x - hi).double()

    f_hi, f_lo = parts(frames)
    out = []
    for basis in (cos_m, sin_m):
        w_hi, w_lo = parts(basis)
        y = f_hi @ w_hi
        if products == 3:
            y = y + f_lo @ w_hi + f_hi @ w_lo
        out.append(y.float())
    power = out[0] * out[0] + out[1] * out[1]
    return torch.log10(torch.clamp_min(power @ mel_w, 1e-10))


def _padded_rows(audio: torch.Tensor, n_frames: int) -> torch.Tensor:
    """[B, N] → reflect-padded signal cut or zero-filled to exactly the
    (n_frames + 2) hop rows the framing reads, [B, (n_frames + 2) * 160]."""
    pad = N_FFT // 2
    padded = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    total = (n_frames + 2) * HOP_LENGTH
    if padded.shape[1] >= total:
        return padded[:, :total].contiguous()
    return F.pad(padded, (0, total - padded.shape[1]))


def log_mel_frames_reference(padded: torch.Tensor, n_mels: int, n_frames: int,
                             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain torch version of the kernel: [B, (T+2)*160] → raw log10 mel
    [B, T, n_mels] float32, every product in true float32 (or in `dtype`:
    float64 gives the checks an exact yardstick)."""
    cos_m, sin_m, mel_w = (m.to(dtype) for m in _bases(padded.device, n_mels))
    frames = padded.to(dtype).unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]  # [B, T, 400]
    real = frames @ cos_m
    imag = frames @ sin_m
    power = real * real + imag * imag
    mel = power @ mel_w
    return torch.log10(torch.clamp_min(mel, 1e-10)).float()


def log_mel_frames(audio: torch.Tensor, n_mels: int, n_frames: int = N_FRAMES) -> torch.Tensor:
    """audio f32 [B, N] → raw log10 mel [B, n_frames, n_mels] (before the
    clamp and normalisation). CUDA: csrc/mel.cu; CPU: the plain version."""
    padded = _padded_rows(audio.float(), n_frames)
    if not padded.is_cuda:
        return log_mel_frames_reference(padded, n_mels, n_frames)
    b = padded.shape[0]
    _build.check_cuda("audio", padded, torch.float32, 2)
    basis, mel_w, spans = _kernel_bases(padded.device, n_mels)
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32, device=padded.device)
    _build.launch(
        "log_mel", "wk_log_mel", padded.device,
        _build.ptr(padded), _build.ptr(basis), _build.ptr(mel_w), _build.ptr(spans),
        _build.ptr(out), b, n_frames, n_mels,
    )
    return out


def normalize_log_mel(log_mel: torch.Tensor) -> torch.Tensor:
    """Raw log10 mel [B, T, n_mels] → the model's input [B, n_mels, T]: clamp
    to (max − 8) per row, then (x + 4) / 4."""
    row_max = log_mel.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_mel, row_max - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(1, 2)


def log_mel_spectrogram(
    audio: torch.Tensor, n_mels: int = 80, n_frames: int = N_FRAMES
) -> torch.Tensor:
    """audio float32 [N] (or [B, N]) → log-mel [n_mels, n_frames] ([B, ...]).

    Numerics of openai/whisper `log_mel_spectrogram`: power spectrum,
    slaney mel, log10 with a 1e-10 floor, clamp to (max − 8) per row, then
    (x + 4) / 4.
    """
    squeeze = audio.dim() == 1
    if squeeze:
        audio = audio[None]
    out = normalize_log_mel(log_mel_frames(audio, n_mels, n_frames))
    return out[0] if squeeze else out
