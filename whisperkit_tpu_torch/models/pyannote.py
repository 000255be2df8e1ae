"""The conv speaker models: segmentation and embedding for random-init runs
(port of whisperkit_tpu/models/pyannote.py).

Reference: Sources/SpeakerKit/Pyannote/SpeakerSegmenterModel.swift (CoreML
segmenter over 30 s chunks, :121-217) and SpeakerEmbedderModel.swift
(WeSpeaker-style embedder + fbank pre-embedder, :313). The JAX package
built these architectures for random-init runs (`DiarizePipeline()`'s
default); the published ones, which checkpoints convert to, are in
models/pyannet.py:

  * Segmenter: strided conv front end → 2× bidirectional LSTM → MLP →
    per-frame sigmoid activity for `n_local_speakers` slots (+ the
    derived overlap activity).
  * Embedder: log-mel (ops/mel.py, the Whisper front end, at 80 mels) →
    conv1d stack with the mel bins as channels → masked temporal
    statistics pooling (mean‖std) → linear → L2-normed embedding. The
    speaker-activity mask makes the pooling speaker-selective.

Parameter trees are the JAX package's (dicts and lists of tensors); the
`init_*` functions draw them from an explicit `torch.Generator` on the
CPU, and the forward functions take them prepared
(`models.pyannet.prepare_params`). The JAX package computes these in XLA,
so here they are torch's own ops (`F.conv1d`, `nn.LSTM`, `torch.matmul`),
in IEEE float32 on the card (`core.device.ieee_float32`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from whisperkit_tpu_torch.core.device import ieee_float32

Params = Any

SAMPLE_RATE = 16_000
CHUNK_SECONDS = 30.0
CHUNK_SAMPLES = int(CHUNK_SECONDS * SAMPLE_RATE)


@dataclasses.dataclass(frozen=True)
class SegmenterDims:
    n_local_speakers: int = 3
    conv_channels: int = 64
    lstm_hidden: int = 128
    n_lstm: int = 2
    # samples per output frame: 100 ms resolution → 300 frames per 30 s
    # chunk; frame count sets the sequential LSTM's length, and 100 ms
    # frames are ample for diarization (min_active_offset defaults to 1 s)
    frame_stride: int = 1600

    @property
    def frames_per_chunk(self) -> int:
        return CHUNK_SAMPLES // self.frame_stride


@dataclasses.dataclass(frozen=True)
class EmbedderDims:
    n_mels: int = 80
    channels: tuple = (128, 192, 256)
    embedding_dim: int = 256


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _normal(g: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=g) * scale


def _linear(g, d_in, d_out):
    return {"w": _normal(g, (d_in, d_out), d_in**-0.5), "b": torch.zeros(d_out)}


def _conv1d_p(g, c_in, c_out, k):
    return {"w": _normal(g, (c_out, c_in, k), (c_in * k) ** -0.5), "b": torch.zeros(c_out)}


def _lstm_p(g, d_in, hidden):
    return {
        "wx": _normal(g, (d_in, 4 * hidden), d_in**-0.5),
        "wh": _normal(g, (hidden, 4 * hidden), hidden**-0.5),
        "b": torch.zeros(4 * hidden),
    }


def init_segmenter(g: torch.Generator, dims: SegmenterDims = SegmenterDims()) -> Params:
    """Random float32 segmenter tree on the CPU, drawn from `g`."""
    c, h = dims.conv_channels, dims.lstm_hidden
    params = {
        # strided conv front end: 80 → 5 → frame_stride // 400
        "conv1": _conv1d_p(g, 1, c, 81),
        "conv2": _conv1d_p(g, c, c, 21),
        "conv3": _conv1d_p(g, c, c, 5),
    }
    lstms, d_in = [], c
    for _ in range(dims.n_lstm):
        lstms.append({"fwd": _lstm_p(g, d_in, h), "bwd": _lstm_p(g, d_in, h)})
        d_in = 2 * h
    params["lstms"] = lstms
    params["fc1"] = _linear(g, 2 * h, 2 * h)
    params["fc2"] = _linear(g, 2 * h, 2 * h)
    params["cls"] = _linear(g, 2 * h, dims.n_local_speakers)
    return params


def init_embedder(g: torch.Generator, dims: EmbedderDims = EmbedderDims()) -> Params:
    """Random float32 embedder tree on the CPU, drawn from `g`: conv1d
    layers over time with the mel bins as channels, then the projection of
    the pooled statistics."""
    convs, c_in = [], dims.n_mels
    for c_out in dims.channels:
        convs.append(_conv1d_p(g, c_in, c_out, 5))
        c_in = c_out
    return {"convs": convs, "proj": _linear(g, 2 * dims.channels[-1], dims.embedding_dim)}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _conv1d(x, p, stride: int) -> torch.Tensor:
    """x [B, C, T], padding k // 2 on both sides."""
    return F.conv1d(x, p["w"], p["b"], stride, p["w"].shape[-1] // 2)


@ieee_float32()
@torch.no_grad()
def segmenter_forward(params: Params, audio: torch.Tensor, dims: SegmenterDims = SegmenterDims()) -> dict:
    """audio [B, 480000] float32 → speaker activity.

    Returns `speaker_activity` [B, F, S] sigmoid probabilities and
    `overlapped_speaker_activity` [B, F] (probability that ≥2 are active),
    the reference segmenter's outputs (SpeakerSegmenterModel.swift:55-117)."""
    x = audio.float()[:, None, :]  # [B, 1, T]
    x = F.leaky_relu(_conv1d(x, params["conv1"], 80))
    x = F.leaky_relu(_conv1d(x, params["conv2"], 5))
    x = F.leaky_relu(_conv1d(x, params["conv3"], dims.frame_stride // 400))
    x = params["lstm"](x.transpose(1, 2))[0]  # [B, F, 2H]
    x = F.leaky_relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    x = F.leaky_relu(x @ params["fc2"]["w"] + params["fc2"]["b"])
    activity = torch.sigmoid(x @ params["cls"]["w"] + params["cls"]["b"])  # [B, F, S]
    overlap = torch.sigmoid(4.0 * (activity.sum(-1) - 1.0))
    return {"speaker_activity": activity, "overlapped_speaker_activity": overlap}


@ieee_float32()
@torch.no_grad()
def embedder_forward(
    params: Params,
    fbank: torch.Tensor,  # [B, n_mels, T] log-mel features
    frame_mask: torch.Tensor,  # [B, T] speaker-activity weights in [0, 1]
    dims: EmbedderDims = EmbedderDims(),
) -> torch.Tensor:
    """Masked speaker embedding [B, E], L2-normalized: the activity mask
    weights the statistics pooling towards the target speaker's frames."""
    x = fbank.float()  # mel bins as channels
    for cp in params["convs"]:
        x = torch.relu(_conv1d(x, cp, 2))
    b, _, t = x.shape
    feat = x.transpose(1, 2)  # [B, T', C]

    # downsample the mask to T' and pool the masked statistics
    ratio = frame_mask.shape[1] // t if t else 1
    mask_ds = frame_mask[:, : t * ratio].reshape(b, t, ratio).mean(-1)  # [B, T']
    w = mask_ds / (mask_ds.sum(1, keepdim=True) + 1e-6)
    mean = torch.einsum("btd,bt->bd", feat, w)
    var = torch.einsum("btd,bt->bd", (feat - mean[:, None]) ** 2, w)
    stats = torch.cat([mean, torch.sqrt(var + 1e-6)], dim=-1)
    emb = stats @ params["proj"]["w"] + params["proj"]["b"]
    return emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-8)
