"""The card's published peaks, and the operations and bytes of the kernels
and of the model that the roofline and mfu metrics divide by.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit; a card set lower runs slower under load, so every
reading is reported beside the card's limit).

A kernel's bound is the least time the card could take for the work these
inputs need: the larger of its operations over the peak of their type and
its bytes over the memory rate, each input byte read once and each output
byte written once (the formulas of the port's kernel table in PERF.md,
evaluated at each call's shapes).
"""

from __future__ import annotations

from benchmark.references.whisper import Dims

PEAK = {
    "bf16_flop_s": 989e12,
    "fp8_flop_s": 1979e12,
    "int8_op_s": 1979e12,
    "tf32_flop_s": 495e12,
    "fp32_flop_s": 67e12,
    "hbm_byte_s": 3.35e12,
}


def mha_encoder_bound_s(batch: int, heads: int, frames: int, head_dim: int) -> float:
    """K2, the encoder's bf16 attention over B windows: QK^T and PV
    (4 B H S^2 Dh operations); q, k, v read and the output written in bf16."""
    flops = 4.0 * batch * heads * frames * frames * head_dim
    nbytes = 4.0 * batch * heads * frames * head_dim * 2
    return max(flops / PEAK["bf16_flop_s"], nbytes / PEAK["hbm_byte_s"])


def cross_attend_q8_bound_s(batch: int, heads: int, queries: int, frames: int, head_dim: int) -> float:
    """K3, T query rows against the int8 cross-KV: the int8 query and its
    float32 row scale, the int8 K and V codes, V's float32 channel scales
    read; the float32 output written. Its integer dots take 4 B H T S Dh
    operations."""
    rows = batch * heads
    nbytes = rows * (queries * head_dim + queries * 4 + 2 * frames * head_dim + head_dim * 4
                     + queries * head_dim * 4)
    ops = 4.0 * rows * queries * frames * head_dim
    return max(nbytes / PEAK["hbm_byte_s"], ops / PEAK["int8_op_s"])


def encoder_flops(dims: Dims) -> float:
    """One window through the encoder: the two convolutions, each layer's
    projections, attention and MLP."""
    d, s, f = dims.d_model, dims.n_audio_ctx, dims.encoder_ffn
    conv = 2 * s * dims.n_mels * 3 * d + s * d * 3 * d  # conv1 over 2S frames, conv2 at stride 2
    layer = 4 * s * d * d + 2 * s * d * f + 2 * s * s * d
    return 2.0 * (conv + dims.encoder_layers * layer)


def cross_kv_flops(dims: Dims) -> float:
    """One window's cross-attention K and V projections, every decoder layer."""
    return 2.0 * dims.decoder_layers * 2 * dims.n_audio_ctx * dims.d_model * dims.d_model


def token_flops(dims: Dims, position: int) -> float:
    """One token through the decoder at `position` (it attends to position
    + 1 keys of its own and to every frame), and its logits."""
    d, f = dims.d_model, dims.decoder_ffn
    layer = 4 * d * d + 2 * d * d + 2 * d * f + 2 * (position + 1) * d + 2 * dims.n_audio_ctx * d
    return 2.0 * (dims.decoder_layers * layer + d * dims.n_vocab)


def window_flops(dims: Dims, tokens: int, prompt: int = 3) -> float:
    """The useful work of one real window that decoded `tokens` tokens
    after its prompt: the prompt's positions and every decoded token but
    the last go through the decoder."""
    return (encoder_flops(dims) + cross_kv_flops(dims)
            + sum(token_flops(dims, p) for p in range(prompt + max(tokens - 1, 0))))
