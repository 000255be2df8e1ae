"""Qwen3-TTS model stack in PyTorch (port of whisperkit_tpu/models/qwen3_tts.py).

Reference: Sources/TTSKit/Qwen3TTS/ — six CoreML components whose
architecture is the published Qwen3-Omni talker stack
(`transformers.models.qwen3_omni_moe`), pinned by the reference's cache
geometry (Qwen3Models.swift:48-57):

  * CodeDecoder — 28-layer Qwen3 backbone (RMSNorm, rotary, GQA with
    head_dim 128, SwiGLU).
  * MultiCodeDecoder — the 5-layer KV-cached code predictor (HF
    `TalkerCodePredictor`): per frame it runs over [frame hidden, code0
    embed, code1..14 embeds] with 15 embedding tables and 15 heads.
  * SpeechDecoder — HF `Code2Wav`: an 8-layer sliding-window(72)
    pre-transformer with LayerScale over mean-pooled 16-codebook
    embeddings, ConvNeXt x2 upsampling (x2, x2) and four SnakeBeta decoder
    blocks (x8, x5, x4, x3) → 1920 samples per 12.5 Hz frame.

The parameter tree is the JAX package's: the same keys, the transformer
blocks stacked [L, ...] (a layer is a view `[li]` of each stack), linear
weights [in, out], conv weights in torch order. Quantized linears are the
dicts of ops/quant.py ({"w_q", "scale"} W8A16, {"w_q4", "scale4"} W4A16),
stacked too. `params_from_numpy` carries a JAX tree across.

Every function computes what its JAX namesake does, with the same rounding
points: f32 norms, rotary and attention scores, casts back to the
activation dtype where JAX casts. The KV caches are written in place at
their slot (`pos_offset`); at an int slot attention reads keys
[0, pos_offset + T), the ones the causal mask leaves open. The backbone
also takes its slot as a 0-d tensor on the device (the TTS frame loop's
step, which a CUDA graph replays): it then writes K/V by `index_copy_` and
attends the whole cache under the mask, as JAX does at every slot. None
of this runs in a Pallas kernel in the JAX package: the products are
`torch.matmul` (W8A16 ones of a few rows the port's W8A16 kernel), the
vocoder `F.conv1d` and `F.conv_transpose1d`. On the card the talker's frame
step and the code predictor's passes run each layer's norms, rotary,
attention and SwiGLU in the kernels of ops/qwen3_decode.py
(`_qwen3_layers`). Code2Wav's float32 is IEEE float32 on the card
whatever the process's TF32 flags (`core.device.ieee_float32` on its entry
points; cuDNN's TF32, on by default, moves the samples by ~7e-4); the
backbone and code predictor run in bfloat16, or in float32 at the
process's cuBLAS flag (TF32 off by default).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from whisperkit_tpu_torch.core.device import DeviceLike, ieee_float32, resolve_device
from whisperkit_tpu_torch.ops import quant, qwen3_decode
# the layer's plain norm and rotary, under the JAX package's names
from whisperkit_tpu_torch.ops.qwen3_decode import rms_norm, rope as _rope  # noqa: F401

Params = dict[str, Any]

# Codec-track special tokens (Qwen3Models.swift:21-26)
CODEC_PAD = 2148
CODEC_BOS = 2149
CODEC_EOS = 2150
CODEC_THINK = 2154
CODEC_THINK_BOS = 2156
CODEC_THINK_EOS = 2157
# Text-track special tokens (Qwen3Models.swift:30-31)
TEXT_PAD = 151_671
TEXT_BOS = 151_672

CODEC_VOCAB = 3072  # code0 logits/embedding rows (specials + speaker ids)
HEAD_VOCAB = 2048  # RVQ codebook size, heads 1..15 (Qwen3Models.swift:36)
SAMPLES_PER_FRAME = 1920  # Qwen3Models.swift:40-41
OUTPUT_SAMPLE_RATE = 24_000

# Codec-0 ids suppressed during sampling: [2048, 3072) except EOS
# (Qwen3Models.swift:76-82).
SUPPRESS_BEGIN = 2048
SUPPRESS_END = 3072

# Speaker voices -> codec token ids (Qwen3Models.swift:88-150)
SPEAKERS: dict[str, int] = {
    "ryan": 3061,
    "aiden": 2861,
    "ono-anna": 2873,
    "sohee": 2864,
    "eric": 2875,
    "dylan": 2878,
    "serena": 3066,
    "vivian": 3065,
    "uncle-fu": 3010,
}
DEFAULT_SPEAKER = "ryan"

# Languages -> codec token ids (Qwen3Models.swift:157-174)
TTS_LANGUAGES: dict[str, int] = {
    "english": 2050,
    "chinese": 2055,
    "japanese": 2058,
    "korean": 2064,
    "german": 2053,
    "french": 2061,
    "russian": 2069,
    "portuguese": 2071,
    "spanish": 2054,
    "italian": 2070,
}
DEFAULT_TTS_LANGUAGE = "english"


@dataclasses.dataclass(frozen=True)
class Code2WavDims:
    """HF `Qwen3OmniMoeCode2WavConfig` defaults; total upsample = 1920."""

    d_model: int = 1024
    n_layer: int = 8
    n_head: int = 16
    n_kv_head: int = 16
    d_ff: int = 3072
    sliding_window: int = 72
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    layer_scale_init: float = 0.01
    codebook: int = 2048
    n_quantizers: int = 16
    upsampling_ratios: tuple = (2, 2)
    upsample_rates: tuple = (8, 5, 4, 3)
    decoder_dim: int = 1536

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def total_upsample(self) -> int:
        u = 1
        for r in self.upsampling_ratios + self.upsample_rates:
            u *= r
        return u

    @property
    def conv_delay(self) -> int:
        """Samples lost to the decoder blocks' transposed-conv left trims:
        for T frames the conv stack emits T*total_upsample - conv_delay."""
        loss = 0
        for r in self.upsample_rates:
            loss = loss * r + r
        return loss


TINY_C2W_DIMS = Code2WavDims(
    d_model=32, n_layer=2, n_head=4, n_kv_head=2, d_ff=64, sliding_window=8,
    decoder_dim=32,
)


@dataclasses.dataclass(frozen=True)
class Qwen3TTSDims:
    # CodeDecoder backbone (Qwen3-0.6B geometry, explicit head_dim 128)
    text_vocab: int = 151_936
    d_model: int = 1024
    n_layer: int = 28
    n_head: int = 16
    n_kv_head: int = 8
    head_dim: int = 128
    d_ff: int = 3072
    rope_theta: float = 1_000_000.0
    max_seq: int = 2048
    # text-track special ids (overridable for tiny test vocabularies)
    text_pad: int = TEXT_PAD
    text_bos: int = TEXT_BOS
    # MultiCodeDecoder / code predictor (HF TalkerCodePredictor defaults)
    cp_layer: int = 5
    cp_head: int = 16
    cp_kv_head: int = 8
    cp_head_dim: int = 128
    cp_ff: int = 3072
    cp_rope_theta: float = 10_000.0
    # SpeechDecoder / Code2Wav
    c2w: Code2WavDims = dataclasses.field(default_factory=Code2WavDims)


TINY_TTS_DIMS = Qwen3TTSDims(
    text_vocab=512, d_model=64, n_layer=2, n_head=4, n_kv_head=2, head_dim=16,
    d_ff=128, max_seq=256, text_pad=510, text_bos=511,
    cp_layer=2, cp_head=2, cp_kv_head=1, cp_head_dim=16, cp_ff=32,
    c2w=TINY_C2W_DIMS,
)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class _Init:
    """Draws of one init: normal draws on the generator's device, scaled in
    float32, then cast to `dtype` on `device` (the JAX init's scales and
    zero/one initialisers; the values differ from JAX's)."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype, device: torch.device):
        self.g, self.dtype, self.device = generator, dtype, device

    def normal(self, shape, scale: float) -> torch.Tensor:
        x = torch.randn(shape, generator=self.g, device=self.g.device, dtype=torch.float32)
        return (x * scale).to(self.device, self.dtype)

    def dense(self, d_in: int, d_out: int) -> torch.Tensor:
        return self.normal((d_in, d_out), d_in**-0.5)

    def conv(self, out_c: int, in_c: int, k: int) -> torch.Tensor:
        return self.normal((out_c, in_c, k), (in_c * k) ** -0.5)

    def tconv(self, in_c: int, out_c: int, k: int) -> torch.Tensor:
        return self.normal((in_c, out_c, k), (in_c * k) ** -0.5)

    def const(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=self.dtype, device=self.device)

    def blocks(self, n, d, h, kvh, dh, ff, *, qk_norm: bool, layer_scale: Optional[float]) -> Params:
        """`n` Qwen3 blocks, each leaf stacked [n, ...]."""

        def one() -> Params:
            p = {
                "ln1": self.const((d,), 1.0),
                "wq": self.dense(d, h * dh),
                "wk": self.dense(d, kvh * dh),
                "wv": self.dense(d, kvh * dh),
                "wo": self.dense(h * dh, d),
                "ln2": self.const((d,), 1.0),
                "w_gate": self.dense(d, ff),
                "w_up": self.dense(d, ff),
                "w_down": self.dense(ff, d),
            }
            if qk_norm:
                p["qnorm"] = self.const((dh,), 1.0)
                p["knorm"] = self.const((dh,), 1.0)
            if layer_scale is not None:
                p["attn_scale"] = self.const((d,), layer_scale)
                p["mlp_scale"] = self.const((d,), layer_scale)
            return p

        layers = [one() for _ in range(n)]
        return {k: torch.stack([p[k] for p in layers]) for k in layers[0]}


def init_code2wav_params(init: _Init, dims: Code2WavDims) -> Params:
    """The `Qwen3OmniMoeCode2Wav` parameter tree (conv weights in torch
    [O, I, K] / transposed [I, O, K] order)."""
    h = dims.d_model

    def convnext() -> Params:
        return {
            "dw_w": init.conv(h, 1, 7),  # depthwise, groups=h
            "dw_b": init.const((h,), 0.0),
            "ln_g": init.const((h,), 1.0),
            "ln_b": init.const((h,), 0.0),
            "pw1_w": init.dense(h, 4 * h),
            "pw1_b": init.const((4 * h,), 0.0),
            "pw2_w": init.dense(4 * h, h),
            "pw2_b": init.const((h,), 0.0),
            "gamma": init.const((h,), 1e-6),
        }

    def residual_unit(c: int) -> Params:
        return {
            "a1": init.const((c,), 0.0),  # SnakeBeta alpha (log-scale)
            "b1": init.const((c,), 0.0),
            "c1_w": init.conv(c, c, 7),
            "c1_b": init.const((c,), 0.0),
            "a2": init.const((c,), 0.0),
            "b2": init.const((c,), 0.0),
            "c2_w": init.conv(c, c, 1),
            "c2_b": init.const((c,), 0.0),
        }

    blocks = init.blocks(
        dims.n_layer, h, dims.n_head, dims.n_kv_head, dims.head_dim, dims.d_ff,
        qk_norm=False, layer_scale=dims.layer_scale_init,
    )
    upsample = [
        {"tconv_w": init.tconv(h, h, f), "tconv_b": init.const((h,), 0.0), "cnx": convnext()}
        for f in dims.upsampling_ratios
    ]
    dec_blocks = []
    for i, rate in enumerate(dims.upsample_rates):
        in_c, out_c = dims.decoder_dim // 2**i, dims.decoder_dim // 2 ** (i + 1)
        dec_blocks.append({
            "snake_a": init.const((in_c,), 0.0),
            "snake_b": init.const((in_c,), 0.0),
            "tconv_w": init.tconv(in_c, out_c, 2 * rate),
            "tconv_b": init.const((out_c,), 0.0),
            "units": [residual_unit(out_c) for _ in range(3)],
        })
    out_c = dims.decoder_dim // 2 ** len(dims.upsample_rates)
    return {
        "code_embed": init.dense(dims.codebook * dims.n_quantizers, h),
        "blocks": blocks,
        "ln_f": init.const((h,), 1.0),
        "upsample": upsample,
        "dec_in_w": init.conv(dims.decoder_dim, h, 7),
        "dec_in_b": init.const((dims.decoder_dim,), 0.0),
        "dec_blocks": dec_blocks,
        "out_snake_a": init.const((out_c,), 0.0),
        "out_snake_b": init.const((out_c,), 0.0),
        "out_w": init.conv(1, out_c, 7),
        "out_b": init.const((1,), 0.0),
    }


def init_tts_params(
    generator: torch.Generator,
    dims: Qwen3TTSDims,
    dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = "cuda",
) -> Params:
    """Random weights with the structure, shapes and scales of the JAX
    `init_tts_params`, drawn from `generator` (on its own device: a CUDA
    generator draws the 0.6b tree in a fraction of a second) and placed on
    `device` in `dtype`. The values differ from JAX's."""
    init = _Init(generator, dtype, resolve_device(device))
    d = dims.d_model
    return {
        "text_embed": init.dense(dims.text_vocab, d),  # TextProjector
        "code_embed": init.dense(CODEC_VOCAB, d),  # CodeEmbedder
        "blocks": init.blocks(
            dims.n_layer, d, dims.n_head, dims.n_kv_head, dims.head_dim, dims.d_ff,
            qk_norm=True, layer_scale=None,
        ),
        "ln_f": init.const((d,), 1.0),
        "code0_head": init.dense(d, CODEC_VOCAB),
        # MultiCodeDecoder: 15 embedding tables, a small transformer, 15 heads
        "mc": {
            "embeds": torch.stack([init.dense(HEAD_VOCAB, d) for _ in range(15)]),
            "blocks": init.blocks(
                dims.cp_layer, d, dims.cp_head, dims.cp_kv_head, dims.cp_head_dim, dims.cp_ff,
                qk_norm=True, layer_scale=None,
            ),
            "ln_f": init.const((d,), 1.0),
            "heads": torch.stack([init.dense(d, HEAD_VOCAB) for _ in range(15)]),
        },
        "c2w": init_code2wav_params(init, dims.c2w),
    }


def map_tree(fn, tree, key=None):
    """`fn(key, leaf)` over a tree of dicts and lists; `key` is the leaf's
    dict key (a list's items take the list's)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v, key) for v in tree]
    return fn(key, tree)


def params_from_numpy(tree: dict, device: DeviceLike = "cuda", dtype: Optional[torch.dtype] = None) -> Params:
    """A JAX TTS tree as numpy arrays (`jax.tree.map(np.asarray, params)`)
    → the port's tree on `device`. Float leaves keep their own width (a
    loaded tree's bf16 backbone and f32 Code2Wav) unless `dtype` is given;
    the quantized trees' scales ("scale", "scale4") stay bf16 either way,
    integer leaves (int8 "w_q", uint8 "w_q4") keep their dtype."""
    dev = resolve_device(device)

    def leaf(key, x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return torch.from_numpy(np.array(x)).to(dev)
        if key in quant.SCALE_KEYS:
            to = torch.bfloat16
        elif dtype is not None:
            to = dtype
        else:
            to = torch.bfloat16 if x.dtype.name == "bfloat16" else torch.float32
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev, to)

    return map_tree(leaf, tree)


def params_to_device(params: Params, device: DeviceLike) -> Params:
    """The tree's leaves on `device` (a leaf already there is kept)."""
    dev = resolve_device(device)
    return map_tree(lambda _, t: t.to(dev), params)


def _layer(blocks: Params, li: int) -> Params:
    """Layer `li` of a stacked block tree (views; quantized linears stay dicts)."""
    return {k: ({kk: vv[li] for kk, vv in v.items()} if isinstance(v, dict) else v[li])
            for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# Transformer pieces
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rope_freqs(theta: float, half: int, device: torch.device) -> torch.Tensor:
    """JAX's `1 / theta ** (arange(half) / half)`: float64 on the host,
    float32 on the device."""
    freqs = 1.0 / (theta ** (np.arange(0, half) / half))
    return torch.from_numpy(freqs.astype(np.float32)).to(device)


def _rope_angles(positions: torch.Tensor, theta: float, dh: int) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [B, T] → ([cos, cos], [-sin, sin]) [B, T, 1, dh] in float32."""
    angles = positions[:, :, None].float() * _rope_freqs(theta, dh // 2, positions.device)
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w in x's dtype: a float weight, or a W8A16 ({"w_q", "scale"}) or
    W4A16 ({"w_q4", "scale4"}) dict, dequantized in x's dtype."""
    if isinstance(w, dict):
        if "w_q4" in w:
            return quant.quantized_matmul_w4(x, w)
        return quant.quantized_matmul(x, w)
    return x @ w


def _mm_f32(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w with float32 products of x's values and the weight's values in
    x's dtype (JAX's `preferred_element_type=jnp.float32`): the code
    predictor's heads."""
    if isinstance(w, dict) and "w_q4" in w:
        lo, hi = quant._w4_planes(w, x.dtype)
        half = lo.shape[0]
        return x[..., :half].float() @ lo.float() + x[..., half:].float() @ hi.float()
    if isinstance(w, dict):
        w = quant.dequantize_weight(w, x.dtype)
    return x.float() @ w.float()


def _mm_siblings(x: torch.Tensor, ws: list) -> list:
    """x @ w for each weight of `ws`, products that share x: W8A16 dicts in
    one `quant.quantized_matmul_siblings` call (one kernel launch on the
    card), any other weights one `_mm` each."""
    if all(isinstance(w, dict) and "w_q" in w for w in ws):
        return quant.quantized_matmul_siblings(x, ws, [None] * len(ws))
    return _mm_each(x, ws)


def _mm_each(x: torch.Tensor, ws: list) -> list:
    """x @ w for each weight of `ws`, one `_mm` each."""
    return [_mm(x, w) for w in ws]


class _LayerOps(NamedTuple):
    """The glue of a layer pass: the plain versions, or the kernels of
    ops/qwen3_decode.py with the products that share an input in one
    launch."""

    add_norm: Callable
    products: Callable
    attention: Callable
    swiglu: Callable


_PLAIN_OPS = _LayerOps(qwen3_decode.add_rms_norm_reference, _mm_each, qwen3_decode.decode_attention_reference,
                       qwen3_decode.swiglu_reference)
_DECODE_OPS = _LayerOps(qwen3_decode.add_rms_norm, _mm_siblings, qwen3_decode.decode_attention,
                        qwen3_decode.swiglu)


def _qwen3_layers(
    blocks: Params,  # stacked [L, ...] block params
    x: torch.Tensor,  # [B, T, D]
    positions: torch.Tensor,  # [B, T] rotary positions
    mask: torch.Tensor,  # [.., .., T, keys attended] additive f32
    pos_offset: Union[int, torch.Tensor],  # cache slot of x[:, 0], an int or a 0-d int64 tensor
    kv_k: torch.Tensor,  # [L, B, KVH, S, Dh], written in place
    kv_v: torch.Tensor,
    *,
    n_head: int,
    n_kv_head: int,
    head_dim: int,
    rope_theta: float,
    qk_norm: bool,
    layer_scale: bool,
    final_norm: torch.Tensor,  # [D]: the stack's last RMSNorm
    rms_eps: float = 1e-6,
) -> torch.Tensor:
    """The Qwen3-family layer stack shared by the backbone, the code
    predictor and the Code2Wav pre-transformer: RMSNorm → GQA (rotary,
    optional per-head q/k norms, keys repeated per query head, f32 scores
    and softmax) → SwiGLU, with optional LayerScale residuals. Each layer
    writes its K/V at slots [pos_offset, pos_offset + T) of its cache and
    attends keys [0, pos_offset + T), or, at a tensor slot, every key of
    the cache. Returns rms_norm(x after the last layer, final_norm).

    Each residual add is taken with the RMSNorm after it. A stack that
    `qwen3_decode.qwen3_decode_takes` (on the card: bf16, one or two
    positions a row, the TTS frame's talker step and code-predictor passes)
    runs that glue in the kernels of ops/qwen3_decode.py, eight launches a
    layer pass with W8A16 weights: add + norm, q/k/v, attention, wo, add +
    norm, gate/up, SwiGLU, down. Every other stack runs their plain
    versions, the same ops at the same rounding points."""
    ops = _DECODE_OPS if qwen3_decode.qwen3_decode_takes(
        x.device.type, (x.dtype, kv_k.dtype, final_norm.dtype), t=x.shape[1], n_head=n_head, n_kv_head=n_kv_head,
        head_dim=head_dim, n_keys=mask.shape[-1], d_model=x.shape[-1], qk_norm=qk_norm,
        layer_scale=layer_scale) else _PLAIN_OPS
    cos, sin = _rope_angles(positions, rope_theta, head_dim)
    mlp = None
    for li in range(kv_k.shape[0]):
        bp = _layer(blocks, li)
        x, hthin = ops.add_norm(x, mlp, bp["ln1"], rms_eps)
        q, k, v = ops.products(hthin, [bp["wq"], bp["wk"], bp["wv"]])
        out = ops.attention(
            q, k, v, bp["qnorm"] if qk_norm else None, bp["knorm"] if qk_norm else None, cos, sin, kv_k[li],
            kv_v[li], pos_offset, mask, n_head=n_head, n_kv_head=n_kv_head, eps=rms_eps,
        )
        attn = _mm(out, bp["wo"])
        if layer_scale:
            attn = attn * bp["attn_scale"].to(attn.dtype)
        x, hthin = ops.add_norm(x, attn, bp["ln2"], rms_eps)
        gate, up = ops.products(hthin, [bp["w_gate"], bp["w_up"]])
        mlp = _mm(ops.swiglu(gate, up), bp["w_down"])
        if layer_scale:
            mlp = mlp * bp["mlp_scale"].to(mlp.dtype)
    return ops.add_norm(x, mlp, final_norm, rms_eps)[1]


def _causal_mask(pos_offset: int, t: int, device) -> torch.Tensor:
    """[T, pos_offset + T] additive f32: query pos_offset + i sees keys ≤ it."""
    key_pos = torch.arange(pos_offset + t, device=device)[None, :]
    query_pos = pos_offset + torch.arange(t, device=device)[:, None]
    return torch.where(key_pos <= query_pos, 0.0, -math.inf)


def init_code_kv_cache(
    dims: Qwen3TTSDims, batch: int, max_seq: Optional[int] = None,
    dtype: torch.dtype = torch.bfloat16, device: DeviceLike = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The backbone's zeroed (k, v) caches [L, B, KVH, S, Dh]. The JAX
    package's is always bf16; decoding/tts_loop.py makes it in the weights'
    float dtype, which is bf16 for every tree the JAX loop runs."""
    shape = (dims.n_layer, batch, dims.n_kv_head, max_seq or dims.max_seq, dims.head_dim)
    dev = resolve_device(device)
    return torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev)


def code_decoder_forward(
    params: Params,
    embeds: torch.Tensor,  # [B, T, D] input embeddings (text+codec tracks)
    pos_offset: Union[int, torch.Tensor],  # cache slot of embeds[:, 0]: an int, or a 0-d int64 tensor
    kv_k: torch.Tensor,
    kv_v: torch.Tensor,
    dims: Qwen3TTSDims,
    rope_offset: Optional[torch.Tensor] = None,  # [B] logical position of embeds[:, 0]
    key_invalid: Optional[torch.Tensor] = None,  # [B, S] slots never attended (left pads)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Backbone step or prefill → (code0 logits [B, T, V] f32, hidden
    [B, T, D]); the caches are written in place.

    Reference: Qwen3CodeDecoder.swift `decode(inputEmbeds:cache:state:)`.
    Left padding shifts the rotary positions (`rope_offset`) without moving
    cache slots; a pad slot is hidden from every other query but still
    attends to itself, so its activations stay finite. At a tensor slot
    (JAX's traced `pos_offset`) the keys attended are the whole cache, as
    in JAX (`whisperkit_tpu/models/qwen3_tts.py` `code_decoder_forward`);
    at an int slot they stop at the last query, which the mask closes
    past anyway."""
    b, t, _ = embeds.shape
    dev = embeds.device
    steps = torch.arange(t, device=dev)[None, :]
    if rope_offset is None:
        positions = (pos_offset + steps).expand(b, t)
    else:
        positions = torch.clamp_min(rope_offset[:, None] + steps, 0)
    n_keys = kv_k.shape[3] if isinstance(pos_offset, torch.Tensor) else pos_offset + t
    key_pos = torch.arange(n_keys, device=dev)[None, :]
    query_pos = pos_offset + torch.arange(t, device=dev)[:, None]
    mask = torch.where(key_pos <= query_pos, 0.0, -math.inf)[None, None]
    if key_invalid is not None:
        inv = key_invalid[:, None, None, :n_keys] & (key_pos != query_pos)[None, None]
        mask = mask + torch.where(inv, -math.inf, 0.0)
    hidden = _qwen3_layers(
        params["blocks"], embeds, positions, mask, pos_offset, kv_k, kv_v,
        n_head=dims.n_head, n_kv_head=dims.n_kv_head, head_dim=dims.head_dim,
        rope_theta=dims.rope_theta, qk_norm=True, layer_scale=False, final_norm=params["ln_f"],
    )
    logits = _mm(hidden, params["code0_head"]).float()
    return logits, hidden


# ---------------------------------------------------------------------------
# MultiCodeDecoder (code predictor)
# ---------------------------------------------------------------------------


def code_predictor_forward(
    mc: Params,
    embeds: torch.Tensor,  # [B, T, D]
    pos_offset: int,
    kv_k: torch.Tensor,  # [cpL, B, cpKV, S, cpDh], written in place
    kv_v: torch.Tensor,
    dims: Qwen3TTSDims,
) -> torch.Tensor:
    """One step or prefill of the per-frame code predictor → hidden [B, T, D]."""
    b, t, _ = embeds.shape
    positions = (pos_offset + torch.arange(t, device=embeds.device)[None, :]).expand(b, t)
    mask = _causal_mask(pos_offset, t, embeds.device)[None, None]
    return _qwen3_layers(
        mc["blocks"], embeds, positions, mask, pos_offset, kv_k, kv_v,
        n_head=dims.cp_head, n_kv_head=dims.cp_kv_head, head_dim=dims.cp_head_dim,
        rope_theta=dims.cp_rope_theta, qk_norm=True, layer_scale=False, final_norm=mc["ln_f"],
    )


def sample_topk(
    logits: torch.Tensor,  # [B, V] float32
    temperature: float,
    top_k: int,
    noise: Optional[torch.Tensor] = None,  # [B, top_k] Gumbel noise
) -> torch.Tensor:
    """Top-k sampling as JAX's `lax.top_k` + `jax.random.categorical`
    compute it: argmax(top_vals / max(T, 1e-4) + g) over the k largest
    logits; temperature 0 takes the argmax of all logits. → [B] int64."""
    if temperature <= 0:
        return logits.argmax(-1)
    top_vals, top_idx = torch.topk(logits, top_k, dim=-1)
    choice = (top_vals / max(temperature, 1e-4) + noise).argmax(-1, keepdim=True)
    return top_idx.gather(1, choice)[:, 0]


def multicode_forward(
    params: Params,
    hidden: torch.Tensor,  # [B, D] frame hidden state from the backbone
    code0: torch.Tensor,  # [B] sampled codec-0 token
    temperature: float,
    top_k: int = 5,
    *,
    dims: Qwen3TTSDims,
    noise: Optional[torch.Tensor] = None,  # [B, 15, top_k] Gumbel noise when temperature > 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Frame hidden + code0 → (15 RVQ head codes [B, 15], codec_sum [B, D]).

    Reference: Qwen3MultiCodeDecoder.swift `generateMultiCodes` (:249-345):
    a fresh KV-cached transformer per frame, prefilled with [hidden,
    code0_embed], then AR steps; head i's logits sample code i+1, whose
    embedding feeds the next step. `codec_sum` is the sum of all 16 code
    embeddings, the backbone's next codec track. The last code's embedding
    feeds only `codec_sum`: JAX's scan runs one more predictor step whose
    output it drops, which is not run here."""
    mc = params["mc"]
    b, _ = hidden.shape
    kv_shape = (dims.cp_layer, b, dims.cp_kv_head, 17, dims.cp_head_dim)
    kv_k = torch.zeros(kv_shape, dtype=hidden.dtype, device=hidden.device)
    kv_v = torch.zeros(kv_shape, dtype=hidden.dtype, device=hidden.device)

    c0e = params["code_embed"][code0].to(hidden.dtype)
    h = code_predictor_forward(mc, torch.stack([hidden, c0e], dim=1), 0, kv_k, kv_v, dims)
    last = h[:, -1]
    csum = c0e
    codes = []
    for i in range(15):
        head = {k: v[i] for k, v in mc["heads"].items()} if isinstance(mc["heads"], dict) else mc["heads"][i]
        logits = _mm_f32(last, head)
        code = sample_topk(logits, temperature, top_k, None if noise is None else noise[:, i])
        codes.append(code)
        emb = mc["embeds"][i][code].to(last.dtype)
        csum = csum + emb
        if i < 14:
            last = code_predictor_forward(mc, emb[:, None], 2 + i, kv_k, kv_v, dims)[:, -1]
    return torch.stack(codes, dim=1), csum


# ---------------------------------------------------------------------------
# Speech decoder (Code2Wav)
# ---------------------------------------------------------------------------


def _snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """SnakeBeta: x + (1/exp(beta)) * sin(exp(alpha) * x)^2 per channel, in
    float32; x [B, C, T], alpha/beta in log scale (HF SnakeBeta)."""
    a = torch.exp(alpha.float())[None, :, None]
    b = torch.exp(beta.float())[None, :, None]
    x32 = x.float()
    return (x32 + (1.0 / (b + 1e-9)) * torch.sin(x32 * a) ** 2).to(x.dtype)


def _causal_conv(x, w, b, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """x [B, C, T] stride-1 causal conv; w [O, I/groups, K] (torch order)."""
    pad = (w.shape[-1] - 1) * dilation
    y = F.conv1d(F.pad(x, (pad, 0)), w.to(x.dtype), dilation=dilation, groups=groups)
    return y + b.to(x.dtype)[None, :, None]


def _causal_tconv(x, w, b, stride: int) -> torch.Tensor:
    """Causal transposed conv (HF CausalTransConvNet): ConvTranspose1d(k, s)
    then (k - s) trimmed from both sides; w [I, O, K]. Code2Wav has k == s
    (upsample stages, no trim) and k == 2s (decoder blocks, trim s): the
    JAX package's phase einsums compute the same samples."""
    k = w.shape[-1]
    if k not in (stride, 2 * stride):
        raise ValueError("Code2Wav uses k == s or k == 2s transposed convs")
    y = F.conv_transpose1d(x, w.to(x.dtype), stride=stride)
    trim = k - stride
    if trim:
        y = y[..., trim:-trim]
    return y + b.to(x.dtype)[None, :, None]


def _convnext_block(x: torch.Tensor, p: Params) -> torch.Tensor:
    """HF Qwen3OmniMoeConvNeXtBlock: causal depthwise k7 → LayerNorm →
    pointwise 4x, exact-erf GELU, pointwise → gamma, residual. x [B, C, T]."""
    h = _causal_conv(x, p["dw_w"], p["dw_b"], groups=x.shape[1]).transpose(1, 2)  # [B, T, C]
    h32 = h.float()
    mu = h32.mean(-1, keepdim=True)
    var = (h32 - mu).square().mean(-1, keepdim=True)
    h = ((h32 - mu) * torch.rsqrt(var + 1e-6) * p["ln_g"].float() + p["ln_b"].float()).to(x.dtype)
    h = _mm(h, p["pw1_w"]) + p["pw1_b"].to(x.dtype)
    h = F.gelu(h)
    h = _mm(h, p["pw2_w"]) + p["pw2_b"].to(x.dtype)
    return x + (h * p["gamma"].to(x.dtype)).transpose(1, 2)


def _c2w_embed(c2w: Params, codes: torch.Tensor, dims: Code2WavDims) -> torch.Tensor:
    """codes [B, T, nq] → mean-pooled embeddings [B, T, H] (HF offsets)."""
    offsets = torch.arange(dims.n_quantizers, device=codes.device) * dims.codebook
    ids = torch.clamp(codes, 0, dims.codebook - 1) + offsets
    return c2w["code_embed"][ids].mean(dim=2)


def _c2w_transformer_mask(query_pos: torch.Tensor, key_pos: torch.Tensor, window: int) -> torch.Tensor:
    ok = (key_pos <= query_pos) & (key_pos > query_pos - window)
    return torch.where(ok, 0.0, -math.inf)[None, None]


def _c2w_conv_stack(c2w: Params, hidden: torch.Tensor, dims: Code2WavDims) -> torch.Tensor:
    """hidden [B, T, H] → waveform [B, T*total_upsample - conv_delay]."""
    x = hidden.transpose(1, 2)  # [B, H, T]
    for factor, stage in zip(dims.upsampling_ratios, c2w["upsample"]):
        x = _causal_tconv(x, stage["tconv_w"], stage["tconv_b"], factor)
        x = _convnext_block(x, stage["cnx"])
    x = _causal_conv(x, c2w["dec_in_w"], c2w["dec_in_b"])
    for rate, blk in zip(dims.upsample_rates, c2w["dec_blocks"]):
        x = _snake_beta(x, blk["snake_a"], blk["snake_b"])
        x = _causal_tconv(x, blk["tconv_w"], blk["tconv_b"], rate)
        for u, dilation in zip(blk["units"], (1, 3, 9)):
            r = x
            x = _snake_beta(x, u["a1"], u["b1"])
            x = _causal_conv(x, u["c1_w"], u["c1_b"], dilation=dilation)
            x = _snake_beta(x, u["a2"], u["b2"])
            x = _causal_conv(x, u["c2_w"], u["c2_b"])
            x = x + r
    x = _snake_beta(x, c2w["out_snake_a"], c2w["out_snake_b"])
    x = _causal_conv(x, c2w["out_w"], c2w["out_b"])  # [B, 1, T']
    return torch.clamp(x[:, 0], -1.0, 1.0)


def _c2w_layers(c2w: Params, emb, positions, mask, pos_offset, kv_k, kv_v, dims: Code2WavDims):
    return _qwen3_layers(
        c2w["blocks"], emb, positions, mask, pos_offset, kv_k, kv_v,
        n_head=dims.n_head, n_kv_head=dims.n_kv_head, head_dim=dims.head_dim,
        rope_theta=dims.rope_theta, qk_norm=False, layer_scale=True, final_norm=c2w["ln_f"], rms_eps=dims.rms_eps,
    )


def _code2wav(c2w: Params, codes: torch.Tensor, dims: Code2WavDims) -> torch.Tensor:
    emb = _c2w_embed(c2w, codes, dims)
    b, t, _ = emb.shape
    pos = torch.arange(t, device=emb.device)
    mask = _c2w_transformer_mask(pos[:, None], pos[None, :], dims.sliding_window)
    kv_shape = (dims.n_layer, b, dims.n_kv_head, t, dims.head_dim)
    kv_k = torch.zeros(kv_shape, dtype=emb.dtype, device=emb.device)
    kv_v = torch.zeros_like(kv_k)
    hidden = _c2w_layers(c2w, emb, pos[None, :].expand(b, t), mask, 0, kv_k, kv_v, dims)
    return _c2w_conv_stack(c2w, hidden, dims)


@ieee_float32()
@torch.inference_mode()
def code2wav_forward(c2w: Params, codes: torch.Tensor, dims: Code2WavDims) -> torch.Tensor:
    """Whole-utterance Code2Wav: codes [B, T, nq] → [B, T*total_upsample -
    conv_delay] (the decoder blocks' transposed convs trim `conv_delay`
    samples; the streaming and pipeline wrappers re-align to frames)."""
    return _code2wav(c2w, codes, dims)


@ieee_float32()
@torch.inference_mode()
def speech_decoder_forward(params: Params, codes: torch.Tensor, dims: Qwen3TTSDims) -> torch.Tensor:
    """codes [B, T, 16] → waveform [B, T*1920] at 24 kHz, the whole batch in
    one call. The `conv_delay` samples the transposed convs trim come back
    as leading silence, so frame i owns samples [i*1920, (i+1)*1920)."""
    b, t, _ = codes.shape
    wave = _code2wav(params["c2w"], codes, dims.c2w)
    out = torch.zeros((b, t * dims.c2w.total_upsample), dtype=wave.dtype, device=wave.device)
    out[:, dims.c2w.conv_delay:] = wave
    return out


@dataclasses.dataclass
class Code2WavCache:
    """Streaming vocoder state (reference SpeechDecoderCache,
    KVCache.swift:159-210): pre-transformer KV, the frames decoded so far,
    and the rolling 16-frame hidden context."""

    kv_k: torch.Tensor  # [L, B, KVH, S, Dh], written in place
    kv_v: torch.Tensor
    pos: int  # frames decoded so far
    hidden_ctx: torch.Tensor  # [B, CTX, H] rolling post-transformer states


C2W_CONTEXT_FRAMES = 16  # sdHiddenContextLen (Qwen3Models.swift:57)


def init_code2wav_cache(
    dims: Code2WavDims, batch: int, max_frames: int = 256,
    dtype: torch.dtype = torch.float32, device: DeviceLike = "cuda",
) -> Code2WavCache:
    dev = resolve_device(device)
    kv_shape = (dims.n_layer, batch, dims.n_kv_head, max_frames, dims.head_dim)
    return Code2WavCache(
        kv_k=torch.zeros(kv_shape, dtype=dtype, device=dev),
        kv_v=torch.zeros(kv_shape, dtype=dtype, device=dev),
        pos=0,
        hidden_ctx=torch.zeros((batch, C2W_CONTEXT_FRAMES, dims.d_model), dtype=dtype, device=dev),
    )


@ieee_float32()
@torch.inference_mode()
def code2wav_decode_block(
    c2w: Params,
    codes: torch.Tensor,  # [B, n, 16] new frames
    cache: Code2WavCache,
    dims: Code2WavDims,
    *,
    ctx_frames: int,  # real frames of cache.hidden_ctx to use: min(decoded, 16)
) -> tuple[torch.Tensor, Code2WavCache]:
    """Streaming block decode → ([B, n*1920], cache), sample for sample the
    whole-utterance `speech_decoder_forward`: 16 context frames cover the
    conv stack's ~9.4-frame receptive field, and the KV cache makes the
    sliding-window transformer exact."""
    emb = _c2w_embed(c2w, codes, dims)
    b, n, _ = emb.shape
    dev = emb.device
    steps = cache.pos + torch.arange(n, device=dev)
    mask = _c2w_transformer_mask(steps[:, None], torch.arange(cache.pos + n, device=dev)[None, :],
                                 dims.sliding_window)
    hidden = _c2w_layers(c2w, emb, steps[None, :].expand(b, n), mask, cache.pos, cache.kv_k, cache.kv_v, dims)

    spf = dims.total_upsample
    if ctx_frames == 0:
        wave = _c2w_conv_stack(c2w, hidden, dims)  # [B, n*spf - delay]
        out = torch.zeros((b, n * spf), dtype=wave.dtype, device=dev)
        out[:, dims.conv_delay:] = wave
    else:
        ctx = cache.hidden_ctx[:, C2W_CONTEXT_FRAMES - ctx_frames:]
        out = _c2w_conv_stack(c2w, torch.cat([ctx.to(hidden.dtype), hidden], 1), dims)[:, -n * spf:]
    new_ctx = torch.cat([cache.hidden_ctx.to(hidden.dtype), hidden], 1)[:, -C2W_CONTEXT_FRAMES:]
    return out, Code2WavCache(cache.kv_k, cache.kv_v, cache.pos + n, new_ctx)
