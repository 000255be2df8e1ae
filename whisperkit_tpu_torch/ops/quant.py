"""Weight quantization for Whisper and the speaker models (port of the
Whisper and speaker parts of whisperkit_tpu/ops/quant.py).

Three schemes, with the JAX package's layouts and rounding points:

  W8A16  {"w_q": int8 [in, out], "scale": bf16 [out], "b": ...}; the weight
         is dequantized in the activation dtype, then multiplied
  W4A16  {"w_q4": uint8 [in/2, out], "scale4": bf16 [in/group, out], ...};
         half-plane nibbles (byte row p holds row p in the low nibble and
         row p + in/2 in the high), two half-dots summed
  W8A8   the W8A16 tree with the activation row-quantized to int8 and an
         exact integer dot (the encoder's `act8` path)

`models/whisper.dense` dispatches on the keys. None of these products runs
in a Pallas kernel in the JAX package (XLA fuses the dequant into the
matmul), so here they are plain torch: the dequantized weight is formed per
call and multiplied with `torch.matmul`. A fused-dequant GEMV and an int8
GEMM are speed work for later (ROADMAP.md A.1).

The speaker models' quantizer (`quantize_speaker_params`, with
`quantize_conv_weight` for their convolutions) serves the W8A16 pyannote
variant (pipelines/diarize.py), `quantize_tts_params` the W8A16/W4A16
Qwen3-TTS trees (pipelines/tts.py). `QUANT_FORMATS` numbers each scheme's
stored layout for the loader's on-disk quantized cache (models/loader.py).
"""

from __future__ import annotations

from typing import Any

import torch

from whisperkit_tpu_torch.ops.attention_decode import _int_dot

Params = dict[str, Any]

W4_GROUP = 64  # rows per scale group; divides every Whisper linear's d_model

# leaves that hold weight scales: bf16 whatever the tree's float dtype
SCALE_KEYS = ("scale", "scale4")

# The packed layout of each scheme's tree, as the loader's quantized cache
# (models/loader.py) records it: a cache whose recorded format differs
# from its scheme's entry here is rebuilt, since a changed layout can read
# back with the same dtypes and shapes and wrong values. Bump a scheme's
# entry whenever ITS stored representation changes. These are the port's
# own numbers (its cache files are its own): format 1 is the layout above,
# W8A16 int8 codes with bf16 per-column scales, W4A16 half-plane nibbles
# with bf16 per-group scales.
QUANT_FORMATS = {"w8a16": 1, "w4a16": 1}


def quant_format(scheme: str) -> int:
    return QUANT_FORMATS[scheme]


def quantize_weight(w: torch.Tensor) -> dict:
    """[in, out] float → {"w_q" int8, "scale" bf16 [out]} (symmetric,
    per output channel)."""
    w32 = w.float()
    scale = torch.clamp_min(w32.abs().amax(dim=0) / 127.0, 1e-8)
    w_q = torch.clamp(torch.round(w32 / scale[None, :]), -127, 127).to(torch.int8)
    return {"w_q": w_q, "scale": scale.to(torch.bfloat16)}


def dequantize_weight(q: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """The [in, out] weight in `dtype` (float32 or bfloat16), in one pass:
    the int8 codes times the scales, computed in float and rounded once.
    That is JAX's `dequantize_weight` (an f32 product, then a cast) and its
    `quantized_matmul` operand (a product in the activation dtype) alike:
    the code, the bf16 scale and their product are exact in float32."""
    return q["w_q"] * q["scale"].to(dtype)[None, :]


def quantized_matmul(x: torch.Tensor, q: dict) -> torch.Tensor:
    """x [..., in] @ dequant(w), the weight dequantized in x's dtype."""
    return x @ dequantize_weight(q, x.dtype)


def quantized_matmul_w8a8(x: torch.Tensor, q: dict) -> torch.Tensor:
    """x [..., in] @ int8 w through an exact integer dot (W8A8): x is
    row-quantized (symmetric per-token absmax, round half to even) and the
    integer accumulator is rescaled by (row scale × per-output-channel
    weight scale).

    torch has no int8 × int8 → int32 product on CUDA, and float32 is not
    exact here (1280 · 127² > 2^24), so the dot runs in float64, which is
    exact for these sizes on the CPU and the card alike."""
    x32 = x.float()
    a_scale = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
    xq = torch.clamp(torch.round(x32 / a_scale), -127, 127).to(torch.int8)
    acc = _int_dot(xq, q["w_q"])
    y = acc.float() * a_scale * q["scale"].float()
    return y.to(x.dtype)


# --- W4A16 -------------------------------------------------------------------


def quantize_weight_w4(w: torch.Tensor, group: int = W4_GROUP) -> dict:
    """[in, out] float → {"w_q4" uint8 [in/2, out] (half-plane nibbles),
    "scale4" bf16 [in/group, out]} (symmetric per (group × output channel);
    one group when `group` does not divide the input dim). The input dim
    must be even."""
    w32 = w.float()
    din, dout = w32.shape
    if din % 2:
        raise ValueError(f"W4A16 needs an even input dim, got {din}")
    if din % group:
        group = din
    wg = w32.reshape(din // group, group, dout)
    scale = torch.clamp_min(wg.abs().amax(dim=1) / 7.0, 1e-8)  # [g, out]
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -7, 7).reshape(din, dout)
    u = (q.to(torch.int8) + 8).to(torch.uint8)  # codes in [1, 15]
    half = din // 2
    return {"w_q4": u[:half] | (u[half:] << 4), "scale4": scale.to(torch.bfloat16)}


def _scale4_full(q: dict, dtype) -> torch.Tensor:
    """The [g, out] group scales broadcast to the full [in, out] shape."""
    din, dout = 2 * q["w_q4"].shape[0], q["w_q4"].shape[1]
    g = q["scale4"].shape[0]
    return q["scale4"].to(dtype)[:, None, :].expand(g, din // g, dout).reshape(din, dout)


def _unpack4_planes(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 [in/2, out] → (lo, hi) int8 codes in [-7, 7]: lo is rows
    [0, in/2), hi is rows [in/2, in)."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return lo, hi


def _w4_planes(q: dict, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The dequantized weight's rows [0, in/2) and [in/2, in) in `dtype`:
    each plane's codes times its group scales."""
    lo, hi = _unpack4_planes(q["w_q4"])
    s = _scale4_full(q, dtype)
    half = lo.shape[0]
    return lo * s[:half], hi * s[half:]


def w4_dequant(q: dict, dtype) -> torch.Tensor:
    """The full [in, out] weight of a {"w_q4", "scale4"} dict."""
    return torch.cat(_w4_planes(q, dtype), dim=0)


def quantized_matmul_w4(x: torch.Tensor, q: dict) -> torch.Tensor:
    """x [..., in] @ dequant4(w) as two half-dots (x's low features against
    the low-nibble plane, its high features against the high plane) summed,
    each plane dequantized in x's dtype."""
    lo, hi = _w4_planes(q, x.dtype)
    half = lo.shape[0]
    return x[..., :half] @ lo + x[..., half:] @ hi


# --- parameter trees ---------------------------------------------------------

# param-dict keys that hold linear weights [in, out]
_LINEAR_KEYS = {"q", "k", "v", "out", "fc1", "fc2"}


def quantize_whisper_params(params: Params, min_size: int = 1 << 16, bits: int = 8) -> Params:
    """Quantize every linear weight of a port parameter tree
    (`models/whisper.init_params` / `params_from_numpy`); embeddings,
    norms, convolutions and biases stay as they are. bits=8 gives the
    W8A16 form (also the W8A8 scheme's weights), bits=4 the W4A16 form.

    `min_size` applies to the layer stack's size, as in the JAX package,
    whose stacks are one [L, in, out] array: a linear is quantized when
    L · in · out ≥ min_size. The new leaves lie on the weights' device."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    qfn = quantize_weight if bits == 8 else quantize_weight_w4

    def quantize_linear(node: dict) -> dict:
        out = {k: v for k, v in node.items() if k != "w"}
        out.update(qfn(node["w"]))
        return out

    def walk(node, key=None, n_stack=1):
        if isinstance(node, list):  # a layer stack: one dict per layer
            return [walk(v, key, len(node)) for v in node]
        if isinstance(node, dict):
            if (
                key in _LINEAR_KEYS
                and isinstance(node.get("w"), torch.Tensor)
                and node["w"].numel() * n_stack >= min_size
            ):
                return quantize_linear(node)
            return {k: walk(v, k, n_stack) for k, v in node.items()}
        return node

    return walk(params)


def quantized_size_bytes(params: Params) -> int:
    """Device-resident parameter bytes, each storage counted once (for
    float32 weights `token_embed_f32` is `token_embed` itself)."""
    seen: dict[tuple, int] = {}

    def visit(node):
        if isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)
        elif isinstance(node, torch.Tensor):
            seen[(node.device, node.data_ptr())] = node.numel() * node.element_size()

    visit(params)
    return sum(seen.values())


# --- speaker models (PyanNet, WeSpeaker ResNet34) ---------------------------


def quantize_conv_weight(w: torch.Tensor) -> dict:
    """Conv weight [O, ...] → {"w_q" int8, "scale" bf16 [O, 1, …]}
    (symmetric, per output channel; the scale keeps the trailing singleton
    axes so the dequant broadcasts in place)."""
    w32 = w.float()
    dims = tuple(range(1, w.ndim))
    scale = torch.clamp_min(w32.abs().amax(dim=dims, keepdim=True) / 127.0, 1e-8)
    w_q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"w_q": w_q, "scale": scale.to(torch.bfloat16)}


# speaker-model weight keys: [in, out] matmuls vs [O, I, K…] convs.
# _SPEAKER_CONV_PARENTS is the allowlist of learned-conv parents (PyanNet's
# sincnet convs, ResNet34's block and shortcut convs, models/pyannet.py):
# the materialized "sinc" filterbank is not in it, since its filters are
# derived analytically, and a subtree of another name stays float.
_SPEAKER_MATMUL_KEYS = {"wx", "wh"}
_SPEAKER_CONV_PARENTS = {"conv1", "conv2", "down"}


def quantize_speaker_params(params: Params, min_size: int = 1 << 12) -> Params:
    """W8A16-quantize a PyanNet / WeSpeaker parameter tree: LSTM input and
    recurrent kernels, linear and classifier weights, and the BN-folded
    conv kernels, each leaf of at least `min_size` elements. Norm affines,
    biases and the materialized sinc filterbank stay float. A quantized
    leaf becomes the dict {"w_q", "scale"}, which models/pyannet.py
    dequantizes in the activation dtype. Reference: the W8A16 pyannote
    variants in PyannoteConfig.swift:11-41."""

    def walk(node, key=None, parent=None):
        if isinstance(node, dict):
            if "w_q" in node:
                return node  # already quantized
            return {k: walk(v, k, key) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key, parent) for v in node)
        if not isinstance(node, torch.Tensor) or node.numel() < min_size:
            return node
        if key in _SPEAKER_MATMUL_KEYS and node.ndim == 2:
            return quantize_weight(node)
        if key == "w" and node.ndim == 2:  # linears, classifier, seg_1
            return quantize_weight(node)
        if key == "w" and node.ndim in (3, 4) and parent in _SPEAKER_CONV_PARENTS:
            return quantize_conv_weight(node)
        return node

    return walk(params)


# --- Qwen3-TTS ---------------------------------------------------------------

# stacked-block linear keys ([L, in, out]); embeddings, norms and the
# Code2Wav vocoder stay unquantized (reference W8A16 recipe,
# Qwen3Config.swift:106-112)
_TTS_BLOCK_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantize_stack(qfn, w: torch.Tensor) -> dict:
    """[N, in, out] → the per-slice quantized dicts stacked [N, ...] (JAX's
    `jax.vmap(qfn)`)."""
    qs = [qfn(w[i]) for i in range(w.shape[0])]
    return {k: torch.stack([q[k] for q in qs]) for k in qs[0]}


def quantize_tts_params(params: Params, min_size: int = 1 << 16, bits: int = 8) -> Params:
    """W8A16 (or, with bits=4, W4A16) Qwen3-TTS tree: every transformer
    linear of the backbone and of the code predictor (per layer of each
    stack), the code0 head and the 15 RVQ heads, each when its array (the
    whole stack) has at least `min_size` elements, as in the JAX package.
    Embeddings, norms and the Code2Wav vocoder stay as they are."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    qfn = quantize_weight if bits == 8 else quantize_weight_w4

    def big(w) -> bool:
        return isinstance(w, torch.Tensor) and w.numel() >= min_size

    def quantize_stacked(blocks: Params) -> Params:
        return {k: _quantize_stack(qfn, w) if k in _TTS_BLOCK_KEYS and big(w) else w for k, w in blocks.items()}

    out = dict(params)
    out["blocks"] = quantize_stacked(params["blocks"])
    if big(params["code0_head"]):
        out["code0_head"] = qfn(params["code0_head"])
    mc = dict(params["mc"])
    mc["blocks"] = quantize_stacked(mc["blocks"])
    if big(mc["heads"]):  # [15, D, V]
        mc["heads"] = _quantize_stack(qfn, mc["heads"])
    out["mc"] = mc
    return out
