"""Whisper encoder/decoder on torch tensors (port of
whisperkit_tpu/models/whisper.py).

Parameters are a plain tree of dicts of tensors with the JAX package's
names and layouts (linear weights [in, out], conv weights [out, in, k]),
except that each layer stack is a list of per-layer dicts instead of one
[L, ...] array, and the decoder carries `token_embed_f32`, a float32 view
(or copy, for bf16 weights) of the embedding for the float32 logits
projection.

Entry points:
  init_params / params_from_numpy / params_to_numpy
  encoder_forward              mel → encoder output
  compute_cross_kv[_quantized] encoder output → per-layer cross K/V
  decoder_forward              prefill (T > 1) and the T == 1 step, with the
                               alignment heads' cross-attention probabilities
                               written to `align_out` (word timestamps)

Attention runs through the port's kernels where the JAX package has a
Pallas kernel: the encoder's self-attention (ops/attention.py), the T==1
self-attention over the raw cache (ops/attention_decode.self_attend) or
the int8 cache (ops/attention_decode.self_attend_q8) and the int8
cross-attention (ops/attention_decode.cross_attend_q8, in its probs form
on the layers that hold an alignment head when probabilities are
captured). Prefill
self-attention, raw cross-attention, the dense layers (plain, W8A16, W4A16
and W8A8, ops/quant.py), the convolutions and the vocabulary projection
are plain torch, as the JAX package leaves them to XLA.

A quantized tree (`ops/quant.quantize_whisper_params`) keeps its int8 and
uint8 codes and its bf16 scales through `params_from_numpy` and
`params_to_numpy`.

Tensor parallelism: a tp rank's tree (parallel/sharding.
shard_whisper_params) holds its Megatron shard and, under "tp", its rank's
handle on the group's collectives (parallel/group.py), as a JAX tree holds
its NamedShardings. Every function here that takes `params` reads it:
each rank runs n_head / tp heads, a row-split linear's partial products
are all-reduced before its bias is added once (`_dense_row`), W8A8's
activation scale is reduced to the maximum over the ranks, and the
alignment heads' probabilities are written by the rank that holds the head
(`gather_alignment` then sums the ranks' buffers). The int8 cross-KV and
self-KV scales are per head (over frames, or per token over Dh), so a head
split leaves them exact. `encoder_forward(seq_group=...)` is the
sequence-parallel encoder.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from whisperkit_tpu_torch.core.device import DeviceLike, resolve_device
from whisperkit_tpu_torch.ops import quant
from whisperkit_tpu_torch.ops.attention import mha_encoder
from whisperkit_tpu_torch.ops.attention_decode import (
    cross_attend_q8,
    self_attend,
    self_attend_q8,
    self_attend_q8_reference,
    write_head_probs,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class WhisperDims:
    """Model dimensions (mirrors openai/whisper ModelDimensions)."""

    n_mels: int = 80
    n_vocab: int = 51865
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4

    @property
    def head_dim(self) -> int:
        return self.n_text_state // self.n_text_head


VARIANT_DIMS: dict[str, WhisperDims] = {
    "tiny": WhisperDims(80, 51865, 1500, 384, 6, 4, 448, 384, 6, 4),
    "tiny.en": WhisperDims(80, 51864, 1500, 384, 6, 4, 448, 384, 6, 4),
    "base": WhisperDims(80, 51865, 1500, 512, 8, 6, 448, 512, 8, 6),
    "base.en": WhisperDims(80, 51864, 1500, 512, 8, 6, 448, 512, 8, 6),
    "small": WhisperDims(80, 51865, 1500, 768, 12, 12, 448, 768, 12, 12),
    "small.en": WhisperDims(80, 51864, 1500, 768, 12, 12, 448, 768, 12, 12),
    "medium": WhisperDims(80, 51865, 1500, 1024, 16, 24, 448, 1024, 16, 24),
    "medium.en": WhisperDims(80, 51864, 1500, 1024, 16, 24, 448, 1024, 16, 24),
    "large": WhisperDims(80, 51865, 1500, 1280, 20, 32, 448, 1280, 20, 32),
    "large-v2": WhisperDims(80, 51865, 1500, 1280, 20, 32, 448, 1280, 20, 32),
    "large-v3": WhisperDims(128, 51866, 1500, 1280, 20, 32, 448, 1280, 20, 32),
    "large-v3-turbo": WhisperDims(128, 51866, 1500, 1280, 20, 32, 448, 1280, 20, 4),
    "distil-large-v3": WhisperDims(128, 51866, 1500, 1280, 20, 32, 448, 1280, 20, 2),
}


def sinusoidal_positions(length: int, channels: int) -> np.ndarray:
    """Whisper encoder positional embedding (fixed sinusoids)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _with_logits_weight(params: Params) -> Params:
    dec = params["decoder"]
    dec["token_embed_f32"] = dec["token_embed"].float()
    return params


def init_params(
    seed: int, dims: WhisperDims, dtype: torch.dtype, device: DeviceLike = "cuda"
) -> Params:
    """Random init with the parameter structure of the JAX `init_params`
    (same shapes, scales and zero/one initialisers), drawn from a numpy
    generator seeded with `seed`. The values differ from JAX's."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(x).to(dev, dtype)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def linear(d_in, d_out, bias=True):
        p = {"w": normal((d_in, d_out), d_in**-0.5)}
        if bias:
            p["b"] = const((d_out,), 0.0)
        return p

    def ln(d):
        return {"g": const((d,), 1.0), "b": const((d,), 0.0)}

    def attn(d):
        return {
            "q": linear(d, d),
            "k": linear(d, d, bias=False),  # whisper: no k bias
            "v": linear(d, d),
            "out": linear(d, d),
        }

    def block(d, cross):
        p = {
            "attn_ln": ln(d),
            "attn": attn(d),
            "mlp_ln": ln(d),
            "fc1": linear(d, 4 * d),
            "fc2": linear(4 * d, d),
        }
        if cross:
            p["cross_attn_ln"] = ln(d)
            p["cross_attn"] = attn(d)
        return p

    d_a, d_t = dims.n_audio_state, dims.n_text_state
    encoder = {
        "conv1": {
            "w": normal((d_a, dims.n_mels, 3), (3 * dims.n_mels) ** -0.5),
            "b": const((d_a,), 0.0),
        },
        "conv2": {"w": normal((d_a, d_a, 3), (3 * d_a) ** -0.5), "b": const((d_a,), 0.0)},
        "pos_embed": torch.from_numpy(sinusoidal_positions(dims.n_audio_ctx, d_a)).to(dev, dtype),
        "blocks": [block(d_a, cross=False) for _ in range(dims.n_audio_layer)],
        "ln_post": ln(d_a),
    }
    decoder = {
        "token_embed": normal((dims.n_vocab, d_t), d_t**-0.5),
        "pos_embed": normal((dims.n_text_ctx, d_t), 0.01),
        "blocks": [block(d_t, cross=True) for _ in range(dims.n_text_layer)],
        "ln": ln(d_t),
    }
    return _with_logits_weight({"encoder": encoder, "decoder": decoder})


def _map(fn, tree, key=None):
    """`fn(key, leaf)` over a tree of dicts and lists; `key` is the leaf's
    dict key (a list's items take the list's)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, key) for v in tree]
    return fn(key, tree)


def params_from_numpy(
    tree: dict, device: DeviceLike = "cuda", dtype: torch.dtype = torch.bfloat16
) -> Params:
    """A JAX parameter tree as numpy arrays (`jax.tree.map(np.asarray,
    params)`, layer stacks [L, ...]) → the port's tree on `device`, with
    each layer stack split into a list of per-layer dicts.

    Float leaves become `dtype`, except the weight scales of a quantized
    tree ("scale", "scale4"), which stay bf16 as ops/quant.py makes them;
    integer leaves (int8 "w_q", uint8 "w_q4") keep their dtype."""
    dev = resolve_device(device)

    def leaf(key, x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return torch.from_numpy(np.array(x)).to(dev)
        to = torch.bfloat16 if key in quant.SCALE_KEYS else dtype
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev, to)

    out = {}
    for part in ("encoder", "decoder"):
        blocks = tree[part]["blocks"]
        n_layer = len(blocks["attn_ln"]["g"])
        out[part] = _map(leaf, {k: v for k, v in tree[part].items() if k != "blocks"})
        out[part]["blocks"] = [
            _map(lambda key, a, i=i: leaf(key, a[i]), blocks) for i in range(n_layer)
        ]
    return _with_logits_weight(out)


def params_to_numpy(params: Params) -> dict:
    """Inverse of `params_from_numpy`: numpy arrays with the layer stacks
    re-stacked to [L, ...] and `token_embed_f32` dropped. Float leaves come
    out as float32 (bf16 scales exactly: numpy has no bf16), integer leaves
    in their own dtype."""

    def leaf(_, t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    def stack(blocks):
        if isinstance(blocks[0], dict):
            return {k: stack([b[k] for b in blocks]) for k in blocks[0]}
        return np.stack([leaf(None, b) for b in blocks])

    out = {}
    for part in ("encoder", "decoder"):
        sub = {k: v for k, v in params[part].items() if k not in ("blocks", "token_embed_f32")}
        out[part] = _map(leaf, sub)
        out[part]["blocks"] = stack(params[part]["blocks"])
    return out


# ---------------------------------------------------------------------------
# Forward primitives
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32, cast back to x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p["g"].float(), p["b"].float(), eps)
    return y.to(x.dtype)


def _product(x: torch.Tensor, p: Params, a8: bool = False, group=None) -> torch.Tensor:
    """x @ the weight of `p`, by its form: "w_q4" → W4A16, "w_q" → W8A16
    (W8A8 when `a8`), else the plain product."""
    if "w_q4" in p:
        return quant.quantized_matmul_w4(x, p)
    if "w_q" in p:
        return quant.quantized_matmul_w8a8(x, p, group) if a8 else quant.quantized_matmul(x, p)
    return x @ p["w"]


def dense(x: torch.Tensor, p: Params, a8: bool = False) -> torch.Tensor:
    """Linear layer; dispatches on the weight's form like the JAX `dense`:
    "w_q4" → W4A16, "w_q" → W8A16 (W8A8 when `a8`), else the plain
    product. `a8` is a no-op for unquantized and int4 weights. W8A16 hands
    the bias to `quantized_matmul`, whose kernel adds it to the rounded
    product."""
    if "w_q" in p and not a8:
        return quant.quantized_matmul(x, p, p.get("b"))
    y = _product(x, p, a8)
    if "b" in p:
        y = y + p["b"]
    return y


def dense_siblings(x: torch.Tensor, ps: Sequence[Params]) -> list:
    """`dense(x, p)` for each p of `ps`, linears that share x: W8A16 ones
    together (`quant.quantized_matmul_siblings`: one kernel launch)."""
    if all("w_q" in p for p in ps):
        return quant.quantized_matmul_siblings(x, list(ps), [p.get("b") for p in ps])
    return [dense(x, p) for p in ps]


def _dense_row(x: torch.Tensor, p: Params, a8: bool, tp) -> torch.Tensor:
    """A row-split linear (attention out, fc2): under tp each rank's
    product over its input rows is a partial sum, summed over the ranks,
    and the bias is added once, after the sum. W8A8 sums its exact integer
    accumulators instead, with the activation scale reduced over the
    ranks (`quantized_matmul_w8a8(group=)`), so the sharded product equals
    the unsharded one."""
    if tp is None:
        return dense(x, p, a8)
    if a8 and "w_q" in p:
        y = _product(x, p, a8, tp)
    else:
        y = tp.all_reduce_sum(_product(x, p, a8))
    return y + p["b"] if "b" in p else y


def local_heads(params: Params, n_head: int) -> int:
    """The heads of this tree's rank: n_head / tp under tp, else n_head."""
    tp = params.get("tp")
    return n_head if tp is None else n_head // tp.size


def check_group(params: Params) -> None:
    """Under tp, raise GroupAborted if the rank's group failed on the
    device (a collective timed out, or the group was aborted): the decode
    loops call it after their host syncs. A no-op without tp."""
    tp = params.get("tp")
    if tp is not None:
        tp.check()


def rank_captured(params: Params) -> None:
    """Under tp, this rank has captured its step's CUDA graph: wait there
    for the ranks that share its device (`TPRank.captured`). Every rank
    must call it at the same capture. A no-op without tp."""
    tp = params.get("tp")
    if tp is not None:
        tp.captured()


def gather_alignment(params: Params, align: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Under tp, the alignment buffer with every rank's heads: each rank
    wrote only the slots of the heads it holds into a zero buffer, so the
    sum over the ranks is exact. Every rank must call it. On a card it
    waits for the sum and raises GroupAborted if the group failed: its
    callers (the loops' ends, alignment_forward) hand the buffer to the
    host at once, so the wait costs nothing and no failed sum goes on."""
    tp = params.get("tp")
    if tp is None or align is None:
        return align
    out = tp.all_reduce_sum(align)
    if out.is_cuda:
        torch.cuda.current_stream(out.device).synchronize()
        tp.check()
    return out


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)  # [B,H,T,Dh]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B,H,T,Dh] → [B,T,H·Dh]; a view when x is laid out [B,T,H,Dh] (as
    `mha_encoder` returns it), a copy otherwise."""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _q8_quantize(x32: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over axis `dim` of a float32 tensor → (int8, scale
    f32 with `dim` kept as 1); round half to even, clip ±127, scale floor
    1e-8 (the JAX recipe)."""
    scale = torch.clamp_min(x32.abs().amax(dim=dim, keepdim=True) / 127.0, 1e-8)
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8), scale


def _q8_row_quantize(x32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 over the last axis → (int8, scale f32 [..., 1])."""
    return _q8_quantize(x32, -1)


def _q8_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 over the last (Dh) axis for the int8 self-KV cache:
    (q8, scale f32 [..., 1]) with x ≈ q8 * scale. Each written row carries
    its own scale, so the cache quantizes incrementally at write time."""
    return _q8_row_quantize(x.float())


def _self_kv_write(cache, new: torch.Tensor, pos) -> None:
    """Write one layer's new K/V rows [B,H,T,Dh] into its cache at
    positions [pos, pos+T), quantizing on write when the cache is the int8
    {"q8", "scale"} form. `pos` is an int, or the T slots as a 1-d int64
    tensor on the cache's device (written by `index_copy_`, so a CUDA
    graph of the step writes wherever the position then points).

    In place, where the JAX version returns an updated cache: the cache is
    the largest decode-time buffer, and eager torch cannot alias a
    functional update the way XLA does inside jit, so a copy per step
    would double the step's cache traffic."""
    t = new.shape[2]
    parts = dict(zip(("q8", "scale"), _q8_rows(new))) if isinstance(cache, dict) else {None: new}
    for key, rows in parts.items():
        dst = cache if key is None else cache[key]
        if isinstance(pos, torch.Tensor):
            dst.index_copy_(2, pos, rows)
        else:
            dst[:, :, pos : pos + t] = rows


def _attend_self_q8(q, k, v, mask):
    """Self-attention over the int8 per-token-scale cache, any number of
    query rows (the prefill; the T==1 step runs the same math in K5).
    k/v: {"q8": int8 [B,H,S,Dh], "scale": f32 [B,H,S,1]}. The query is
    scaled by dh^-0.5 in float32 and row-quantized; the rest is the plain
    version of K5, whose integer dots are exact in float32 here."""
    dh = q.shape[-1]
    qi, q_scale = _q8_row_quantize(q.float() * dh**-0.5)
    out = self_attend_q8_reference(qi, q_scale, k["q8"], k["scale"], v["q8"], v["scale"], mask)
    return out.to(q.dtype)


def _attend(q, k, v, mask=None, force_f32_scores=False, return_probs=False):
    """Plain attention, q [B,H,Tq,Dh], k/v [B,H,Tk,Dh]; Whisper scales q
    and k by dh^-0.25. Scores are float32 when an operand is float32 or
    when `force_f32_scores` (the raw decode cross path), else in the
    operands' dtype. An int8 {"q8", "scale"} cache goes to
    `_attend_self_q8`. `return_probs` also returns the softmax in
    float32 (raw operands only)."""
    if isinstance(k, dict):
        return _attend_self_q8(q, k, v, mask)
    scale = q.shape[-1] ** -0.25
    qs, ks = q * scale, k * scale
    if force_f32_scores or q.dtype == torch.float32 or k.dtype == torch.float32:
        scores = qs.float() @ ks.float().transpose(-1, -2)
    else:
        scores = qs @ ks.transpose(-1, -2)
    if mask is not None:
        scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1)
    out = probs.to(v.dtype) @ v
    return (out, probs.float()) if return_probs else out


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _conv1d(x, w, b, stride):
    """x [B, C_in, T], w [C_out, C_in, K], 'same' padding."""
    return F.conv1d(x.to(w.dtype), w, b, stride=stride, padding=1)


def encoder_forward(
    params: Params, mel: torch.Tensor, dims: WhisperDims, act8: bool = False, seq_group=None,
) -> torch.Tensor:
    """mel [B, n_mels, 3000] → encoder output [B, 1500, d_audio].

    act8: W8A8, the "w8a8" scheme: int8-quantized block linears (q, k, v,
    out, fc1, fc2) run with int8 activations (`dense(a8=True)`); attention
    and the convolutions stay as they are. No-op on unquantized weights.

    seq_group: a TPRank (parallel/sharding.encoder_seq_sharding), the
    sequence-parallel mode over replicated weights: the convolutions run
    on the whole mel, then rank r keeps frames [r·T/tp, (r+1)·T/tp); the
    norms, projections and MLP run on those frames, each attention layer
    all-gathers K and V and runs K2 with the rank's queries over all keys,
    and the ranks' outputs are gathered at the end, so every rank returns
    the whole [B, 1500, d_audio]."""
    enc = params["encoder"]
    tp = params.get("tp")
    n_head = local_heads(params, dims.n_audio_head)
    x = _gelu(_conv1d(mel, enc["conv1"]["w"], enc["conv1"]["b"], 1))
    x = _gelu(_conv1d(x, enc["conv2"]["w"], enc["conv2"]["b"], 2))
    x = x.transpose(1, 2)  # [B, T=1500, D]
    x = x + enc["pos_embed"].to(x.dtype)
    if seq_group is not None:
        if tp is not None:
            raise ValueError("the sequence-parallel encoder takes replicated weights, not a tp shard")
        frames = x.shape[1]
        if frames % seq_group.size:
            raise ValueError(f"{frames} frames do not split over {seq_group.size} ranks")
        per = frames // seq_group.size
        x = x[:, seq_group.rank * per : (seq_group.rank + 1) * per]
    for bp in enc["blocks"]:
        h = layer_norm(x, bp["attn_ln"])
        # head-split views in, [B, S, H, Dh] memory out: no copies either side
        q = _split_heads(dense(h, bp["attn"]["q"], act8), n_head)
        k = dense(h, bp["attn"]["k"], act8)
        v = dense(h, bp["attn"]["v"], act8)
        if seq_group is not None:
            k, v = seq_group.all_gather(k, 1), seq_group.all_gather(v, 1)
        k, v = _split_heads(k, n_head), _split_heads(v, n_head)
        x = x + _dense_row(_merge_heads(mha_encoder(q, k, v)), bp["attn"]["out"], act8, tp)
        h = layer_norm(x, bp["mlp_ln"])
        x = x + _dense_row(_gelu(dense(h, bp["fc1"], act8)), bp["fc2"], act8, tp)
    x = layer_norm(x, enc["ln_post"])
    return x if seq_group is None else seq_group.all_gather(x, 1)


# ---------------------------------------------------------------------------
# Cross-attention K/V
# ---------------------------------------------------------------------------


def compute_cross_kv(params: Params, enc_out: torch.Tensor, dims: WhisperDims):
    """Per-layer cross-attention K/V: (k, v), each [L, B, H, 1500, Dh]
    (H / tp heads under tp)."""
    n_head = local_heads(params, dims.n_text_head)
    ks, vs = [], []
    for bp in params["decoder"]["blocks"]:
        ks.append(_split_heads(dense(enc_out, bp["cross_attn"]["k"]), n_head))
        vs.append(_split_heads(dense(enc_out, bp["cross_attn"]["v"]), n_head))
    return torch.stack(ks), torch.stack(vs)


def compute_cross_kv_quantized(params: Params, enc_out: torch.Tensor, dims: WhisperDims):
    """Project and int8-quantize the cross-attention K/V one layer at a
    time, so at most one layer's bf16 K/V exists at once.

    Returns ({"q8", "scale"}, {"q8", "scale"}) with q8 [L,B,H,1500,Dh]
    int8 and scale [L,B,H,1,Dh] f32 (H / tp heads under tp).
    """
    n_head, n_layer = local_heads(params, dims.n_text_head), dims.n_text_layer
    b, frames, _ = enc_out.shape
    shape = (n_layer, b, n_head, frames, dims.head_dim)
    scale_shape = (n_layer, b, n_head, 1, dims.head_dim)
    dev = enc_out.device
    k8 = {"q8": torch.empty(shape, dtype=torch.int8, device=dev),
          "scale": torch.empty(scale_shape, dtype=torch.float32, device=dev)}
    v8 = {"q8": torch.empty(shape, dtype=torch.int8, device=dev),
          "scale": torch.empty(scale_shape, dtype=torch.float32, device=dev)}
    for li, bp in enumerate(params["decoder"]["blocks"]):
        for out, name in ((k8, "k"), (v8, "v")):
            # per-channel (Dh) scales over the frame axis
            x = _split_heads(dense(enc_out, bp["cross_attn"][name]), n_head)
            q8, scale = _q8_quantize(x.float(), -2)
            out["q8"][li] = q8
            out["scale"][li] = scale
    return k8, v8


def _layer(cross, li):
    if isinstance(cross, dict):
        return {k: v[li] for k, v in cross.items()}
    return cross[li]


def _cross_attend(cq, ck, cv, probs_out=None, probs_slots=None):
    """Cross-attention over one layer's cached K/V: raw [B,H,1500,Dh]
    tensors (plain attention, float32 scores), or int8 {"q8", "scale"}
    dicts (the int8 kernel, any number of query rows).

    With `probs_out` ([B,A,T,1500] f32) and `probs_slots` (per head, its
    index on probs_out's axis 1 or -1), the float32 softmax of the heads
    with a slot is written there too (the JAX `capture_probs`): by K3's
    probs form over the int8 cross-KV, from the plain softmax over the raw
    one."""
    if not isinstance(ck, dict):
        if probs_out is None:
            return _attend(cq, ck, cv, force_f32_scores=True)
        out, probs = _attend(cq, ck, cv, force_f32_scores=True, return_probs=True)
        write_head_probs(probs, probs_out, probs_slots)
        return out
    scale = cq.shape[-1] ** -0.25  # same dh^-.25 on q as _attend (k's is folded)
    qs = cq.float() * (scale * scale) * ck["scale"]
    qi, q_scale = _q8_row_quantize(qs)
    capture = {} if probs_out is None else {"probs_out": probs_out, "probs_slots": probs_slots}
    out = cross_attend_q8(qi.contiguous(), q_scale.contiguous(), ck["q8"], cv["q8"], cv["scale"], **capture)
    return out.to(cq.dtype)


def head_slots(alignment_heads: Sequence[Sequence[int]], n_layer: int, n_head: int) -> list[Optional[list[int]]]:
    """Per decoder layer, the slot of each head in the alignment axis (the
    index of its (layer, head) pair in `alignment_heads`, the order of the
    JAX `_gather_alignment`), -1 for heads outside it; None for a layer
    without an alignment head."""
    per_layer: list[Optional[list[int]]] = [None] * n_layer
    for a, (layer, head) in enumerate(alignment_heads):
        layer, head = int(layer), int(head)
        if not (0 <= layer < n_layer and 0 <= head < n_head):
            raise ValueError(f"alignment head ({layer}, {head}) is outside {n_layer} layers x {n_head} heads")
        if per_layer[layer] is None:
            per_layer[layer] = [-1] * n_head
        if per_layer[layer][head] >= 0:
            raise ValueError(f"alignment head ({layer}, {head}) is named twice")
        per_layer[layer][head] = a
    return per_layer


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def init_kv_cache(
    dims: WhisperDims, batch: int, length: int, dtype, device, quantize: bool = False,
    n_head: Optional[int] = None,
):
    """Self-attention KV cache (k, v): two [L, B, H, length, Dh] zero
    tensors of `dtype`, or with `quantize` the int8 form, two
    {"q8": int8 [L, B, H, length, Dh], "scale": f32 [L, B, H, length, 1]}
    dicts, zero-filled (the JAX prefill's allocation). `n_head` overrides
    H (a tp rank's `local_heads`)."""
    shape = (dims.n_text_layer, batch, n_head or dims.n_text_head, length, dims.head_dim)

    def one():
        if quantize:
            return {
                "q8": torch.zeros(shape, dtype=torch.int8, device=device),
                "scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
            }
        return torch.zeros(shape, dtype=dtype, device=device)

    return one(), one()


def _self_attend_step(q, kk, vv, mask_row):
    """T==1 self-attention of one layer over its cache through the kernels:
    K4 over the raw cache (q scaled by dh^-0.5 in its dtype, then float32),
    K5 over the int8 cache (q cast to float32, scaled, row-quantized: the
    JAX Pallas-gate recipe, the kernel form of `_attend_self_q8`)."""
    dh = q.shape[-1]
    if isinstance(kk, dict):
        qi, q_scale = _q8_row_quantize(q.float() * dh**-0.5)
        out = self_attend_q8(
            qi.contiguous(), q_scale.contiguous(), kk["q8"], kk["scale"],
            vv["q8"], vv["scale"], mask_row,
        )
    else:
        out = self_attend((q * dh**-0.5).float().contiguous(), kk, vv, mask_row)
    return out.to(q.dtype)


def decoder_forward(
    params: Params,
    tokens: torch.Tensor,  # [B, T] int
    pos_offset,  # position of tokens[:, 0]: an int, or a 0-d int64 tensor on the device
    kv_k,  # [L, B, H, S, Dh] or int8 {"q8", "scale"}, written in place
    kv_v,
    cross_k,  # [L, B, H, 1500, Dh] or int8 {"q8", "scale"}
    cross_v,
    dims: WhisperDims,
    mask_row: Optional[torch.Tensor] = None,
    alignment_heads: Optional[Sequence[Sequence[int]]] = None,
    align_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run T tokens through the decoder → logits [B, T, V] float32.

    With `alignment_heads` ((layer, head) pairs) and `align_out` (f32
    [T, B, A, 1500], e.g. the decode loop's alignment buffer at these
    positions), the cross-attention probabilities of those heads are
    written into `align_out` (the JAX `capture_alignment` followed by
    `_gather_alignment`); on the int8 cross-KV the layers that hold an
    alignment head run K3's probs form, the others the plain K3.

    Unlike the JAX version, which returns an updated cache, this writes the
    new keys and values into `kv_k`/`kv_v` IN PLACE at positions
    [pos_offset, pos_offset + T) (`_self_kv_write`). The cache is raw
    tensors or the int8 per-token-scale form (`init_kv_cache(quantize=
    True)`), whose rows are quantized as they are written.

    T > 1 (prefill) attends with plain torch under a causal mask; T == 1
    (the decode step) runs the self-attention kernel over the cache (K4
    raw, K5 int8) with the additive mask row (0 up to `pos_offset`, -inf
    after), which the caller may pass in (`mask_row`, [1, S] float32) to
    avoid rebuilding it.

    `pos_offset` may be a 0-d int64 tensor on the tokens' device (the
    decode loop's device-side position, as JAX's traced `pos`): then no
    host int slices `pos_embed` (`index_select` at pos_offset + [0, T)) or
    the cache (`index_copy_` at those T slots), and the masks are built on
    the device, so a CUDA graph of the step replays at every position. The
    decode loop gives the T == 1 step its own mask row and, with alignment
    heads, a [1, B, A, frames] staging `align_out` that it copies to the
    position's row itself; at T > 1 (speculative decoding's verify pass)
    the causal mask covers the whole cache, as at an int position.
    """
    dec = params["decoder"]
    tp = params.get("tp")
    b, t = tokens.shape
    n_head = local_heads(params, dims.n_text_head)
    s_max = (kv_k["q8"] if isinstance(kv_k, dict) else kv_k).shape[3]
    dev = tokens.device

    kv_at = pos_offset  # the K/V rows' place: an int, or with a tensor position the T slots, [T] int64
    if isinstance(pos_offset, torch.Tensor):
        kv_at = pos_offset.view(1) if t == 1 else pos_offset + torch.arange(t, device=dev)
    x = dec["token_embed"][tokens]
    if isinstance(kv_at, torch.Tensor):
        pos = dec["pos_embed"].index_select(0, kv_at)
    else:
        pos = dec["pos_embed"][pos_offset : pos_offset + t]
    x = (x + pos[None]).to(dec["token_embed"].dtype)

    if t == 1 and mask_row is None:
        key_pos = torch.arange(s_max, device=dev)[None, :]
        mask_row = torch.zeros((1, s_max), dtype=torch.float32, device=dev)
        mask_row = mask_row.masked_fill(key_pos > pos_offset, float("-inf"))
    elif t > 1:
        key_pos = torch.arange(s_max, device=dev)[None, :]
        query_pos = pos_offset + torch.arange(t, device=dev)[:, None]
        mask = torch.zeros((t, s_max), dtype=torch.float32, device=dev)
        mask = mask.masked_fill(key_pos > query_pos, float("-inf"))[None, None]

    if (alignment_heads is None) != (align_out is None):
        raise ValueError("alignment_heads and align_out go together")
    slots = [None] * dims.n_text_layer
    if align_out is not None:
        slots = head_slots(alignment_heads, dims.n_text_layer, dims.n_text_head)
        if tp is not None:  # this rank's heads; a layer without one of them runs plain K3
            hs = tp.head_slice(dims.n_text_head)
            slots = [None if s is None or max(s[hs]) < 0 else s[hs] for s in slots]
        if align_out.shape[:3] != (t, b, len(alignment_heads)):
            raise ValueError(f"align_out: expected [{t}, {b}, {len(alignment_heads)}, frames], "
                             f"got {tuple(align_out.shape)}")
        probs_view = align_out.permute(1, 2, 0, 3)  # [B, A, T, frames]

    for li, bp in enumerate(dec["blocks"]):
        kk, vv = _layer(kv_k, li), _layer(kv_v, li)
        h = layer_norm(x, bp["attn_ln"])
        q, k, v = dense_siblings(h, [bp["attn"]["q"], bp["attn"]["k"], bp["attn"]["v"]])
        q = _split_heads(q, n_head)
        _self_kv_write(kk, _split_heads(k, n_head), kv_at)
        _self_kv_write(vv, _split_heads(v, n_head), kv_at)
        if t == 1:
            attn = _self_attend_step(q, kk, vv, mask_row)
        else:
            attn = _attend(q, kk, vv, mask)
        x = x + _dense_row(_merge_heads(attn), bp["attn"]["out"], False, tp)

        h = layer_norm(x, bp["cross_attn_ln"])
        cq = _split_heads(dense(h, bp["cross_attn"]["q"]), n_head)
        capture = {} if slots[li] is None else {"probs_out": probs_view, "probs_slots": slots[li]}
        cross_out = _cross_attend(cq, _layer(cross_k, li), _layer(cross_v, li), **capture)
        x = x + _dense_row(_merge_heads(cross_out), bp["cross_attn"]["out"], False, tp)

        h = layer_norm(x, bp["mlp_ln"])
        x = x + _dense_row(_gelu(dense(h, bp["fc1"])), bp["fc2"], False, tp)

    x = layer_norm(x, dec["ln"])
    # float32 operands: the JAX einsum accumulates and returns float32
    return x.float() @ dec["token_embed_f32"].T
