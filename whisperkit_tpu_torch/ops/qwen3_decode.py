"""The float32 glue of a Qwen3 decode layer pass (models/qwen3_tts.py
`_qwen3_layers`): the TTS talker's frame step and the code predictor's
passes.

  add_rms_norm      the residual add and the next RMSNorm: s = x + y,
                    h = rms_norm(s, g)
  decode_attention  the per-head q/k RMSNorm, rotary, the cache write at
                    the slot and GQA attention over the cache
  swiglu            silu(gate) · up

For CUDA tensors each launches its hand-written kernel in
csrc/qwen3_decode.cu and raises on what the kernel does not take; for CPU
tensors it runs the plain version beside it, which is the layer's own
composition of PyTorch ops, rounding point for rounding point: the
Qwen3 stacks that the kernels do not take (the talker's prefill, the
Code2Wav pre-transformer, every CPU call) run the plain versions.
`qwen3_decode_takes` says which stacks take the kernels: CUDA bf16 stacks
at decode shapes.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from whisperkit_tpu_torch.ops import _build

# what the kernels take (csrc/qwen3_decode.cu): queries a row, the head
# width, query heads a KV head, keys attended, features a norm row
MAX_T = 2
HEAD_DIM = 128
MAX_REP = 4
MAX_KEYS = 2048
NORM_MAX_D = 8192


def qwen3_decode_takes(
    device_type: str,
    dtypes: Sequence[torch.dtype],
    *,
    t: int,
    n_head: int,
    n_kv_head: int,
    head_dim: int,
    n_keys: int,
    d_model: int,
    qk_norm: bool,
    layer_scale: bool,
) -> bool:
    """Whether a Qwen3 layer stack runs its glue in the kernels: a CUDA
    stack whose activations, KV cache and norm weights (`dtypes`) are all
    bf16, at T ≤ MAX_T positions a row, head_dim 128, at most MAX_REP query
    heads a KV head, at most MAX_KEYS keys attended, per-head q/k norms
    and no LayerScale. Every other stack, and every CPU stack, takes the
    plain versions."""
    return (device_type == "cuda" and all(d == torch.bfloat16 for d in dtypes)
            and 1 <= t <= MAX_T and head_dim == HEAD_DIM and n_kv_head > 0 and n_head % n_kv_head == 0
            and n_head // n_kv_head <= MAX_REP and 1 <= n_keys <= MAX_KEYS
            and d_model % 8 == 0 and d_model <= NORM_MAX_D and qk_norm and not layer_scale)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """JAX's x32 * rsqrt(mean(x32²) + eps) * g32, cast back to x's dtype;
    `F.rms_norm` computes it so (one kernel on the card)."""
    return F.rms_norm(x.float(), (x.shape[-1],), g.float(), eps).to(x.dtype)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, Dh]; rotary on half-split pairs (HF rotate_half), in
    float32: [x1·cos − x2·sin, x2·cos + x1·sin], as x·[cos, cos] + [x2, x1]·[−sin, sin]
    (the same products and sums)."""
    half = x.shape[-1] // 2
    x32 = x.float()
    return (x32 * cos + torch.cat([x32[..., half:], x32[..., :half]], dim=-1) * sin).to(x.dtype)


def add_rms_norm_reference(x: torch.Tensor, y: Optional[torch.Tensor], g: torch.Tensor,
                           eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, h): s = x + y in x's dtype (x itself when y is None), h =
    rms_norm(s, g, eps)."""
    s = x if y is None else x + y
    return s, rms_norm(s, g, eps)


def swiglu_reference(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) · up, each rounded to the inputs' dtype."""
    return F.silu(gate) * up


def decode_attention_reference(
    q: torch.Tensor,  # [B, T, H·Dh]: the q projection
    k: torch.Tensor,  # [B, T, KVH·Dh]
    v: torch.Tensor,  # [B, T, KVH·Dh]
    qnorm: Optional[torch.Tensor],  # [Dh], or None: no per-head q/k norms
    knorm: Optional[torch.Tensor],
    cos: torch.Tensor,  # [B, T, 1, Dh] float32, from `_rope_angles`
    sin: torch.Tensor,
    cache_k: torch.Tensor,  # [B, KVH, S, Dh]: this layer's cache, written in place
    cache_v: torch.Tensor,
    pos_offset: Union[int, torch.Tensor],  # cache slot of position 0: an int or a 0-d int64 tensor
    mask: torch.Tensor,  # [.., .., T, keys attended] additive float32
    *,
    n_head: int,
    n_kv_head: int,
    eps: float,
) -> torch.Tensor:
    """One layer's attention → [B, T, H·Dh]: q and k normed per head (when
    `qnorm` is given) and rotated, K/V written at slots [pos_offset,
    pos_offset + T) of the cache, then keys [0, pos_offset + T) attended,
    or, at a tensor slot, every key of the cache: each KV head repeated for
    its query heads, float32 scores over sqrt(Dh) plus the mask, a float32
    softmax rounded to the values' dtype, P·V."""
    b, t, _ = q.shape
    h, kvh = n_head, n_kv_head
    dh = cache_k.shape[-1]
    rep = h // kvh
    q = q.reshape(b, t, h, dh)
    k = k.reshape(b, t, kvh, dh)
    v = v.reshape(b, t, kvh, dh)
    if qnorm is not None:
        q = rms_norm(q, qnorm, eps)
        k = rms_norm(k, knorm, eps)
    q = rope(q, cos, sin)
    k = rope(k, cos, sin)
    if isinstance(pos_offset, torch.Tensor):
        slots = pos_offset + torch.arange(t, device=q.device)
        cache_k.index_copy_(2, slots, k.transpose(1, 2))
        cache_v.index_copy_(2, slots, v.transpose(1, 2))
        end = cache_k.shape[2]
    else:
        end = pos_offset + t
        cache_k[:, :, pos_offset:end] = k.transpose(1, 2)
        cache_v[:, :, pos_offset:end] = v.transpose(1, 2)
    # each KV head repeated for its `rep` query heads: [B, H, S, Dh]
    kfull = cache_k[:, :, None, :end].expand(b, kvh, rep, end, dh).reshape(b, h, end, dh)
    vfull = cache_v[:, :, None, :end].expand(b, kvh, rep, end, dh).reshape(b, h, end, dh)
    scores = (q.transpose(1, 2).float() @ kfull.float().transpose(-1, -2)) / math.sqrt(dh)
    probs = torch.softmax(scores + mask, dim=-1).to(vfull.dtype)
    return (probs @ vfull).transpose(1, 2).reshape(b, t, h * dh)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------


def _bf16_rows(name: str, x: torch.Tensor) -> torch.Tensor:
    """x as a contiguous, 16-byte aligned bf16 CUDA tensor (copied when it
    is not contiguous or aligned)."""
    _build.check_cuda(name, x, torch.bfloat16, x.dim(), contiguous=False)
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    return x


def add_rms_norm(x: torch.Tensor, y: Optional[torch.Tensor], g: torch.Tensor,
                 eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """`add_rms_norm_reference` for x, y [..., D] bf16 and g [D] bf16:
    (s, h). CUDA: one launch (csrc/qwen3_decode.cu); CPU: the plain
    version."""
    if not x.is_cuda:
        return add_rms_norm_reference(x, y, g, eps)
    d = x.shape[-1]
    if d % 8 or d > NORM_MAX_D:
        raise ValueError(f"add_rms_norm takes a multiple of 8 features, at most {NORM_MAX_D}, got {d}")
    x2 = _bf16_rows("x", x)
    y2 = None if y is None else _bf16_rows("y", y)
    if y2 is not None and y2.shape != x2.shape:
        raise ValueError(f"add_rms_norm: y {tuple(y2.shape)} is not x's {tuple(x2.shape)}")
    _build.check_cuda("g", g, torch.bfloat16, 1)
    if g.shape[0] != d or g.data_ptr() % 16:
        raise ValueError(f"add_rms_norm: g must be [{d}] and 16-byte aligned, got {tuple(g.shape)}")
    if any(t is not None and t.device != x.device for t in (y2, g)):
        raise ValueError(f"add_rms_norm: x is on {x.device}, y or g is not")
    h = torch.empty_like(x2)
    s = x2 if y2 is None else torch.empty_like(x2)
    _build.launch("qwen3_add_rms_norm", "wk_qwen3_add_rms_norm", x.device, _build.ptr(x2),
                  None if y2 is None else _build.ptr(y2), _build.ptr(g), None if y2 is None else _build.ptr(s),
                  _build.ptr(h), x2.numel() // d, d, eps)
    return s, h


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """`swiglu_reference` for bf16 gate and up of one shape. CUDA: one
    launch (csrc/qwen3_decode.cu); CPU: the plain version."""
    if not gate.is_cuda:
        return swiglu_reference(gate, up)
    gate, up = _bf16_rows("gate", gate), _bf16_rows("up", up)
    if gate.shape != up.shape or gate.device != up.device:
        raise ValueError(f"swiglu: gate {tuple(gate.shape)} and up {tuple(up.shape)} differ")
    out = torch.empty_like(gate)
    _build.launch("qwen3_swiglu", "wk_qwen3_swiglu", gate.device, _build.ptr(gate), _build.ptr(up),
                  _build.ptr(out), gate.numel())
    return out


def _score_scale(dh: int) -> float:
    """1 / sqrt(dh) as the card's division by a host scalar forms it: the
    float32 reciprocal of the float32 divisor."""
    return float(np.float32(1.0) / np.float32(math.sqrt(dh)))


def decode_attention(q, k, v, qnorm, knorm, cos, sin, cache_k, cache_v, pos_offset, mask, *,
                     n_head: int, n_kv_head: int, eps: float) -> torch.Tensor:
    """`decode_attention_reference` at decode shapes: bf16 q, k, v, norms
    and cache, T ≤ MAX_T, Dh 128, at most MAX_REP query heads a KV head,
    and the mask [1 or B, 1, T, keys] float32 with unit stride over the
    keys. CUDA: one launch (csrc/qwen3_decode.cu); CPU: the plain
    version."""
    if not q.is_cuda:
        return decode_attention_reference(q, k, v, qnorm, knorm, cos, sin, cache_k, cache_v, pos_offset, mask,
                                          n_head=n_head, n_kv_head=n_kv_head, eps=eps)
    b, t, hd = q.shape
    h, kvh = n_head, n_kv_head
    dh = cache_k.shape[-1] if cache_k.dim() == 4 else 0
    if not (1 <= t <= MAX_T and dh == HEAD_DIM and kvh > 0 and h % kvh == 0 and h // kvh <= MAX_REP):
        raise ValueError(f"decode_attention takes 1-{MAX_T} positions, head dim {HEAD_DIM} and at most {MAX_REP} "
                         f"query heads a KV head; got T {t}, cache {tuple(cache_k.shape)}, heads {h} / {kvh}")
    for name, x, shape in (("q", q, (b, t, h * dh)), ("k", k, (b, t, kvh * dh)), ("v", v, (b, t, kvh * dh)),
                           ("qnorm", qnorm, (dh,)), ("knorm", knorm, (dh,))):
        _build.check_cuda(name, x, torch.bfloat16, len(shape))
        if tuple(x.shape) != shape:
            raise ValueError(f"decode_attention: {name} {tuple(x.shape)}, expected {shape}")
    s = cache_k.shape[2]
    for name, x in (("cache_k", cache_k), ("cache_v", cache_v)):
        _build.check_cuda(name, x, torch.bfloat16, 4)
        if tuple(x.shape) != (b, kvh, s, dh):
            raise ValueError(f"decode_attention: {name} {tuple(x.shape)}, expected {(b, kvh, s, dh)}")
    for name, x in (("cos", cos), ("sin", sin)):
        _build.check_cuda(name, x, torch.float32, 4)
        if tuple(x.shape) != (b, t, 1, dh):
            raise ValueError(f"decode_attention: {name} {tuple(x.shape)}, expected {(b, t, 1, dh)}")
    if isinstance(pos_offset, torch.Tensor):
        _build.check_cuda("pos_offset", pos_offset, torch.int64, 0)
        slot_ptr, slot, n_keys = _build.ptr(pos_offset), 0, s
    else:
        slot_ptr, slot, n_keys = None, int(pos_offset), int(pos_offset) + t
        if not 0 <= slot or n_keys > s:
            raise ValueError(f"decode_attention: slots [{slot}, {n_keys}) outside a cache of {s}")
    _build.check_cuda("mask", mask, torch.float32, 4, contiguous=False)
    if (mask.shape[0] not in (1, b) or mask.shape[1] != 1 or tuple(mask.shape[2:]) != (t, n_keys)
            or mask.stride(-1) != 1):
        raise ValueError(f"decode_attention: mask {tuple(mask.shape)} (strides {mask.stride()}), expected "
                         f"[1 or {b}, 1, {t}, {n_keys}] with unit stride over the keys")
    if n_keys > MAX_KEYS:
        raise ValueError(f"decode_attention attends at most {MAX_KEYS} keys, got {n_keys}")
    tensors = (q, k, v, qnorm, knorm, cos, sin, cache_k, cache_v, mask, pos_offset)
    if any(isinstance(x, torch.Tensor) and x.device != q.device for x in tensors):
        raise ValueError(f"decode_attention: q is on {q.device}, another operand is not")
    if any(x.data_ptr() % 16 for x in tensors[:9]):
        raise ValueError("decode_attention: q, k, v, the norms, cos, sin and the cache must be 16-byte aligned")
    out = torch.empty((b, t, h * dh), dtype=torch.bfloat16, device=q.device)
    mask_b = 0 if mask.shape[0] == 1 else mask.stride(0)
    _build.launch(
        "qwen3_decode_attention", "wk_qwen3_decode_attention", q.device,
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(qnorm), _build.ptr(knorm), _build.ptr(cos),
        _build.ptr(sin), _build.ptr(cache_k), _build.ptr(cache_v), slot_ptr, slot, _build.ptr(mask), mask_b,
        mask.stride(2), _build.ptr(out), b, t, h, kvh, s, n_keys, eps, _score_scale(dh),
    )
    return out
