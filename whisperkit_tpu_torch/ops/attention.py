"""Encoder multi-head attention (port of whisperkit_tpu/ops/attention.py).

`mha_encoder` is non-causal attention of q [B, H, Sq, 64] over k/v
[B, H, Sk, 64] in bf16 or f32 (Sq = Sk = 1500 in the encoder; Sq < Sk in
its sequence-parallel mode, where each rank holds its own query rows and
all the keys). For CUDA tensors it launches the hand-written kernel in
csrc/mha_encoder.cu (bf16: TMA loads and warp-specialised wgmma; f32: the
scalar kernel); for CPU tensors it runs `mha_encoder_reference`, the plain
torch version of the same math and rounding points:

  * q is scaled by dh^-0.5 and rounded to q's dtype before the score dot
    (Whisper's dh^-0.25 on both q and k, folded into q);
  * scores and the softmax are float32;
  * probabilities are rounded to v's dtype before the PV product;
  * the output has q's dtype.

q/k/v may be any views whose last dimension is contiguous (the head-split
views of the projections). The result is a [B, H, Sq, 64] view of memory
laid out [B, Sq, H, 64], so that merging the heads back is a view too.
The bf16 kernel loads each of q, k, v through a TMA tensor map of the
view itself (`tensor_map_args`), so their bases and strides must be
multiples of 16 bytes; the wrapper raises otherwise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from whisperkit_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)


def mha_encoder_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel, q [B, H, Sq, Dh], k/v
    [B, H, Sk, Dh] → [B, H, Sq, Dh]."""
    scale = q.shape[-1] ** -0.5
    qs = (q * scale).to(q.dtype)
    scores = qs.float() @ k.float().transpose(-1, -2)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return (probs.float() @ v.float()).to(q.dtype)


# the bf16 kernel's tiles (csrc/mha_encoder.cu): query rows per block, keys
# per K/V tile, depth of the K/V ring
BLOCK_Q, BLOCK_K, STAGES = 128, 128, 2


class TensorMapArgs(NamedTuple):
    """What csrc/mha_encoder.cu's `encode_map` passes to
    cuTensorMapEncodeTiled for one of q, k, v [B, H, rows, 64]."""

    dims: tuple  # (64, rows, H, B), innermost first
    strides: tuple  # bytes between rows, heads, batch rows
    box: tuple  # (64, box rows, 1, 1): one copy lands this many rows


def tensor_map_args(name: str, t: torch.Tensor, box_rows: int) -> TensorMapArgs:
    """The tensor-map arguments of the bf16 view `t` [B, H, rows, 64], as
    the C side encodes them: a dimension of size 1 takes the packed stride
    (torch gives it any stride; its coordinate is always 0). Raises
    ValueError on a layout TMA refuses: a head dim other than 64 or not
    contiguous, a base or a stride that is not a positive multiple of 16
    bytes below 2^40, a dimension past 2^32."""
    b, h, rows, dh = t.shape
    if dh != 64 or t.stride(-1) != 1:
        raise ValueError(f"{name}: the head dimension must be 64 and contiguous, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the base must be 16-byte aligned for TMA (address {t.data_ptr():#x})")
    size = t.element_size()
    row = dh * size if rows == 1 else t.stride(2) * size
    head = row * rows if h == 1 else t.stride(1) * size
    batch = head * h if b == 1 else t.stride(0) * size
    for what, stride in (("row", row), ("head", head), ("batch", batch)):
        if stride <= 0 or stride % 16 or stride >= 2**40:
            raise ValueError(f"{name}: a {what} stride of {stride} bytes; TMA takes positive multiples of "
                             "16 bytes below 2^40")
    if max(b, h, rows) > 2**32:
        raise ValueError(f"{name}: shape {tuple(t.shape)} has a dimension past 2^32")
    return TensorMapArgs((dh, rows, h, b), (row, head, batch), (dh, box_rows, 1, 1))


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"mha_encoder takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_cuda(name, t, q.dtype, 4, contiguous=False)
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, q on {q.device}")
        if t.shape[:2] != q.shape[:2] or t.shape[3] != q.shape[3] or (t is not q and t.shape[2] != k.shape[2]):
            raise ValueError(f"{name}: shape {tuple(t.shape)} does not match q {tuple(q.shape)} "
                             f"and k {tuple(k.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
        if q.dtype == torch.bfloat16:
            tensor_map_args(name, t, BLOCK_Q if name == "q" else BLOCK_K)
    if q.shape[-1] != 64:
        raise ValueError(f"mha_encoder takes head dim 64, got {q.shape[-1]}")


def mha_encoder(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal MHA, q [B, H, Sq, 64] over k/v [B, H, Sk, 64] →
    [B, H, Sq, 64] in q's dtype, laid out [B, Sq, H, 64] in memory."""
    b, h, s_q, dh = q.shape
    out = torch.empty((b, s_q, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    if not q.is_cuda:
        return out.copy_(mha_encoder_reference(q, k, v))
    _check_cuda(q, k, v)
    strides = (ctypes.c_longlong * 9)(*(x for t in (q, k, v) for x in t.stride()[:3]))
    _build.launch(
        "mha_encoder", "wk_mha_encoder", q.device,
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), strides,
        b, h, s_q, k.shape[2], int(q.dtype == torch.bfloat16), float(dh) ** -0.5,
    )
    return out
