"""Encoder multi-head attention (port of whisperkit_tpu/ops/attention.py).

`mha_encoder` is non-causal attention of q [B, H, Sq, 64] over k/v
[B, H, Sk, 64] in bf16 or f32 (Sq = Sk = 1500 in the encoder; Sq < Sk in
its sequence-parallel mode, where each rank holds its own query rows and
all the keys). For CUDA tensors it launches the hand-written kernel in
csrc/mha_encoder.cu (bf16: tensor cores; f32: the scalar kernel); for CPU
tensors it runs `mha_encoder_reference`, the plain torch version of the
same math and rounding points:

  * q is scaled by dh^-0.5 and rounded to q's dtype before the score dot
    (Whisper's dh^-0.25 on both q and k, folded into q);
  * scores and the softmax are float32;
  * probabilities are rounded to v's dtype before the PV product;
  * the output has q's dtype.

q/k/v may be any views whose last dimension is contiguous (the head-split
views of the projections). The result is a [B, H, Sq, 64] view of memory
laid out [B, Sq, H, 64], so that merging the heads back is a view too.
"""

from __future__ import annotations

import ctypes

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
        # the bf16 kernel copies rows in 16-byte pieces
        if q.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(x % 8 for x in t.stride()[:3])):
            raise ValueError(f"{name}: rows must start on 16-byte boundaries")
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
