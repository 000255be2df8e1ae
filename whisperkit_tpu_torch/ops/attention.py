"""Encoder multi-head attention (port of whisperkit_tpu/ops/attention.py).

`mha_encoder` is non-causal attention over q/k/v [B, H, S, 64] in bf16 or
f32. For CUDA tensors it launches the hand-written kernel in
csrc/mha_encoder.cu; for CPU tensors it runs `mha_encoder_reference`, the
plain torch version of the same math and rounding points:

  * q is scaled by dh^-0.5 and rounded to q's dtype before the score dot
    (Whisper's dh^-0.25 on both q and k, folded into q);
  * scores and the softmax are float32;
  * probabilities are rounded to v's dtype before the PV product;
  * the output has q's dtype.
"""

from __future__ import annotations

import torch

from whisperkit_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)


def mha_encoder_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel, q/k/v [B, H, S, Dh] → [B, H, S, Dh]."""
    scale = q.shape[-1] ** -0.5
    qs = (q * scale).to(q.dtype)
    scores = qs.float() @ k.float().transpose(-1, -2)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return (probs.float() @ v.float()).to(q.dtype)


def mha_encoder(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal MHA, q/k/v [B, H, S, 64] → [B, H, S, 64] in q's dtype."""
    if not q.is_cuda:
        return mha_encoder_reference(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_cuda(name, t, q.dtype, 4)
        if t.shape != q.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != q's {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"mha_encoder takes float32 or bfloat16, got {q.dtype}")
    b, h, s, dh = q.shape
    if dh != 64:
        raise ValueError(f"mha_encoder takes head dim 64, got {dh}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.launch(
            "mha_encoder", "wk_mha_encoder",
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            b, h, s, int(q.dtype == torch.bfloat16), float(dh) ** -0.5,
        )
    return out
