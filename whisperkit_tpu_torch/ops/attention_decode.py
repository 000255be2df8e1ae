"""Decode-step attention (port of whisperkit_tpu/ops/attention_decode.py).

  cross_attend_q8  int8 cross-attention over the int8 cross-KV (K3), for
                   one or more query rows (the T==1 step and the prefill);
                   with `probs_out` it also writes the softmax rows of the
                   heads it is given (K3's probs form, word timestamps)
  self_attend      T==1 self-attention over the raw bf16/f32 cache (K4)
  self_attend_q8   T==1 self-attention over the int8 per-token-scale
                   cache (K5)

K4 splits each (batch, head) row's keys among SPLIT_WARPS warps
(`split_chunks`), each with its own softmax max and sum, merged once;
`self_attend_split_reference` is that algorithm in plain torch, for the
tests and the on-card check (tools/decode_attn_check.py), never on the
main path. K5 keeps one softmax per row over the keys up to the last
visible one, its exp sum taken per thread, per warp and per block;
`self_attend_q8_block_reference` is that order in plain torch, for the
same uses.

For CUDA tensors each launches its hand-written kernel in
csrc/attention_decode.cu; for CPU tensors it runs the plain torch version
beside it. torch's int8 matmul returns int8 and overflows, so the plain
versions compute the integer dots in floats: in float64 for K3, whose
1500-key dot passes 2^24 (1500 · 127² > 2^24), and in float32 for K5,
whose dots stay below it (64 · 127² and 448 · 127²), exact on CPU and CUDA
alike.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from whisperkit_tpu_torch.ops import _build

# K4 splits each (batch, head) row's keys among this many warps
SPLIT_WARPS = 8
# the longest cache K4 and K5 take (they stage rows in shared memory);
# the decode loop's is at most 2 · MAX_TOKEN_CONTEXT = 448
MAX_SELF_KEYS = 512
# the most heads K3's probs form maps to slots (its kernel's MAX_HEADS)
MAX_PROBS_HEADS = 64


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer matmul of int8 operands, as float64."""
    return a.double() @ b.double()


def cross_attend_q8_reference(qi, q_scale, k_q8, v_q8, v_scale, return_probs: bool = False):
    """Plain torch version of K3 (the JAX `cross_attend_q8_reference`):
    qi [B,H,T,Dh] i8, q_scale [B,H,T,1] f32, k/v [B,H,S,Dh] i8,
    v_scale [B,H,1,Dh] f32 → [B,H,T,Dh] f32; with `return_probs`, also
    the f32 softmax [B,H,T,S] the output is formed from (the JAX
    `_cross_attend(capture_probs=True)` probs)."""
    scores_i = _int_dot(qi, k_q8.transpose(-1, -2))
    probs = torch.softmax(scores_i.float() * q_scale, dim=-1)
    p_scale = torch.clamp_min(probs.amax(dim=-1, keepdim=True) / 127.0, 1e-8)
    pi = torch.clamp(torch.round(probs / p_scale), 0, 127)
    out_i = _int_dot(pi, v_q8)
    out = out_i.float() * p_scale * v_scale
    return (out, probs) if return_probs else out


def write_head_probs(probs: torch.Tensor, probs_out: torch.Tensor, slots: Sequence[int]) -> None:
    """Copy head h's rows of `probs` [B,H,T,S] to `probs_out[:, slots[h]]`
    ([B,A,T,S]) for every head with a slot (≥ 0): what K3's probs form
    writes."""
    for h, a in enumerate(slots):
        if a >= 0:
            probs_out[:, a] = probs[:, h]


def _check_probs_out(probs_out, slots, b, h, t, s) -> None:
    _build.check_cuda("probs_out", probs_out, torch.float32, 4, contiguous=False)
    if probs_out.shape[0] != b or tuple(probs_out.shape[2:]) != (t, s):
        raise ValueError(f"probs_out: expected shape ({b}, A, {t}, {s}), got {tuple(probs_out.shape)}")
    if probs_out.stride(-1) != 1:
        raise ValueError("probs_out: the key axis must be contiguous")
    if h > MAX_PROBS_HEADS:
        raise ValueError(f"the probs form takes at most {MAX_PROBS_HEADS} heads, got {h}")
    if len(slots) != h or not all(-1 <= a < probs_out.shape[1] for a in slots):
        raise ValueError(f"probs_slots: expected {h} slots in [-1, {probs_out.shape[1]}), got {list(slots)}")
    taken = [a for a in slots if a >= 0]
    if len(set(taken)) != len(taken):
        raise ValueError(f"probs_slots: a slot is named twice in {list(slots)}")
    # the kernel stores one float at a time, so f32 alignment is all it needs
    if probs_out.data_ptr() % 4:
        raise ValueError("probs_out: data must be 4-byte aligned")


def cross_attend_q8(
    qi, q_scale, k_q8, v_q8, v_scale,
    probs_out: Optional[torch.Tensor] = None, probs_slots: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """int8 cross-attention, shapes as in `cross_attend_q8_reference`.
    CUDA: csrc/attention_decode.cu; CPU: the plain version.

    K3's probs form: with `probs_out` (f32 [B,A,T,S], the key axis
    contiguous, other strides free, e.g. a view of the alignment buffer)
    and `probs_slots` (one entry per head: the index on probs_out's axis 1
    that takes that head's softmax rows, or -1), the kernel also writes the
    softmax it forms, for those heads only; the output is bit for bit the
    same."""
    if (probs_out is None) != (probs_slots is None):
        raise ValueError("probs_out and probs_slots go together")
    if not qi.is_cuda:
        if probs_out is None:
            return cross_attend_q8_reference(qi, q_scale, k_q8, v_q8, v_scale)
        out, probs = cross_attend_q8_reference(qi, q_scale, k_q8, v_q8, v_scale, return_probs=True)
        write_head_probs(probs, probs_out, probs_slots)
        return out
    _build.check_cuda("qi", qi, torch.int8, 4)
    _build.check_cuda("q_scale", q_scale, torch.float32, 4)
    _build.check_cuda("k", k_q8, torch.int8, 4)
    _build.check_cuda("v", v_q8, torch.int8, 4)
    _build.check_cuda("v_scale", v_scale, torch.float32, 4)
    b, h, t, dh = qi.shape
    s = k_q8.shape[2]
    if dh != 64:
        raise ValueError(f"cross_attend_q8 takes head dim 64, got {dh}")
    expected = {
        "q_scale": (q_scale, (b, h, t, 1)),
        "k": (k_q8, (b, h, s, dh)),
        "v": (v_q8, (b, h, s, dh)),
        "v_scale": (v_scale, (b, h, 1, dh)),
    }
    for name, (x, shape) in expected.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")
    for name, x in (("k", k_q8), ("v", v_q8)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    out = torch.empty((b, h, t, dh), dtype=torch.float32, device=qi.device)
    args = (_build.ptr(qi), _build.ptr(q_scale), _build.ptr(k_q8), _build.ptr(v_q8),
            _build.ptr(v_scale), _build.ptr(out), b * h, t, s)
    if probs_out is None:
        _build.launch("cross_attend_q8", "wk_cross_attend_q8", qi.device, *args)
    else:
        _check_probs_out(probs_out, probs_slots, b, h, t, s)
        slots = (ctypes.c_byte * h)(*probs_slots)
        strides = (ctypes.c_longlong * 3)(probs_out.stride(0), probs_out.stride(1), probs_out.stride(2))
        _build.launch(
            "cross_attend_q8_probs", "wk_cross_attend_q8_probs", qi.device, *args,
            _build.ptr(probs_out), h, ctypes.cast(slots, ctypes.c_void_p), strides,
        )
    return out


def self_attend_reference(q, k, v, mask_row) -> torch.Tensor:
    """Plain torch version of K4: q [B,H,1,Dh] f32 with dh^-0.5 folded in,
    k/v [B,H,S,Dh], mask_row [1,S] f32 additive → [B,H,1,Dh] f32."""
    scores = q.float() @ k.float().transpose(-1, -2)
    probs = torch.softmax(scores + mask_row, dim=-1)
    return probs @ v.float()


def split_chunks(mask_row: torch.Tensor, n_keys: int | None = None) -> list[tuple[int, int]]:
    """K4's split of the key axis: the keys up to the last visible one
    (or the first `n_keys`), in SPLIT_WARPS contiguous chunks of equal
    length, a multiple of 4 keys, the last one ragged; empty chunks left
    out."""
    if n_keys is None:
        visible = torch.nonzero(mask_row[0] != float("-inf"))
        n_keys = int(visible[-1]) + 1 if len(visible) else 0
    size = 4 * -(-n_keys // (4 * SPLIT_WARPS))
    return [(w * size, min(n_keys, (w + 1) * size)) for w in range(SPLIT_WARPS) if w * size < n_keys]


SPLIT_FAULTS = ("no_rescale", "drop_last_chunk", "masked_scored_zero")


def self_attend_split_reference(q, k, v, mask_row, fault: str | None = None) -> torch.Tensor:
    """K4's algorithm in plain torch, shapes as in `self_attend_reference`:
    the keys in `split_chunks`, each chunk's own max m_w, sum l_w of
    exp(score - m_w) and partial P·V in float32, merged once with the
    weights exp(m_w - m). `fault` names one of SPLIT_FAULTS to alter it
    (for the check's proof that it can fail): no rescale at the merge, the
    last chunk dropped, or masked keys scored 0 instead of -inf (and the
    chunks then over all keys)."""
    if fault not in (None, *SPLIT_FAULTS):
        raise ValueError(f"unknown fault {fault!r}")
    scores = q.float() @ k.float().transpose(-1, -2) + mask_row
    chunks = split_chunks(mask_row)
    if fault == "masked_scored_zero":
        scores = torch.where(mask_row == float("-inf"), 0.0, scores)
        chunks = split_chunks(mask_row, k.shape[2])
    if fault == "drop_last_chunk":
        chunks = chunks[:-1]
    if not chunks:  # no visible key: 0 / 0, as the softmax of all -inf
        return torch.full(q.shape, float("nan"), device=q.device)
    inf = float("-inf")
    m_w = [scores[..., a:b].amax(dim=-1, keepdim=True) for a, b in chunks]
    m = torch.stack(m_w).amax(dim=0)
    l, o = 0.0, 0.0
    for (a, b), mw in zip(chunks, m_w):
        e = torch.exp(scores[..., a:b] - torch.where(mw == inf, 0.0, mw))  # a chunk with no visible key: 0
        c = torch.ones_like(mw) if fault == "no_rescale" else torch.exp(mw - m)
        c = torch.where(mw == inf, 0.0, c)
        l = l + c * e.sum(dim=-1, keepdim=True)
        o = o + c * (e @ v[:, :, a:b].float())
    return o / l


def self_attend(q, k, v, mask_row) -> torch.Tensor:
    """T==1 self-attention over the raw cache, shapes as in
    `self_attend_reference`. CUDA: csrc/attention_decode.cu; CPU: the
    plain version."""
    if not q.is_cuda:
        return self_attend_reference(q, k, v, mask_row)
    _build.check_cuda("q", q, torch.float32, 4)
    _build.check_cuda("k", k, k.dtype, 4)
    _build.check_cuda("v", v, k.dtype, 4)
    _build.check_cuda("mask_row", mask_row, torch.float32, 2)
    if k.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"self_attend takes a bfloat16 or float32 cache, got {k.dtype}")
    b, h, s, dh = k.shape
    if dh != 64:
        raise ValueError(f"self_attend takes head dim 64, got {dh}")
    if tuple(q.shape) != (b, h, 1, dh) or tuple(v.shape) != (b, h, s, dh):
        raise ValueError(
            f"self_attend: q {tuple(q.shape)} / v {tuple(v.shape)} do not match k {tuple(k.shape)}"
        )
    if tuple(mask_row.shape) != (1, s):
        raise ValueError(f"mask_row: expected shape (1, {s}), got {tuple(mask_row.shape)}")
    if s > MAX_SELF_KEYS:
        raise ValueError(f"self_attend takes a cache of at most {MAX_SELF_KEYS} keys, got {s}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    out = torch.empty((b, h, 1, dh), dtype=torch.float32, device=q.device)
    _build.launch(
        "self_attend", "wk_self_attend", q.device,
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(mask_row),
        _build.ptr(out), b * h, s, int(k.dtype == torch.bfloat16),
    )
    return out


def self_attend_q8_probs(qi, q_scale, k_q8, k_scale, v_scale, mask_row):
    """K5's requantized probabilities: (pi [B,H,T,S] f32 holding the int8
    codes in [0, 127], p_scale [B,H,T,1] f32), the per-token V scales
    folded in. Shapes as in `self_attend_q8_reference`."""
    scores_i = qi.float() @ k_q8.float().transpose(-1, -2)
    scores = scores_i * q_scale * k_scale.transpose(-1, -2) + mask_row
    probs = torch.softmax(scores, dim=-1)
    pw = probs * v_scale.transpose(-1, -2)  # fold the per-token V scales
    p_scale = torch.clamp_min(pw.amax(dim=-1, keepdim=True) / 127.0, 1e-8)
    return torch.clamp(torch.round(pw / p_scale), 0, 127), p_scale


def self_attend_q8_reference(qi, q_scale, k_q8, k_scale, v_q8, v_scale, mask_row) -> torch.Tensor:
    """Plain torch version of K5 (the JAX `_self_decode_q8_kernel` and
    `_attend_self_q8` math): qi [B,H,T,Dh] i8 (row-quantized query with
    dh^-0.5 folded in), q_scale [B,H,T,1] f32, k/v [B,H,S,Dh] i8,
    k_scale/v_scale [B,H,S,1] f32 per-token, mask_row additive f32
    broadcasting to [B,H,T,S] → [B,H,T,Dh] f32. The integer dots are exact
    in float32 (at most 448 · 127² < 2^24)."""
    pi, p_scale = self_attend_q8_probs(qi, q_scale, k_q8, k_scale, v_scale, mask_row)
    return (pi @ v_q8.float()) * p_scale


# K5's block: this many threads, thread t owning keys t, t + K5_THREADS, ...
K5_THREADS = 256
Q8_FAULTS = ("drop_last_visible", "masked_scored_zero", "p_scale_of_probs")


def _k5_block_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in K5's order → [..., 1]: each thread's keys
    in turn from 0, then a butterfly of xor shuffles (16, 8, 4, 2, 1) over
    the 32 threads of each warp, then the same over the warps' sums, the
    lanes past the last warp holding 0."""
    s = x.shape[-1]
    per_thread = -(-s // K5_THREADS)
    keys = torch.nn.functional.pad(x, (0, per_thread * K5_THREADS - s)).unflatten(-1, (per_thread, K5_THREADS))
    acc = torch.zeros_like(keys[..., 0, :])
    for i in range(per_thread):
        acc = acc + keys[..., i, :]
    lanes = torch.arange(32, device=x.device)

    def butterfly(y):
        for off in (16, 8, 4, 2, 1):
            y = y + y[..., lanes ^ off]
        return y

    warps = butterfly(acc.unflatten(-1, (K5_THREADS // 32, 32)))[..., 0]
    return butterfly(torch.nn.functional.pad(warps, (0, 32 - warps.shape[-1])))[..., :1]


def self_attend_q8_block_reference(qi, q_scale, k_q8, k_scale, v_q8, v_scale, mask_row,
                                   fault: str | None = None) -> torch.Tensor:
    """K5's algorithm in plain torch, shapes as in `self_attend_q8_reference`:
    the keys up to the last visible one (n), masked keys scored -inf without
    reading their scales, the exp sum in the kernel's order
    (`_k5_block_sum`), the V scales folded in only where the exp is
    positive, one p_scale for the row, P·V in exact integers; no visible
    key gives 0, as the kernel. `fault` names one of Q8_FAULTS to alter it
    (for the check's proof that it can fail): the last visible key left
    out, masked keys scored 0 instead of -inf (and then all S keys), or
    p_scale taken from the probabilities before the V scales are folded
    in."""
    if fault not in (None, *Q8_FAULTS):
        raise ValueError(f"unknown fault {fault!r}")
    inf = float("-inf")
    visible = torch.nonzero(mask_row[0] != inf)
    n = int(visible[-1]) + 1 if len(visible) else 0
    mask = mask_row
    if fault == "drop_last_visible":
        n = max(n - 1, 0)
    if fault == "masked_scored_zero":
        n, mask = k_q8.shape[2], torch.zeros_like(mask_row)
    if n == 0:
        return torch.zeros(qi.shape, dtype=torch.float32, device=qi.device)
    mask = mask[..., :n]
    k, ks, v, vs = k_q8[:, :, :n].float(), k_scale[:, :, :n], v_q8[:, :, :n].float(), v_scale[:, :, :n]
    dots = (qi.float() @ k.transpose(-1, -2)) * q_scale
    scores = torch.where(mask == inf, inf, dots * ks.transpose(-1, -2) + mask)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = e / _k5_block_sum(e)
    pw = torch.where(e > 0, probs * vs.transpose(-1, -2), 0.0)
    top = (probs if fault == "p_scale_of_probs" else pw).amax(dim=-1, keepdim=True)
    p_scale = torch.clamp_min(top / 127.0, 1e-8)
    pi = torch.clamp(torch.round(pw / p_scale), 0, 127)
    return (pi @ v) * p_scale


def self_attend_q8(qi, q_scale, k_q8, k_scale, v_q8, v_scale, mask_row) -> torch.Tensor:
    """T==1 self-attention over the int8 cache: qi [B,H,1,Dh] i8, q_scale
    [B,H,1,1] f32, k/v [B,H,S,Dh] i8, k_scale/v_scale [B,H,S,1] f32,
    mask_row [1,S] f32 → [B,H,1,Dh] f32, S ≤ MAX_SELF_KEYS. CUDA:
    csrc/attention_decode.cu, which copies the K and V rows up to the last
    visible key into shared memory with bulk copies (k and v 16-byte
    aligned); CPU: the plain version."""
    if not qi.is_cuda:
        return self_attend_q8_reference(qi, q_scale, k_q8, k_scale, v_q8, v_scale, mask_row)
    _build.check_cuda("qi", qi, torch.int8, 4)
    _build.check_cuda("q_scale", q_scale, torch.float32, 4)
    _build.check_cuda("k", k_q8, torch.int8, 4)
    _build.check_cuda("k_scale", k_scale, torch.float32, 4)
    _build.check_cuda("v", v_q8, torch.int8, 4)
    _build.check_cuda("v_scale", v_scale, torch.float32, 4)
    _build.check_cuda("mask_row", mask_row, torch.float32, 2)
    b, h, s, dh = k_q8.shape
    if dh != 64:
        raise ValueError(f"self_attend_q8 takes head dim 64, got {dh}")
    expected = {
        "qi": (qi, (b, h, 1, dh)),
        "q_scale": (q_scale, (b, h, 1, 1)),
        "k_scale": (k_scale, (b, h, s, 1)),
        "v": (v_q8, (b, h, s, dh)),
        "v_scale": (v_scale, (b, h, s, 1)),
        "mask_row": (mask_row, (1, s)),
    }
    for name, (x, shape) in expected.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")
    if s > MAX_SELF_KEYS:
        raise ValueError(f"self_attend_q8 takes a cache of at most {MAX_SELF_KEYS} keys, got {s}")
    for name, x in (("qi", qi), ("k", k_q8), ("v", v_q8)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    out = torch.empty((b, h, 1, dh), dtype=torch.float32, device=qi.device)
    _build.launch(
        "self_attend_q8", "wk_self_attend_q8", qi.device,
        _build.ptr(qi), _build.ptr(q_scale), _build.ptr(k_q8), _build.ptr(k_scale),
        _build.ptr(v_q8), _build.ptr(v_scale), _build.ptr(mask_row), _build.ptr(out),
        b * h, s,
    )
    return out
