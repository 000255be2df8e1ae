"""The encoder attention kernel's (K2's) check, and proof that it can fail.

    python -m whisperkit_tpu_torch.tools.k2_check

`chip_smoke.py` holds the bf16 kernel against `mha_encoder_reference` on
inputs from `check_inputs`, within `row_limit` of each query row: 2 bf16
ulps of the row's largest output. Three kinds of query rows (row index
mod 3) make the check able to fail a wrong kernel:

  0  peaked, the max score in the ragged last key tile: q_i = 3 k_j with j
     among the last S mod 64 keys (S = 1500: the last 28, inside the last
     tile of 64 or of 128 keys), so q·k/8 is ~24 at j and of std 3 elsewhere
  1  peaked, the max in the first tile (j < 64)
  2  near flat: q of std 1/4, scores of std 1/4

v has mean 3/4: a near-flat row's outputs are averages of v, and with
mean 0 they would be ~1/sqrt(S) of v, small enough that the bf16 rounding
of the probabilities alone (at different points in the kernel and in the
plain version) moves them by a bf16 ulp of the row's largest output. Near
3/4 that noise is ~1% of an ulp, while the row sum's shift by 36/1500 (the
padding fault) is ~2 ulps.

Run as a script, this builds the same inputs on the CPU at the shape at
which phase 3 of `chip_smoke.py` repeats the table (B=2 H=20 S=1500) and
reports, for the plain tiled form of the kernel's algorithm
(`mha_encoder_tiled`: the kernel's key tile and its order of the online
softmax) and for five altered forms, the worst row's error in units of
its limit, per row kind. The unaltered form must stay within 1; each
altered one must exceed it on some kind: no rescale of the accumulator
when the max moves, the ragged last tile skipped, the padding keys of the
last tile scored 0 instead of -inf, the dh^-0.5 scale applied twice, and
key tile t computed on the K and V of tile t - STAGES (a consumer that
missed its wait on the stage's full barrier and read what the ring held
before).
"""

from __future__ import annotations

import json
from typing import Optional

import torch

from whisperkit_tpu_torch.ops.attention import BLOCK_K, STAGES, mha_encoder_reference

FAULTS = ("no_rescale", "skip_last_tile", "pad_scored_zero", "double_scale", "stale_stage")
LOG2E = 1.4426950408889634
ROW_KINDS = ("peaked_last_tile", "peaked_first_tile", "near_flat")
BATCH, HEADS, SEQ, SEED = 2, 20, 1500, 0


def check_inputs(b: int, h: int, s: int, generator: torch.Generator, device,
                 dtype=torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v [B, H, S, 64] in `dtype` with the three row kinds above."""
    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device)

    k, v = randn(b, h, s, 64), randn(b, h, s, 64) + 0.75
    rows = torch.arange(s, device=device)
    ragged = s % 64 or 64
    span = torch.where(rows % 3 == 0, ragged, 64)
    start = torch.where(rows % 3 == 0, s - ragged, 0)
    j = start + (torch.rand((s,), generator=generator, device=device) * span).long()
    q = 3.0 * k[:, :, j]
    flat = rows % 3 == 2
    q[:, :, flat] = 0.25 * randn(b, h, int(flat.sum()), 64)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def row_limit(ref: torch.Tensor) -> torch.Tensor:
    """2 bf16 ulps of each row's largest |output|, [..., S, 1]."""
    amax = ref.float().abs().amax(dim=-1, keepdim=True).clamp_min(2.0**-100)
    return 2.0 * torch.exp2(torch.floor(torch.log2(amax)) - 7)


def excess(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's largest error in units of its limit, [..., S]."""
    return ((out.float() - ref.float()).abs().amax(dim=-1, keepdim=True) / row_limit(ref))[..., 0]


def mha_encoder_tiled(q, k, v, tile: int = BLOCK_K, fault: Optional[str] = None) -> torch.Tensor:
    """The bf16 kernel's algorithm in plain torch, in its order: keys in
    tiles of `tile`; scores of the unscaled q, the scale dh^-0.5 (a power
    of two: the same numbers as scaling q first) in the exponent's factor;
    per tile the row max, the rescale factor exp2((m - m_new) log2e scale)
    and p = exp2(s log2e scale - m_new log2e scale) in float32; each of the
    four threads that share a row keeps the sum of its own columns (column
    pairs 2tq, 2tq + 1 of every 8, added pair by pair in column order) and
    the four shares are added at the end as the quad's shuffles add them;
    the unnormalised p rounded to v's dtype before P·V, the output divided
    by the row sum. `fault` names one of FAULTS to alter it."""
    if fault not in (None, *FAULTS):
        raise ValueError(f"unknown fault {fault!r}")
    scale = q.shape[-1] ** -0.5
    factor = torch.tensor(scale * LOG2E, dtype=torch.float32)
    if fault == "double_scale":
        factor = factor * scale
    qf = q.float()
    s_len = k.shape[2]
    m = torch.full(q.shape[:-1] + (1,), float("-inf"), device=q.device)
    shares = torch.zeros(q.shape[:-1] + (4,), device=q.device)  # per thread of the row's quad
    o = torch.zeros(q.shape, device=q.device)
    for t, t0 in enumerate(range(0, s_len, tile)):
        n = min(tile, s_len - t0)
        src = t0 - STAGES * tile if fault == "stale_stage" and t >= STAGES else t0
        kt, vt = k[:, :, src : src + n].float(), v[:, :, src : src + n].float()
        if n < tile and fault == "skip_last_tile":
            break
        scores = qf @ kt.transpose(-1, -2)
        pad = tile - n
        if pad:
            if fault == "pad_scored_zero":  # zero-filled keys left unmasked
                scores = torch.cat([scores, scores.new_zeros(scores.shape[:-1] + (pad,))], -1)
                vt = torch.cat([vt, vt.new_zeros(vt.shape[:2] + (pad, vt.shape[3]))], 2)
            else:
                scores = torch.cat([scores, scores.new_full(scores.shape[:-1] + (pad,), float("-inf"))], -1)
                vt = torch.cat([vt, vt.new_zeros(vt.shape[:2] + (pad, vt.shape[3]))], 2)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        corr = torch.exp2((m - m_new) * factor)
        p = torch.exp2(scores * factor - m_new * factor)
        # the thread tq of a row holds columns 8j + 2tq and 8j + 2tq + 1
        pairs = p.reshape(p.shape[:-1] + (tile // 8, 4, 2))
        tile_share = torch.zeros_like(shares)
        for j in range(tile // 8):
            tile_share = tile_share + (pairs[..., j, :, 0] + pairs[..., j, :, 1])
        shares = shares * corr + tile_share
        o = (o if fault == "no_rescale" else o * corr) + p.to(v.dtype).float() @ vt
        m = m_new
    l = (shares[..., 0:1] + shares[..., 1:2]) + (shares[..., 2:3] + shares[..., 3:4])
    return (o / l).to(q.dtype)


def fault_table(q, k, v, tile: int = BLOCK_K) -> dict:
    """{form: {row kind: worst row's error / its limit}} for the unaltered
    tiled form ("tiled") and each fault, against mha_encoder_reference."""
    ref = mha_encoder_reference(q, k, v)
    kinds = torch.arange(q.shape[2], device=q.device) % 3
    table = {}
    for fault in (None, *FAULTS):
        ratio = excess(mha_encoder_tiled(q, k, v, tile, fault), ref)
        table[fault or "tiled"] = {
            name: float(ratio[..., kinds == i].max()) for i, name in enumerate(ROW_KINDS)
        }
    return table


def main() -> None:
    g = torch.Generator().manual_seed(SEED)
    q, k, v = check_inputs(BATCH, HEADS, SEQ, g, "cpu")
    table = fault_table(q, k, v)
    print(json.dumps({"device": "cpu", "shape": list(q.shape), "dtype": "bfloat16",
                      "limit": "2 bf16 ulps of each row's largest output", "excess": table}))


if __name__ == "__main__":
    main()
