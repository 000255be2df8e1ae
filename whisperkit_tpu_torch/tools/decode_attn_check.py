"""The decode-step attention kernels' check inputs (K3's probs form, K4,
K5), and proof that K4's and K5's checks can fail.

    python -m whisperkit_tpu_torch.tools.decode_attn_check

`chip_smoke.py` holds each kernel against its plain version on inputs
from `check_inputs` / `check_inputs_q8`, one query row per (batch, head),
within a limit per row: 1e-5 absolute for K4 (float32 throughout, another
summation order), `K5_FLIPS` requantization flips for K5
(`q8_row_limit`). Three kinds of rows (row index b·H + h mod 3) make the
check able to fail a wrong kernel:

  0  peaked, the max score in the last, ragged chunk of K4's split of the
     key axis (`attention_decode.split_chunks`): q = 3/8 · k_j, so
     q·k is ~24 at j and of std 3 elsewhere
  1  peaked, the max in the first chunk
  2  near flat: scores of std 1/4

V has mean 3/4, as in `k2_check`: near-flat outputs are then averages
well away from 0, and the rows' sums show. The mask is open up to a
position (0, 31, S/2 or S - 1 in the check); the rows after it hold K/V data
(K4) or are unwritten, zero codes and scales (K5, as the cache holds
them), and a correct kernel never reads them.

K3's probs form is checked on `check_inputs_cross_q8`: the same three row
kinds over the 1500 frames of the int8 cross-KV (kind 0 peaked at the last
frames, kind 1 at the first, kind 2 near flat), for one or more query
rows; its probabilities within `K3_PROBS_LIMIT` of the plain version's,
its output bit for bit the plain launch's.

Run as a script, this builds K4's and K5's inputs on the CPU at B=4 H=20
S=224 (the main path's cache length) and reports, for K4's split-key
algorithm (`self_attend_split_reference`) and K5's algorithm
(`self_attend_q8_block_reference`), each unaltered and with each of its
faults, the worst row's error in units of its limit per position (0, 31,
S/2 and S - 1) and row kind. The unaltered forms must stay within 1; each
altered one must exceed it somewhere. K4: no rescale at the merge, the
ragged last chunk dropped, or masked keys scored 0 instead of -inf. K5:
the last visible key left out, masked keys scored 0, or p_scale taken
before the V scales are folded in.
"""

from __future__ import annotations

import json

import torch

from whisperkit_tpu_torch.models.whisper import _q8_row_quantize
from whisperkit_tpu_torch.ops import attention_decode as ad

ROW_KINDS = ("peaked_last_chunk", "peaked_first_chunk", "near_flat")
# K4's limit: float32 throughout, another summation order
K4_LIMIT = 1e-5
# K5's limit: ±1 flips of the probability requantization (another exp and
# sum order) are allowed, at most this many per row; one flip moves an
# output of its row by at most 127 · p_scale (one int8 V code)
K5_FLIPS = 2
# K3's probs form: float32 softmax against the plain version's, another
# exp and sum order; probabilities lie in [0, 1]
K3_PROBS_LIMIT = 1e-6
BATCH, HEADS, SEQ, SEED = 4, 20, 224, 0


def positions(s: int) -> tuple[int, ...]:
    """The check's mask positions: the first key, 31, S/2 and S - 1 (in that
    order, each once)."""
    return tuple(dict.fromkeys((0, min(31, s - 1), s // 2, s - 1)))


def row_kinds(b: int, h: int, device) -> torch.Tensor:
    """Each (batch, head) row's kind, [B, H]."""
    return (torch.arange(b * h, device=device) % 3).view(b, h)


def mask_upto(s: int, pos: int, device) -> torch.Tensor:
    """The decode step's additive mask row [1, S]: 0 up to `pos`, -inf after."""
    mask_row = torch.zeros((1, s), device=device)
    mask_row[:, pos + 1 :] = float("-inf")
    return mask_row


def _queries(k: torch.Tensor, mask_row: torch.Tensor, generator) -> torch.Tensor:
    """q [B, H, 1, 64] float32 of the three row kinds over the keys `k`."""
    b, h = k.shape[:2]
    chunks = ad.split_chunks(mask_row)
    (first, _), (last, end) = chunks[0], chunks[-1]
    kinds = row_kinds(b, h, k.device)
    u = torch.rand((b, h), generator=generator, device=k.device)
    j = torch.where(kinds == 0, last + (u * (end - last)).long(), (u * (chunks[0][1] - first)).long())
    q = 0.375 * torch.gather(k, 2, j[..., None, None].expand(b, h, 1, 64))
    flat = torch.randn((b, h, 1, 64), generator=generator, device=k.device) / 32
    return torch.where((kinds == 2)[..., None, None], flat, q)


def check_inputs(b: int, h: int, s: int, pos: int, generator, device):
    """(q, k, v, mask_row) for K4: q float32 (dh^-0.5 folded in) of the
    three row kinds, k/v [B, H, S, 64] bf16 (the serving cache), the mask
    open to `pos`."""
    k = torch.randn((b, h, s, 64), generator=generator, device=device).to(torch.bfloat16)
    v = (torch.randn((b, h, s, 64), generator=generator, device=device) + 0.75).to(torch.bfloat16)
    mask_row = mask_upto(s, pos, device)
    return _queries(k.float(), mask_row, generator), k, v, mask_row


def check_inputs_q8(b: int, h: int, s: int, pos: int, generator, device):
    """(qi, q_scale, k8, k_scale, v8, v_scale, mask_row) for K5: the row
    kinds of `check_inputs`, the query and the cache rows quantized per
    row, the rows after `pos` unwritten (zero codes and scales)."""
    k = torch.randn((b, h, s, 64), generator=generator, device=device)
    v = torch.randn((b, h, s, 64), generator=generator, device=device) + 0.75
    mask_row = mask_upto(s, pos, device)
    qi, q_scale = _q8_row_quantize(_queries(k, mask_row, generator))
    cache = [*_q8_row_quantize(k), *_q8_row_quantize(v)]
    for t in cache:
        t[:, :, pos + 1 :] = 0
    return (qi, q_scale, *cache, mask_row)


def check_inputs_cross_q8(b: int, h: int, s: int, t: int, generator, device):
    """(qi, q_scale, k8, v8, v_scale) for K3, `t` query rows per (batch,
    head): K and V ~ N(0, 1) quantized per channel over the frames (the
    int8 cross-KV recipe), each query of its row's kind, folded with K's
    scales and quantized per row as the decoder does (`_cross_attend`).
    Peaked rows put a score of ~24 on one frame in the last or first 64,
    near-flat rows have scores of std 1/4."""
    k = torch.randn((b, h, s, 64), generator=generator, device=device)
    v = torch.randn((b, h, s, 64), generator=generator, device=device) + 0.75
    k_scale = torch.clamp_min(k.abs().amax(dim=-2, keepdim=True) / 127.0, 1e-8)
    k8 = torch.clamp(torch.round(k / k_scale), -127, 127).to(torch.int8)
    v_scale = torch.clamp_min(v.abs().amax(dim=-2, keepdim=True) / 127.0, 1e-8)
    v8 = torch.clamp(torch.round(v / v_scale), -127, 127).to(torch.int8)
    kinds = row_kinds(b, h, device)[..., None].expand(b, h, t)
    u = (torch.rand((b, h, t), generator=generator, device=device) * 64).long()
    j = torch.where(kinds == 0, s - 1 - u, u)
    q = 0.375 * torch.gather(k, 2, j[..., None].expand(b, h, t, 64))
    flat = torch.randn((b, h, t, 64), generator=generator, device=device) / 32
    q = torch.where((kinds == 2)[..., None], flat, q)
    qi, q_scale = _q8_row_quantize(q * k_scale)
    return qi, q_scale, k8, v8, v_scale


def excess(out: torch.Tensor, ref: torch.Tensor, limit) -> torch.Tensor:
    """Each row's largest error in units of its limit (a scalar or one per
    row), [B, H]; a NaN counts as past any limit."""
    err = ((out - ref).abs().amax(dim=-1, keepdim=True) / limit)[..., 0, 0]
    return torch.nan_to_num(err, nan=float("inf"))


def q8_row_limit(args) -> torch.Tensor:
    """K5's limit per row, [B, H, 1, 1]: K5_FLIPS · 127 · the plain
    version's p_scale."""
    qi, q_scale, k8, ks, _, vs, mask_row = args
    _, p_scale = ad.self_attend_q8_probs(qi, q_scale, k8, ks, vs, mask_row)
    return K5_FLIPS * 127 * p_scale


def worst_by_kind(ratio: torch.Tensor) -> dict:
    kinds = row_kinds(*ratio.shape, ratio.device)
    return {name: float(ratio[kinds == i].max()) for i, name in enumerate(ROW_KINDS)}


def _pos(args) -> int:
    return int((args[-1][0] == 0).sum()) - 1


def fault_table(inputs: list) -> dict:
    """{form: {"pos P": {row kind: worst row's error / its limit}}} over
    the K4 inputs `inputs` (one per position), for the unaltered split-key
    form ("split") and each fault, against `self_attend_reference`."""
    return {
        fault or "split": {
            f"pos {_pos(args)}": worst_by_kind(excess(
                ad.self_attend_split_reference(*args, fault=fault), ad.self_attend_reference(*args), K4_LIMIT))
            for args in inputs
        }
        for fault in (None, *ad.SPLIT_FAULTS)
    }


def q8_fault_table(inputs: list) -> dict:
    """As `fault_table`, for K5: over the K5 inputs `inputs`, the kernel's
    algorithm unaltered ("block") and with each of Q8_FAULTS, against
    `self_attend_q8_reference`, in units of `q8_row_limit`."""
    return {
        fault or "block": {
            f"pos {_pos(args)}": worst_by_kind(excess(
                ad.self_attend_q8_block_reference(*args, fault=fault), ad.self_attend_q8_reference(*args),
                q8_row_limit(args)))
            for args in inputs
        }
        for fault in (None, *ad.Q8_FAULTS)
    }


def worst(by_pos: dict) -> float:
    """The largest entry of one form's table."""
    return max(max(kinds.values()) for kinds in by_pos.values())


def separates(table: dict, unaltered: str = "split") -> bool:
    """True when the unaltered form stays within the limit everywhere and
    each fault exceeds it somewhere."""
    return worst(table[unaltered]) <= 1.0 and all(
        worst(t) > 1.0 for form, t in table.items() if form != unaltered)


def main() -> None:
    g = torch.Generator().manual_seed(SEED)
    k4 = [check_inputs(BATCH, HEADS, SEQ, pos, g, "cpu") for pos in positions(SEQ)]
    print(json.dumps({"device": "cpu", "shape": [BATCH, HEADS, SEQ, 64], "positions": list(positions(SEQ)),
                      "cache": "bfloat16", "limit": f"{K4_LIMIT} absolute", "excess": fault_table(k4)}))
    k5 = [check_inputs_q8(BATCH, HEADS, SEQ, pos, g, "cpu") for pos in positions(SEQ)]
    print(json.dumps({"device": "cpu", "shape": [BATCH, HEADS, SEQ, 64], "positions": list(positions(SEQ)),
                      "cache": "int8", "limit": f"{K5_FLIPS} flips × 127 × p_scale", "excess": q8_fault_table(k5)}))


if __name__ == "__main__":
    main()
