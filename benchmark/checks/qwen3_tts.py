"""Whether what a Qwen3-TTS configuration's timed path served is correct: the
reference's judgement of a sample of the finished paragraphs' rows (one row
a sentence chunk).

The harness calls `prepare(items, config)` on the window's finished items
(each a `generator.Served`: the paragraph sent and the system's answer: the
crossfaded audio, and the codes, frames and uniform draws its frame loop
served), and after the program's state is freed `verdict(config, cases,
seed, device)` on the sample its traffic runner drew; it compares each
number that the cell's limits name.

A row is teacher-forced: the reference runs the talker over the row's
prompt and its served frames, and the code predictor over each frame's
served codes, and so gives the logits at every sampling decision the row
made: code0 of each frame (and the EOS that ended the row, where one did),
and the 15 heads of each frame before it. Each decision is judged by the
sampler's own rule, TTSKit's as the port runs it: code0's logits take the
repetition penalty over the row's earlier code0s and the suppressed ids
[2048, 3072) but EOS, then top-k (`options.top_k`) and argmax of
value / temperature + Gumbel noise; the heads take top-5 the same way. The
noise is the one the port drew for that frame, from the uniform draws the
system handed over (`u` -> -log(-log(u))), and it goes to the candidates in
the reference's rank order.

A served code's gap is how far, in logit units (temperature times the
noisy score), it lies below the code the reference would have chosen with
that noise. Logits within TIE of each other may stand in either order (a
rounding of the program's logits can swap them, and with them the noise
they get), so the gap is minimised over the orders those near-ties allow:
the served code and each competitor may take any rank of its tie, the
competitors their most favourable (a bound below the exact minimum). A
served code that is not among the reference's top-k, nor within TIE of its
k-th logit, is unmatched. At temperature 0 the gap is the best logit less
the served one.

The numbers, each compared where the cell's `benchmark/limits/<cell>.json`
gives it a limit:

  gap_max    the widest gap over the sample's served codes (BIG where the
             sample judged none)
  unmatched  served codes outside the reference's top-k by more than TIE,
             and rows whose audio belongs to another row: the stretch that
             only the row's audio covers (its crossfades left out) lies
             closer to another row's reference waveform than to its own
  wave_err   the served audio against the reference's Code2Wav of the
             served codes, each row cut to its frames and crossfaded the
             same way: over each sampled row's stretch of the paragraph,
             the largest absolute difference over the stretch's RMS (BIG
             where the lengths differ)
  missing    paragraphs due in the window with no answer
  draws_bad  the window's paragraphs whose recorded draws fail a plain
             test of uniform numbers (`draw_faults`): the check takes the
             program's draws, so it tests them on their own too
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Sequence

import numpy as np
import torch

from benchmark.references.qwen3_tts import CODEC_EOS, SAMPLE_RATE, SUPPRESS, Dims, Reference, crossfade, init_weights
from benchmark.references.qwen3_tts import spans as piece_spans

BIG = 1.0e9
TIE = 0.4  # logits this close may swap ranks: the limit of gap_max (benchmark/limits)
EXTRA = 32  # ranks past the k-th searched for its near-ties
HEAD_TOP_K = 5
SIGMAS = 6.0  # a uniform's mean and variance are judged within this many standard errors


def gaps(logits: torch.Tensor, served: torch.Tensor, noise: torch.Tensor | None, temperature: float, k: int,
         tie: float = TIE) -> tuple[torch.Tensor, torch.Tensor]:
    """Each decision's gap (see the module) and whether its served code is
    unmatched: logits [N, V] as the sampler sees them, served [N], noise
    [N, k] the Gumbel noise of ranks 0..k-1. Unmatched decisions read 0."""
    served = served.long()[:, None]
    s_val = logits.gather(1, served)[:, 0]
    if temperature <= 0:
        return (logits.amax(1) - s_val).clamp_min(0.0), torch.isinf(s_val)
    t = max(temperature, 1e-4)
    m = min(logits.shape[1], k + EXTRA)
    vals, idx = logits.topk(m, dim=1)
    cand = vals >= vals[:, k - 1:k] - tie  # [N, M]: the top-k and the k-th's near-ties
    is_s = idx == served
    outside = ~(is_s & cand).any(1)
    slot = torch.arange(k, device=logits.device)
    rank = torch.arange(m, device=logits.device)
    # allowed[n, p, j]: the candidate at rank p may take the noise of rank j
    allowed = ((vals[:, :, None] - vals[:, None, :k]).abs() <= tie) | (rank[:, None] == slot[None, :])[None]
    allowed &= cand[:, :, None]
    inf = torch.tensor(float("inf"), device=logits.device)
    g = torch.where(allowed, noise[:, None, :], inf)
    two = torch.cat([g, inf.expand(*g.shape[:2], 1)], 2).topk(2, dim=2, largest=False)
    # a competitor's least noise among its ranks once the served code holds rank j
    least = torch.where(two.indices[:, :, :1] == slot, two.values[:, :, 1:2], two.values[:, :, :1])
    score = torch.where(torch.isfinite(least) & ~is_s[:, :, None], vals[:, :, None] / t + least,
                        torch.tensor(float("-inf"), device=logits.device))
    best = score.amax(1)  # [N, k]
    own = s_val[:, None] / t + noise  # [N, k]
    s_slots = (allowed & is_s[:, :, None]).any(1)
    gap = torch.where(s_slots, t * (best - own), inf).amin(1)
    return torch.where(outside, 0.0, gap.clamp_min(0.0)), outside


def code0_rules(logits: torch.Tensor, code0: torch.Tensor, penalty: float) -> torch.Tensor:
    """code0's logits [F, V] as the sampler sees them at frames 0..F-1, after
    the served code0s [>= F - 1] before each: the repetition penalty over
    the codes seen (a positive logit divided by it, a negative one
    multiplied), and the suppressed ids at -inf."""
    f, v = logits.shape
    seen = torch.zeros((f, v), dtype=torch.bool, device=logits.device)
    if f > 1:
        seen[1:] = torch.nn.functional.one_hot(code0[:f - 1].long(), v).cumsum(0) > 0
    out = torch.where(seen, torch.where(logits > 0, logits / penalty, logits * penalty), logits)
    suppressed = torch.zeros(v, dtype=torch.bool, device=logits.device)
    suppressed[SUPPRESS[0]:SUPPRESS[1]] = True
    suppressed[CODEC_EOS] = False
    return out.masked_fill(suppressed, float("-inf"))


def gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(torch.float32).tiny)))


@dataclasses.dataclass
class Case:
    """One served row: its paragraph's item index, its row there, and what
    the paragraph served (shared by the paragraph's rows)."""

    item: int
    row: int
    texts: list  # the paragraph's sentences: row i's text is texts[i]
    codes: np.ndarray  # [rows, max_new_tokens, 16]
    n_frames: list  # each row's frames
    draws: np.ndarray  # [frames stepped, rows, top_k + 15 x 5] uniform draws
    audio: np.ndarray  # the paragraph's crossfaded audio
    options: dict
    window: dict  # counts over the whole window: rows, rows that stopped early

    @property
    def size(self) -> int:
        """Its frames: what a runner's sample ranks by."""
        return self.n_frames[self.row]


def draw_faults(draws: np.ndarray, temperature: float) -> list[str]:
    """What is wrong with one paragraph's uniform draws [frames, rows,
    width]: a value outside [0, 1), two rows of a frame or two frames of a
    row alike, a mean or a variance more than SIGMAS standard errors from a
    uniform's 1/2 and 1/12, or no draws at all where the temperature asks
    for noise. An empty list where none is."""
    if temperature <= 0:
        return []
    if draws.size == 0:
        return ["no draws"]
    out = []
    u = draws.astype(np.float64)
    if not np.all((u >= 0.0) & (u < 1.0)):
        out.append("a value outside [0, 1)")
    f, r, w = u.shape
    if len(np.unique(u.reshape(f * r, w), axis=0)) < f * r:
        out.append("two rows of a frame, or two frames of a row, drew the same numbers")
    n = u.size
    if abs(u.mean() - 0.5) > SIGMAS * np.sqrt(1 / 12 / n):
        out.append(f"mean {u.mean():.6f}")
    if abs(u.var() - 1 / 12) > SIGMAS * np.sqrt((1 / 80 - 1 / 144) / n):  # (4th central moment - variance^2) / n
        out.append(f"variance {u.var():.6f}")
    return out


def prepare(items: Sequence, config: dict) -> tuple[list[list[Case]], dict]:
    """Each finished paragraph's rows, and `draws_bad` over the window."""
    per_item, counts, bad = [], {"rows": 0, "early_stops": 0}, 0
    for n, item in enumerate(items):
        a, p = item.answer, item.request
        codes = a.codes.cpu().numpy()
        frames = [int(x) for x in a.n_frames.cpu().tolist()]
        draws = torch.stack(a.draws).cpu().numpy() if a.draws else np.zeros((0, len(frames), 0), np.float32)
        faults = draw_faults(draws[:, :len(frames)], p.options["temperature"])
        if faults:
            print(f"paragraph {n}'s draws: {'; '.join(faults)}", file=sys.stderr)
        bad += bool(faults)
        counts["rows"] += len(frames)
        counts["early_stops"] += sum(f < codes.shape[1] for f in frames)
        per_item.append([Case(n, r, list(p.sentences), codes, frames, draws, a.audio, p.options, counts)
                         for r in range(len(frames))])
    return per_item, {"draws_bad": bad}


def judge_row(reference: Reference, case: Case) -> dict:
    """The gaps of one row's decisions: code0's and the heads'."""
    o, dev = case.options, reference.device
    n, total = case.n_frames[case.row], case.codes.shape[1]
    codes = torch.from_numpy(case.codes[case.row]).to(dev)
    logits0, heads = reference.row_logits(case.texts[case.row], codes, n, o["voice"], o["language"])
    decided = n + 1 if n < total else n  # the EOS that ended the row is a decision too
    if o["temperature"] > 0 and case.draws.shape[0] < decided:
        raise ValueError(f"row {case.row} made {decided} decisions with {case.draws.shape[0]} draws")
    k = o["top_k"]
    noise = gumbel(torch.from_numpy(case.draws[:decided, case.row]).to(dev)) if o["temperature"] > 0 else None
    code0 = codes[:decided, 0]
    g0, out0 = gaps(code0_rules(logits0[:decided], code0, o["repetition_penalty"]), code0,
                    None if noise is None else noise[:, :k], o["temperature"], k)
    head_noise = None if noise is None else noise[:n, k:].reshape(n * 15, HEAD_TOP_K)
    gh, outh = gaps(heads.reshape(n * 15, heads.shape[-1]), codes[:n, 1:].reshape(-1), head_noise, o["temperature"],
                    HEAD_TOP_K)
    all_gaps = torch.cat([g0, gh])
    return {"codes": int(all_gaps.numel()), "gap": float(all_gaps.max()) if all_gaps.numel() else 0.0,
            "gap_code0": float(g0.max()) if g0.numel() else 0.0, "gap_heads": float(gh.max()) if gh.numel() else 0.0,
            "nonzero": int((all_gaps > 0).sum()), "unmatched": int(out0.sum() + outh.sum()), "frames": n}


def judge_audio(reference: Reference, cases: Sequence[Case]) -> tuple[float, int, list]:
    """The sampled rows' audio against the reference's waveforms of their
    paragraphs' served codes: (wave_err, rows whose audio belongs to another
    row, each row's error)."""
    worst, wrong, per_row = 0.0, 0, []
    by_item: dict[int, list[Case]] = {}
    for c in cases:
        by_item.setdefault(c.item, []).append(c)
    for rows in by_item.values():
        c = rows[0]
        spf = reference.dims.samples_per_frame
        waves = reference.code2wav(torch.from_numpy(c.codes)).cpu().numpy()
        lengths = [n * spf for n in c.n_frames]
        seconds = c.options["crossfade_seconds"]
        want = crossfade([waves[i, :lengths[i]] for i in range(len(lengths))], SAMPLE_RATE, seconds)
        where = piece_spans(lengths, SAMPLE_RATE, seconds)
        for case in rows:
            a, b = where[case.row]
            if len(want) != len(case.audio):
                worst = BIG
                per_row.append(BIG)
                continue
            if b == a:
                per_row.append(0.0)
                continue
            ref, got = want[a:b], case.audio[a:b]
            rms = float(np.sqrt(np.mean(np.square(ref.astype(np.float64))))) or 1.0
            err = float(np.max(np.abs(got - ref))) / rms
            worst = max(worst, err)
            per_row.append(err)
            # the stretch only this row covers, against every row's waveform there
            before = [e for (_, e), n in zip(where[:case.row], lengths) if n]
            after = [s for (s, _), n in zip(where[case.row + 1:], lengths[case.row + 1:]) if n]
            lo = max(0, max(before, default=a) - a)
            hi = min(b, min(after, default=b)) - a
            if hi > lo:
                own = got[lo:hi]
                dist = [float(np.max(np.abs(own - waves[j, lo:hi]))) if lengths[j] >= hi else float("inf")
                        for j in range(len(lengths))]
                wrong += int(np.argmin(dist) != case.row)
    return worst, wrong, per_row


def verdict(config: dict, cases: Sequence[Case], seed: int, device: str) -> tuple[dict, dict]:
    """The reference's numbers over `cases` (`gap_max`, `unmatched`,
    `wave_err`), and what it judged, reported beside them. The reference
    draws the seed's weights itself."""
    t0 = time.perf_counter()
    dims = Dims.of(config["model"])
    tree = init_weights(dims, seed, device)
    reference = Reference(tree, dims, config["serving"])
    del tree
    rows = [judge_row(reference, c) for c in cases]
    wave_err, wrong, per_row = judge_audio(reference, cases)
    del reference
    n_codes = sum(r["codes"] for r in rows)
    window = cases[0].window if cases else {"rows": 0, "early_stops": 0}
    judged = {"rows": len(rows), "codes": n_codes, "frames": [r["frames"] for r in rows],
              "nonzero_gaps": sum(r["nonzero"] for r in rows), "gap_per_row": [r["gap"] for r in rows],
              "gap_code0": max((r["gap_code0"] for r in rows), default=0.0),
              "gap_heads": max((r["gap_heads"] for r in rows), default=0.0),
              "wave_err_per_row": per_row, "window_rows": window["rows"],
              "window_early_stops": window["early_stops"], "seconds": time.perf_counter() - t0}
    found = {"gap_max": max((r["gap"] for r in rows), default=0.0) if n_codes else BIG,
             "unmatched": sum(r["unmatched"] for r in rows) + wrong, "wave_err": wave_err}
    return found, judged
