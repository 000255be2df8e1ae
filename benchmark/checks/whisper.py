"""Whether what a Whisper configuration's timed path served is correct: the
reference's judgement of a sample of the finished requests.

The harness calls `prepare(items, config)` on the window's finished items
(each a `generator.Served`: the audio sent and the pipeline's result), and
after the program's state is freed `verdict(config, cases, seed, device)`
on the sample its traffic runner drew; it compares each number that the
cell's limits name.

A served token is judged by its gap: how far its logit lies below the best
token of the reference's logits at its position, given the same audio and
the same earlier tokens, over the tokens that the decode rules allow there.
The rules are the ones the traffic's options turn on (greedy, timestamps on,
no suppressed tokens; openai's `ApplyTimestampRules`): <|notimestamps|>
never; after a lone timestamp no text, after a pair no timestamp;
timestamps never decrease; the first token a timestamp within the initial
cap; and text masked where the timestamps' summed probability beats the
best text token. That last rule compares two quantities of the logits, so
where the reference decides it the other way than the served token shows,
its margin counts into the gap (the logits would have to move by that
much to flip it). A token that the token-only rules forbid reads BIG.

The numbers, each compared where the cell's `benchmark/limits/<cell>.json`
gives it a limit:

  gap_max      the widest gap over the sample's served tokens (BIG where
               the sample served none)
  unmatched    windows whose served tokens name no window of the audio, or
               windows of the audio that served no token: an answer that
               went to the wrong request or never came
  missing      requests due in the window with no answer after the drain
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from benchmark.references import whisper as ref
from benchmark.references.whisper import WINDOW_SAMPLES, Dims, Reference, Tokens, vad_windows

BIG = 1.0e9
MAX_INITIAL_TIMESTAMP_INDEX = 50  # max_initial_timestamp 1.0 s at 0.02 s a token


def served_rows(item, tokens: Tokens) -> tuple[list[tuple[int, int]], list[list[int]], list[list[float]], int]:
    """The item's windows (start, length), each window's served tokens (the
    concatenation of its segments' tokens, by the segments' seek) and their
    served log-probabilities, and how many windows did not match: segments
    whose seek names no window plus windows that served nothing."""
    windows = vad_windows(item.request)
    by_seek = {start // 160: i for i, (start, _) in enumerate(windows)}
    rows: list[list[int]] = [[] for _ in windows]
    logprobs: list[list[float]] = [[] for _ in windows]
    unmatched = 0
    for seg in item.answer.segments:
        i = by_seek.get(int(seg.seek))
        if i is None:
            unmatched += 1
            continue
        for t, lp in zip(seg.tokens, seg.token_log_probs):
            if int(t) != tokens.eot:
                rows[i].append(int(t))
                logprobs[i].append(float(lp[t]))
    unmatched += sum(1 for r in rows if not r)
    return windows, rows, logprobs, unmatched


def token_gaps(logits: torch.Tensor, row: Sequence[int], sample_begin: int, tokens: Tokens,
               max_initial: int = MAX_INITIAL_TIMESTAMP_INDEX) -> tuple[torch.Tensor, torch.Tensor]:
    """The gap of each served token row[sample_begin:] under the reference's
    logits [T, V] of the whole row (position t predicting token t + 1), and
    the token's log-probability over the tokens the rules allow there."""
    dev = logits.device
    served = torch.tensor(list(row[sample_begin:]), dtype=torch.long, device=dev)
    n, v = len(served), logits.shape[1]
    if n == 0:
        return torch.zeros(0, device=dev), torch.zeros(0, device=dev)
    lg = logits[sample_begin - 1: sample_begin - 1 + n].float()
    tsb, eot = tokens.timestamp_begin, tokens.eot
    ids = torch.arange(v, device=dev)
    is_ts, is_text = ids >= tsb, ids < eot
    is_other = ~is_ts & ~is_text & (ids != tokens.notimestamps)

    # token-only rules, per position j, from the served tokens before it
    was_ts = served >= tsb
    prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), was_ts[:-1]])
    prev2 = torch.cat([torch.ones(2, dtype=torch.bool, device=dev), was_ts[:-2]])[:n]
    first = torch.arange(n, device=dev) == 0
    no_text = prev & ~prev2
    no_ts = prev & prev2
    seen = torch.where(was_ts, served, torch.full_like(served, -1))
    max_ts = torch.cat([torch.full((1,), -1, dtype=torch.long, device=dev), torch.cummax(seen, 0).values[:-1]])
    lo = torch.where(max_ts >= 0, torch.where(no_text, max_ts, max_ts + 1), torch.full_like(max_ts, tsb))
    hi = torch.where(first, torch.full_like(lo, tsb + max_initial + 1), torch.full_like(lo, v))
    ts_ok = is_ts[None] & (ids[None] >= lo[:, None]) & (ids[None] < hi[:, None]) & ~no_ts[:, None]
    text_ok = is_text[None] & ~(no_text | first)[:, None]
    other_ok = is_other[None] & ~first[:, None]
    allowed = ts_ok | text_ok | other_ok

    neg = torch.tensor(float("-inf"), device=dev)
    best_ts = torch.where(ts_ok, lg, neg).amax(1)
    lse_ts = torch.logsumexp(torch.where(ts_ok, lg, neg), 1)
    best_non = torch.where(text_ok | other_ok, lg, neg).amax(1)
    force = lse_ts > best_non
    s = lg.gather(1, served[:, None])[:, 0]
    best_all = torch.maximum(best_ts, best_non)

    s_is_ts = served >= tsb
    # a served timestamp: its gap among the timestamps, plus the rule's
    # margin where the reference does not force one
    gap_ts = best_ts - s + (best_non - lse_ts).clamp_min(0.0)
    # a served non-timestamp: where the rule forces a timestamp, its margin on top
    gap_non = torch.where(force, lse_ts - s, best_all - s)
    gap = torch.where(s_is_ts, gap_ts, gap_non)
    ok = allowed.gather(1, served[:, None])[:, 0]
    # the log-probability over what the rules keep: all they allow, or for a
    # timestamp possibly the timestamps alone (the program's own decision)
    logprob = s - torch.logsumexp(torch.where(allowed, lg, neg), 1)
    logprob_ts = torch.where(s_is_ts, s - lse_ts, logprob)
    return torch.where(ok, gap.clamp_min(0.0), torch.full_like(gap, BIG)), torch.stack([logprob, logprob_ts])


@dataclasses.dataclass
class Case:
    """One served window: its item, its index there, its audio and its
    token row (prompt + served tokens)."""

    item: int
    window: int
    audio: np.ndarray
    row: list
    logprobs: list  # the served log-probability of each served token

    @property
    def size(self) -> int:
        """Its audio's samples: what a runner's sample ranks by."""
        return len(self.audio)


def cases_of(items: Sequence, tokens: Tokens) -> tuple[list[list[Case]], int]:
    """Each item's served windows, and how many windows of all items did not
    match (see `served_rows`)."""
    prompt, out, unmatched = tokens.prompt(), [], 0
    for n, item in enumerate(items):
        windows, rows, logprobs, bad = served_rows(item, tokens)
        unmatched += bad
        out.append([Case(n, w, item.request[start:start + min(length, WINDOW_SAMPLES)], prompt + row, lps)
                    for w, ((start, length), row, lps) in enumerate(zip(windows, rows, logprobs)) if row])
    return out, unmatched


@dataclasses.dataclass
class Judgement:
    gap_max: float
    tokens: int
    flips: int  # served tokens with a gap above 0
    logprob_err: list  # |served - reference log-probability| of each token (the closer of the two rule-5 cases)
    per_window: list  # (item, window, tokens, widest gap, mean log-probability error)


def judge(reference: Reference, cases: Sequence[Case], tokens: Tokens) -> Judgement:
    """The reference's judgement of the served windows `cases`."""
    sample_begin = len(tokens.prompt())
    per_window, widest, n_tok, flips, err = [], 0.0, 0, 0, []
    for case, logits in zip(cases, reference.logits([c.audio for c in cases], [c.row for c in cases])):
        gaps, logprob = token_gaps(logits, case.row, sample_begin, tokens)
        top = float(gaps.max()) if len(gaps) else 0.0
        widest, n_tok, flips = max(widest, top), n_tok + len(gaps), flips + int((gaps > 0).sum())
        served = torch.tensor(case.logprobs)
        window_err = (logprob.cpu() - served).abs().amin(0).tolist()
        per_window.append((case.item, case.window, len(gaps), top, sum(window_err) / max(1, len(window_err))))
        err += window_err
    return Judgement(widest, n_tok, flips, err, per_window)


def prepare(items: Sequence, config: dict) -> tuple[list[list[Case]], dict]:
    """Each finished item's served windows, and what is counted from the
    items alone: `unmatched`."""
    per_item, unmatched = cases_of(items, Tokens.of(Dims.of(config["model"]).n_vocab))
    return per_item, {"unmatched": unmatched}


def verdict(config: dict, cases: Sequence[Case], seed: int, device: str) -> tuple[dict, dict]:
    """The reference's numbers over `cases` (`gap_max`), and what it judged,
    reported beside them: tokens, flips, the served log-probabilities'
    errors. The reference draws the seed's weights itself."""
    dims = Dims.of(config["model"])
    tokens = Tokens.of(dims.n_vocab)
    tree = ref.init_weights(dims, seed, device)
    reference = Reference(tree, dims, config["serving"])
    del tree
    v = judge(reference, cases, tokens)
    del reference
    err = sorted(v.logprob_err) or [0.0]
    judged = {"windows": len(cases), "tokens": v.tokens, "flips": v.flips,
              "logprob_err": {q: err[min(len(err) - 1, int(q * len(err)))] for q in (0.5, 0.9, 0.99)},
              "logprob_err_mean": sum(err) / len(err), "logprob_err_max": err[-1],
              "widest_per_window": [w[3] for w in v.per_window], "err_per_window": [w[4] for w in v.per_window]}
    return {"gap_max": v.gap_max if v.tokens else BIG}, judged
