"""Logits filters as batched tensor masks (port of
whisperkit_tpu/decoding/filters.py).

Reference: Sources/WhisperKit/Core/Text/LogitsFilter.swift. Every filter is
a function on a [B, V] logits tensor built from tensor masks, as JAX's are.
The decode position `pos` may be a 0-d int64 tensor on the logits' device
(the decode loop keeps it there, so that a CUDA graph of the step replays
at each new position) or a host int (beam search, speculative decoding);
nothing branches on it in Python and nothing here waits for the device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from whisperkit_tpu_torch.text.tokenizer import SpecialTokens

NEG_INF = float("-inf")


def suppress_tokens_bias(n_vocab: int, suppress: Sequence[int]) -> np.ndarray:
    """Static additive bias implementing SuppressTokensFilter."""
    bias = np.zeros((n_vocab,), np.float32)
    ids = [t for t in suppress if 0 <= t < n_vocab]
    if ids:
        bias[np.asarray(ids)] = NEG_INF
    return bias


def non_speech_token_ids(sp: SpecialTokens, tokenizer=None) -> list[int]:
    """The default suppress list (openai's `non_speech_tokens` + specials),
    used when options.suppress_tokens == [-1]."""
    ids = {sp.translate, sp.transcribe, sp.sot, sp.startofprev, sp.startoflm}
    if tokenizer is not None and hasattr(tokenizer, "encode"):
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        )
        miscellaneous = set("♩♪♫♬♭♮♯")
        for symbol in symbols + list(miscellaneous):
            for tok in (symbol, " " + symbol):
                try:
                    enc = tokenizer.encode(tok)
                except Exception:
                    continue
                if len(enc) == 1:
                    ids.add(enc[0])
    return sorted(t for t in ids if 0 <= t < sp.n_vocab)


def apply_suppress_blank(logits: torch.Tensor, sp: SpecialTokens, at_begin) -> torch.Tensor:
    """Mask ' ' and EOT at the first sampled position; `at_begin` is a
    bool or a 0-d bool tensor."""
    ids = torch.arange(logits.shape[-1], device=logits.device)
    blank = (ids == sp.whitespace) | (ids == sp.eot)
    return logits.masked_fill(blank[None, :] & at_begin, NEG_INF)


def apply_timestamp_rules(
    logits: torch.Tensor,  # [B, V] f32
    tokens: torch.Tensor,  # [B, T] token buffer
    pos,  # current length (next write index): a 0-d int64 tensor or an int
    sample_begin: int,
    sp: SpecialTokens,
    max_initial_timestamp_index: int,
) -> torch.Tensor:
    """Whisper timestamp pairing/monotonicity rules (openai
    `ApplyTimestampRules`):
      * <|notimestamps|> is always suppressed
      * timestamps come in pairs (except directly before EOT): after a lone
        timestamp, text is masked; after a pair, timestamps are masked
      * timestamps are non-decreasing across the window
      * the first sampled token must be a timestamp, capped by
        max_initial_timestamp
      * if the total probability mass on timestamps beats the best text
        token, text is masked
    """
    b, v = logits.shape
    dev = logits.device
    pos = torch.as_tensor(pos, dtype=torch.long, device=dev)
    ids = torch.arange(v, device=dev)
    is_ts = ids >= sp.timestamp_begin

    logits = logits.masked_fill((ids == sp.notimestamps)[None, :], NEG_INF)

    def at(offset: int) -> torch.Tensor:  # tokens[:, pos - offset], clamped to 0
        return tokens.gather(1, (pos - offset).clamp(min=0).expand(b, 1))[:, 0]

    last_was_ts = (pos - 1 >= sample_begin) & (at(1) >= sp.timestamp_begin)
    penult_was_ts = (pos - 2 < sample_begin) | (at(2) >= sp.timestamp_begin)

    # after a lone timestamp → mask text (EOT stays allowed); after a
    # completed pair → mask timestamps
    mask_text = last_was_ts & ~penult_was_ts
    mask_ts = last_was_ts & penult_was_ts
    text_ids = ids < sp.eot
    logits = logits.masked_fill(mask_text[:, None] & text_ids[None, :], NEG_INF)
    logits = logits.masked_fill(mask_ts[:, None] & is_ts[None, :], NEG_INF)

    # monotonic timestamps: mask [timestamp_begin, floor)
    positions = torch.arange(tokens.shape[1], device=dev)
    sampled = (positions >= sample_begin) & (positions < pos)
    ts_vals = torch.where(sampled[None, :] & (tokens >= sp.timestamp_begin), tokens, -1)
    max_ts = ts_vals.amax(dim=1)  # -1 if none
    floor = torch.where(mask_text, max_ts, max_ts + 1)
    mono = (max_ts >= 0)[:, None] & is_ts[None, :] & (ids[None, :] < floor[:, None])
    logits = logits.masked_fill(mono, NEG_INF)

    # first sampled token must be a timestamp, within the initial cap
    at_begin = pos == sample_begin
    too_late = ids > sp.timestamp_begin + max_initial_timestamp_index
    logits = logits.masked_fill(at_begin & ~(is_ts & ~too_late)[None, :], NEG_INF)

    return _apply_ts_prob_rule(logits, is_ts)


def _apply_ts_prob_rule(logits: torch.Tensor, is_ts: torch.Tensor) -> torch.Tensor:
    # the softmax normaliser cancels on both sides of the comparison, so
    # raw logits suffice
    ts_logprob = torch.logsumexp(logits.masked_fill(~is_ts[None, :], NEG_INF), dim=-1)
    max_text = logits.masked_fill(is_ts[None, :], NEG_INF).amax(dim=-1)
    force_ts = ts_logprob > max_text
    return logits.masked_fill(force_ts[:, None] & ~is_ts[None, :], NEG_INF)


def language_token_mask(sp: SpecialTokens) -> np.ndarray:
    """Bias that keeps only language tokens (LanguageLogitsFilter)."""
    bias = np.full((sp.n_vocab,), NEG_INF, np.float32)
    bias[sp.language_begin : sp.language_begin + sp.n_languages] = 0.0
    return bias
