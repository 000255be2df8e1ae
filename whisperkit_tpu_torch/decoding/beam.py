"""Beam-search decoding, batched over windows × beams (port of
whisperkit_tpu/decoding/beam.py).

Reference: Sources/WhisperKit/Core/Text/TokenSampler.swift:254-290 declares
`BeamSearchTokenSampler` with a `fatalError("Not implemented")` body; this
follows the JAX package, which implements openai/whisper `BeamSearchDecoder`
semantics (decoding.py):

  * K beams per window, expanded from the top-2K (beam, token) candidates
  * hypotheses ending in EOT move to a finished set (best K kept)
  * a window finishes when its finished set can no longer be improved
  * final score = sum_logprob / length (or the GNMT length penalty
    ((5+L)/6)^p when `length_penalty` is set)

The JAX package runs the search as one `lax.while_loop`; here the loop is a
host `for` over positions, like decoding/loop.py, that reads the `done`
mask every `stop_check_interval` steps. Stopping late is exact: a finished
window's rows are frozen. The caches are laid out [L, B*K, H, S, Dh] and
reordered by beam once per step, a copy of the whole self-KV cache (the JAX
package's gather); the T==1 steps run K4 over the B*K rows. The cross-KV is
raw, repeated to B*K rows (the pipeline never hands beam search the int8
form).

Ranking matches `lax.top_k`: candidates sort by value, ties by lower index
(a stable descending sort), on the CPU and the card alike.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from whisperkit_tpu_torch.decoding.filters import apply_suppress_blank, apply_timestamp_rules
from whisperkit_tpu_torch.models.whisper import WhisperDims, decoder_forward, init_kv_cache, local_heads
from whisperkit_tpu_torch.text.tokenizer import SpecialTokens

NEG = -1e9


class BeamDecodeOutput(NamedTuple):
    tokens: torch.Tensor  # [B, TOTAL] best-hypothesis tokens (EOT-padded)
    token_logprobs: torch.Tensor  # [B, TOTAL]
    sum_logprob: torch.Tensor  # [B] of the winning hypothesis
    length: int  # final position
    no_speech_prob: torch.Tensor  # [B]


def _length_score(sum_lp: torch.Tensor, lengths, length_penalty: Optional[float]) -> torch.Tensor:
    lengths = torch.clamp_min(torch.as_tensor(lengths, device=sum_lp.device), 1).to(torch.float32)
    if length_penalty is None:
        return sum_lp / lengths
    return sum_lp / ((5.0 + lengths) / 6.0) ** length_penalty


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (`jax.lax.top_k`)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.inference_mode()
def beam_decode_loop(
    params,
    cross_k,  # [L, B, H, 1500, Dh] raw
    cross_v,
    prompt: torch.Tensor,  # [B, P]
    suppress_bias: torch.Tensor,  # [V]
    max_initial_timestamp_index: int,
    *,
    dims: WhisperDims,
    special: SpecialTokens,
    sample_begin: int,
    max_new_tokens: int,
    beam_size: int,
    sot_index: int,
    use_timestamp_rules: bool,
    suppress_blank: bool,
    length_penalty: Optional[float] = None,
    stop_check_interval: int = 16,
) -> BeamDecodeOutput:
    if isinstance(cross_k, dict):
        raise TypeError("beam search takes the raw cross-KV, not the int8 form")
    b, p = prompt.shape
    k = beam_size
    bk = b * k
    total = sample_begin + max_new_tokens
    v = dims.n_vocab
    dev = prompt.device

    cross_k_b = cross_k.repeat_interleave(k, dim=1)  # [L, B*K, H, 1500, Dh]
    cross_v_b = cross_v.repeat_interleave(k, dim=1)
    kv_k, kv_v = init_kv_cache(dims, bk, total, params["decoder"]["token_embed"].dtype, dev,
                               n_head=local_heads(params, dims.n_text_head))

    prompt_bk = prompt.repeat_interleave(k, dim=0)  # [B*K, P]
    logits = decoder_forward(params, prompt_bk, 0, kv_k, kv_v, cross_k_b, cross_v_b, dims)
    no_speech_prob = torch.softmax(logits.reshape(b, k, p, v)[:, 0, sot_index], dim=-1)[:, special.nospeech]
    last_logits = logits[:, -1]  # [B*K, V]
    del logits

    tokens = torch.full((bk, total), special.eot, dtype=torch.long, device=dev)
    tokens[:, :p] = prompt_bk
    tok_lps = torch.zeros((bk, total), dtype=torch.float32, device=dev)
    # beam scores: beam 0 live, the others NEG, so the first expansion draws
    # only from beam 0 (all beams are the same after the prefill)
    beam_lp = torch.tensor([0.0] + [NEG] * (k - 1), dtype=torch.float32, device=dev).repeat(b)  # [B*K]

    fin_tokens = torch.full((bk, total), special.eot, dtype=torch.long, device=dev)
    fin_lps = torch.zeros((bk, total), dtype=torch.float32, device=dev)
    fin_sum = torch.full((bk,), NEG, dtype=torch.float32, device=dev)
    fin_len = torch.zeros((bk,), dtype=torch.long, device=dev)  # sampled length with the EOT
    done = torch.zeros((b,), dtype=torch.bool, device=dev)

    batch_idx = torch.arange(b, device=dev)[:, None]
    own = torch.arange(bk, device=dev)
    mask_row = torch.full((1, total), float("-inf"), dtype=torch.float32, device=dev)
    mask_row[:, :sample_begin] = 0.0

    pos = sample_begin
    while pos < total:
        if pos > sample_begin and (pos - sample_begin) % stop_check_interval == 0:
            if bool(done.all()):  # the host sync, every K steps
                break
        lg = last_logits + suppress_bias[None, :]
        if suppress_blank:
            lg = apply_suppress_blank(lg, special, pos == sample_begin)
        if use_timestamp_rules:
            lg = apply_timestamp_rules(lg, tokens, pos, sample_begin, special, max_initial_timestamp_index)
        cand = (beam_lp[:, None] + torch.log_softmax(lg, dim=-1)).reshape(b, k * v)
        top_lp, top_idx = _top_k(cand, 2 * k)  # [B, 2K]
        src_beam = top_idx // v  # beam within the window
        tok_id = top_idx % v
        is_eot = tok_id == special.eot

        # --- the finished set, updated with the EOT candidates -------------
        new_len = pos - sample_begin + 1  # the EOT counts
        cand_fin_score = _length_score(top_lp, new_len, length_penalty)
        fin_score = _length_score(fin_sum, fin_len, length_penalty).reshape(b, k)
        eot_lp = torch.where(is_eot, top_lp, NEG)
        eot_score = torch.where(is_eot, cand_fin_score, NEG)  # [B, 2K]
        _, keep = _top_k(torch.cat([fin_score, eot_score], dim=1), k)  # into 3K
        from_old = keep < k  # [B, K]
        old_sel = keep.clamp(0, k - 1)
        old_rows = (batch_idx * k + old_sel).reshape(-1)
        new_sel = (keep - k).clamp(0, 2 * k - 1)  # into the 2K candidates
        new_beam = torch.gather(src_beam, 1, new_sel)
        new_src_rows = (batch_idx * k + new_beam).reshape(-1)
        new_tok = torch.gather(tok_id, 1, new_sel).reshape(-1)  # EOT
        # the step log-prob of the EOT token itself
        step_lp = (torch.gather(top_lp, 1, new_sel) - torch.gather(beam_lp.reshape(b, k), 1, new_beam)).reshape(-1)

        new_fin_t = tokens[new_src_rows]
        new_fin_t[:, pos] = new_tok
        new_fin_l = tok_lps[new_src_rows]
        new_fin_l[:, pos] = step_lp
        sel = from_old.reshape(-1)[:, None]
        frozen = done.repeat_interleave(k)  # [B*K]: rows of finished windows
        fin_tokens = torch.where(frozen[:, None], fin_tokens, torch.where(sel, fin_tokens[old_rows], new_fin_t))
        fin_lps = torch.where(frozen[:, None], fin_lps, torch.where(sel, fin_lps[old_rows], new_fin_l))
        fin_sum_new = torch.where(
            from_old, torch.gather(fin_sum.reshape(b, k), 1, old_sel), torch.gather(eot_lp, 1, new_sel),
        ).reshape(-1)
        fin_len_new = torch.where(
            from_old, torch.gather(fin_len.reshape(b, k), 1, old_sel), torch.full_like(old_sel, new_len),
        ).reshape(-1)
        fin_sum = torch.where(frozen, fin_sum, fin_sum_new)
        fin_len = torch.where(frozen, fin_len, fin_len_new)

        # --- K live (non-EOT) continuations ----------------------------------
        live_sel_lp, live_sel = _top_k(torch.where(is_eot, NEG, top_lp), k)  # [B, K]
        live_beam = torch.gather(src_beam, 1, live_sel)
        live_tok = torch.gather(tok_id, 1, live_sel)
        # finished windows keep their own rows and write EOT (a no-op on the
        # EOT-padded tail)
        src_rows = torch.where(frozen, own, (batch_idx * k + live_beam).reshape(-1))
        write_tok = torch.where(frozen, special.eot, live_tok.reshape(-1))
        step_live_lp = (live_sel_lp - torch.gather(beam_lp.reshape(b, k), 1, live_beam)).reshape(-1)
        step_live_lp = torch.where(frozen, 0.0, step_live_lp)
        tokens = tokens[src_rows]
        tokens[:, pos] = write_tok
        tok_lps = tok_lps[src_rows]
        tok_lps[:, pos] = step_live_lp
        beam_lp = torch.where(frozen, beam_lp, live_sel_lp.reshape(-1))

        # reorder the self-KV caches by beam
        kv_k = kv_k.index_select(1, src_rows)
        kv_v = kv_v.index_select(1, src_rows)

        # a window is done when its best live score cannot beat the worst
        # kept finished score
        best_live = _length_score(beam_lp.reshape(b, k), new_len, length_penalty).amax(dim=1)
        worst_fin = _length_score(fin_sum.reshape(b, k), fin_len.reshape(b, k), length_penalty).amin(dim=1)
        have_k_fin = (fin_sum.reshape(b, k) > NEG / 2).all(dim=1)
        done = done | (have_k_fin & (best_live < worst_fin))

        # the decoder step for every beam row
        mask_row[:, pos] = 0.0
        pos += 1
        if pos < total:  # the last position's logits would never be read
            last_logits = decoder_forward(
                params, tokens[:, pos - 1 : pos], pos - 1, kv_k, kv_v, cross_k_b, cross_v_b, dims,
                mask_row=mask_row,
            )[:, -1]

    # the best hypothesis per window: a finished one if any, else the best live
    fin_score = _length_score(fin_sum.reshape(b, k), fin_len.reshape(b, k), length_penalty)
    live_score = _length_score(beam_lp.reshape(b, k), pos - sample_begin, length_penalty)
    have_fin = fin_sum.reshape(b, k) > NEG / 2
    any_fin = have_fin.any(dim=1)
    rows_fin = batch_idx[:, 0] * k + torch.where(have_fin, fin_score, NEG).argmax(dim=1)
    rows_live = batch_idx[:, 0] * k + live_score.argmax(dim=1)
    pick_fin = any_fin[:, None]
    return BeamDecodeOutput(
        tokens=torch.where(pick_fin, fin_tokens[rows_fin], tokens[rows_live]),
        token_logprobs=torch.where(pick_fin, fin_lps[rows_fin], tok_lps[rows_live]),
        sum_logprob=torch.where(any_fin, fin_sum[rows_fin], beam_lp[rows_live]),
        length=pos,
        no_speech_prob=no_speech_prob,
    )
