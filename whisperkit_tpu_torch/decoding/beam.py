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

The JAX package runs the search as one `lax.while_loop`. Here one position
is one call of `_step`, which touches tensors only, as decoding/loop.py's
step does: the position lives on the device (a 0-d int64 tensor), and the
step writes the tokens, log-probabilities, beam scores, the finished set,
`done`, the mask row, the last logits and `length` in place. On CUDA the
first step with a decoder runs eagerly and is then captured as a CUDA
graph (`decoding/graph.py`), which the later positions replay, on every
tp rank its own (the step's all-reduces are device kernels); on the CPU
and with `cuda_graph=False` the same `_step` runs eagerly. The host
counts positions and reads the `done` mask every `stop_check_interval`
steps. Stopping late is exact: a finished window's
rows are frozen, and `length` is the position after the step that left
every window done, where JAX's loop stops.

The caches are laid out [L, B*K, H, S, Dh] and reordered by beam once per
step (the JAX package's gather). A gather cannot write over its own
source, so the self-KV cache has two buffers: the step at an even offset
from the prompt gathers buffer 0 into buffer 1 and runs the decoder on
buffer 1, the next step the other way round, and each parity has its own
graph. The T==1 steps run K4 over the B*K rows. The cross-KV is raw,
repeated to B*K rows (the pipeline never hands beam search the int8 form).

Ranking matches `lax.top_k`: candidates sort by value, ties by lower index
(a stable descending sort), on the CPU and the card alike.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from whisperkit_tpu_torch.core.signposts import signpost
from whisperkit_tpu_torch.decoding.filters import apply_suppress_blank, apply_timestamp_rules
from whisperkit_tpu_torch.decoding.graph import StepGraph
from whisperkit_tpu_torch.models.whisper import (
    WhisperDims, check_group, decoder_forward, init_kv_cache, local_heads, rank_captured,
)
from whisperkit_tpu_torch.text.tokenizer import SpecialTokens

NEG = -1e9


class BeamDecodeOutput(NamedTuple):
    tokens: torch.Tensor  # [B, TOTAL] best-hypothesis tokens (EOT-padded)
    token_logprobs: torch.Tensor  # [B, TOTAL]
    sum_logprob: torch.Tensor  # [B] of the winning hypothesis
    length: int  # final position: after the step that left every window done, else TOTAL
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


def _graphs_on(device: torch.device) -> bool:
    """Whether beam steps on `device` run as CUDA graphs: on a card."""
    return device.type == "cuda"


@dataclasses.dataclass
class _Beam:
    """One search's state: the inputs that stay fixed, and the buffers the
    steps write in place (rows are window-major: row w*K + j is beam j of
    window w)."""

    params: dict
    cross_k: torch.Tensor  # [L, B*K, H, 1500, Dh]
    cross_v: torch.Tensor
    suppress_bias: torch.Tensor
    max_initial_timestamp_index: int
    dims: WhisperDims
    special: SpecialTokens
    sample_begin: int
    total: int
    beam_size: int
    use_timestamp_rules: bool
    suppress_blank: bool
    length_penalty: Optional[float]
    kv_k: tuple[torch.Tensor, torch.Tensor]  # the two cache buffers, [L, B*K, H, TOTAL, Dh] each
    kv_v: tuple[torch.Tensor, torch.Tensor]
    tokens: torch.Tensor  # [B*K, TOTAL]
    tok_lps: torch.Tensor  # [B*K, TOTAL]
    beam_lp: torch.Tensor  # [B*K] live beams' sums
    fin_tokens: torch.Tensor  # [B*K, TOTAL] the finished set, K a window
    fin_lps: torch.Tensor
    fin_sum: torch.Tensor  # [B*K], NEG where empty
    fin_len: torch.Tensor  # [B*K] sampled length with the EOT
    done: torch.Tensor  # [B] bool
    last_logits: torch.Tensor  # [B*K, V]
    mask_row: torch.Tensor  # [1, TOTAL] additive mask of the T==1 step
    pos: int  # next write position, as the host counts it
    pos_dev: torch.Tensor  # the same, 0-d int64 on the device: what the step reads
    length: torch.Tensor  # 0-d int64: the position after the step that left every window done, else TOTAL
    use_graph: bool
    graphs: list  # per parity of pos - sample_begin, its step's graph once captured


def _step(st: _Beam, forward: bool, parity: int) -> None:
    """Search the position `st.pos_dev` points at, on tensors only (what a
    CUDA graph captures): expand the beams, merge the EOT candidates into
    the finished set, pick the K live continuations, write their tokens and
    log-probabilities at the position, update `done` and `length`; with
    `forward`, gather the self-KV cache by beam from buffer `parity` into
    the other, open the mask row at the position and run the decoder on the
    new tokens; then advance the position. No host value depends on the
    position."""
    sp, k, dev = st.special, st.beam_size, st.tokens.device
    bk, v = st.last_logits.shape
    b = bk // k
    pos = st.pos_dev
    at = pos.view(1)
    batch_idx = torch.arange(b, device=dev)[:, None]
    own = torch.arange(bk, device=dev)

    lg = st.last_logits + st.suppress_bias[None, :]
    if st.suppress_blank:
        lg = apply_suppress_blank(lg, sp, pos == st.sample_begin)
    if st.use_timestamp_rules:
        lg = apply_timestamp_rules(lg, st.tokens, pos, st.sample_begin, sp, st.max_initial_timestamp_index)
    cand = (st.beam_lp[:, None] + torch.log_softmax(lg, dim=-1)).reshape(b, k * v)
    top_lp, top_idx = _top_k(cand, 2 * k)  # [B, 2K]
    src_beam = top_idx // v  # beam within the window
    tok_id = top_idx % v
    is_eot = tok_id == sp.eot
    beam_lp = st.beam_lp.reshape(b, k)

    # --- the finished set, updated with the EOT candidates -----------------
    new_len = pos - st.sample_begin + 1  # the EOT counts
    penalty = st.length_penalty
    cand_fin_score = _length_score(top_lp, new_len, penalty)
    fin_score = _length_score(st.fin_sum, st.fin_len, penalty).reshape(b, k)
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
    step_lp = (torch.gather(top_lp, 1, new_sel) - torch.gather(beam_lp, 1, new_beam)).reshape(-1)

    new_fin_t = st.tokens.index_select(0, new_src_rows)
    new_fin_t.index_copy_(1, at, new_tok[:, None])
    new_fin_l = st.tok_lps.index_select(0, new_src_rows)
    new_fin_l.index_copy_(1, at, step_lp[:, None])
    sel = from_old.reshape(-1)[:, None]
    frozen = st.done[:, None].expand(b, k).reshape(-1)  # [B*K]: rows of finished windows
    fin_tokens = torch.where(frozen[:, None], st.fin_tokens,
                             torch.where(sel, st.fin_tokens.index_select(0, old_rows), new_fin_t))
    fin_lps = torch.where(frozen[:, None], st.fin_lps, torch.where(sel, st.fin_lps.index_select(0, old_rows), new_fin_l))
    fin_sum = torch.where(frozen, st.fin_sum, torch.where(
        from_old, torch.gather(st.fin_sum.reshape(b, k), 1, old_sel), torch.gather(eot_lp, 1, new_sel),
    ).reshape(-1))
    fin_len = torch.where(frozen, st.fin_len, torch.where(
        from_old, torch.gather(st.fin_len.reshape(b, k), 1, old_sel), new_len.expand_as(old_sel),
    ).reshape(-1))

    # --- K live (non-EOT) continuations ------------------------------------
    live_sel_lp, live_sel = _top_k(torch.where(is_eot, NEG, top_lp), k)  # [B, K]
    live_beam = torch.gather(src_beam, 1, live_sel)
    live_tok = torch.gather(tok_id, 1, live_sel)
    # finished windows keep their own rows and write EOT (a no-op on the
    # EOT-padded tail)
    src_rows = torch.where(frozen, own, (batch_idx * k + live_beam).reshape(-1))
    write_tok = torch.where(frozen, sp.eot, live_tok.reshape(-1))
    step_live_lp = torch.where(frozen, 0.0, (live_sel_lp - torch.gather(beam_lp, 1, live_beam)).reshape(-1))
    tokens = st.tokens.index_select(0, src_rows)
    tokens.index_copy_(1, at, write_tok[:, None])
    tok_lps = st.tok_lps.index_select(0, src_rows)
    tok_lps.index_copy_(1, at, step_live_lp[:, None])
    beam_lp = torch.where(frozen, st.beam_lp, live_sel_lp.reshape(-1))

    # a window is done when its best live score cannot beat the worst kept
    # finished score
    best_live = _length_score(beam_lp.reshape(b, k), new_len, penalty).amax(dim=1)
    worst_fin = _length_score(fin_sum.reshape(b, k), fin_len.reshape(b, k), penalty).amin(dim=1)
    have_k_fin = (fin_sum.reshape(b, k) > NEG / 2).all(dim=1)
    done = st.done | (have_k_fin & (best_live < worst_fin))

    for buf, new in ((st.fin_tokens, fin_tokens), (st.fin_lps, fin_lps), (st.fin_sum, fin_sum),
                     (st.fin_len, fin_len), (st.tokens, tokens), (st.tok_lps, tok_lps), (st.beam_lp, beam_lp),
                     (st.done, done)):
        buf.copy_(new)
    st.length.copy_(torch.where(done.all(), torch.minimum(st.length, pos + 1), st.length))

    if forward:  # the last position's logits would never be read
        # reorder the self-KV caches by beam: one gather into the other buffer
        kv_k, kv_v = st.kv_k[1 - parity], st.kv_v[1 - parity]
        for src, dst in ((st.kv_k[parity], kv_k), (st.kv_v[parity], kv_v)):
            torch.index_select(src, 1, src_rows, out=dst)
        st.mask_row.index_fill_(1, at, 0.0)
        logits = decoder_forward(
            st.params, write_tok[:, None], pos, kv_k, kv_v, st.cross_k, st.cross_v, st.dims, mask_row=st.mask_row,
        )
        st.last_logits.copy_(logits[:, -1])
    pos.add_(1)


def _advance(st: _Beam, stop_check_interval: int) -> None:
    """Search positions st.pos .. TOTAL - 1, or stop sooner once the host,
    which reads the `done` mask every `stop_check_interval` positions,
    sees every window done. With `st.use_graph`, the first step of each
    parity runs eagerly and is captured, and the later ones replay."""
    while st.pos < st.total:
        if st.pos > st.sample_begin and (st.pos - st.sample_begin) % stop_check_interval == 0:
            with signpost("decode.stop_check", position=st.pos):
                all_done = bool(st.done.all())  # the loop's one host sync, every K steps
            check_group(st.params)
            if all_done:
                return
        forward = st.pos + 1 < st.total
        parity = (st.pos - st.sample_begin) % 2
        if not (st.use_graph and forward):
            _step(st, forward, parity)
        elif st.graphs[parity] is None:
            # runs this position, then captures it
            st.graphs[parity] = StepGraph(lambda p=parity: _step(st, True, p), st.tokens.device)
            rank_captured(st.params)
        else:
            st.graphs[parity].replay()
        st.pos += 1


def _release(st: _Beam) -> None:
    """Free the steps' graphs and their memory pools."""
    for i, g in enumerate(st.graphs):
        if g is not None:
            g.close()
            st.graphs[i] = None


def _start(
    params, cross_k, cross_v, prompt, suppress_bias, max_initial_timestamp_index, *, dims, special, sample_begin,
    max_new_tokens, beam_size, sot_index, use_timestamp_rules, suppress_blank, length_penalty, cuda_graph,
) -> tuple[_Beam, torch.Tensor]:
    """The search's state after the prompt pass, and no_speech_prob [B]."""
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
    dtype, n_head = params["decoder"]["token_embed"].dtype, local_heads(params, dims.n_text_head)
    kv_k, kv_v = init_kv_cache(dims, bk, total, dtype, dev, n_head=n_head)
    # the second buffer of each cache: the odd steps' gathers land in it
    kv_k1, kv_v1 = torch.zeros_like(kv_k), torch.zeros_like(kv_v)

    prompt_bk = prompt.repeat_interleave(k, dim=0)  # [B*K, P]
    logits = decoder_forward(params, prompt_bk, 0, kv_k, kv_v, cross_k_b, cross_v_b, dims)
    no_speech_prob = torch.softmax(logits.reshape(b, k, p, v)[:, 0, sot_index], dim=-1)[:, special.nospeech]
    last_logits = logits[:, -1].contiguous()  # [B*K, V]
    del logits

    tokens = torch.full((bk, total), special.eot, dtype=torch.long, device=dev)
    tokens[:, :p] = prompt_bk
    # beam scores: beam 0 live, the others NEG, so the first expansion draws
    # only from beam 0 (all beams are the same after the prefill)
    beam_lp = torch.tensor([0.0] + [NEG] * (k - 1), dtype=torch.float32, device=dev).repeat(b)  # [B*K]
    mask_row = torch.full((1, total), float("-inf"), dtype=torch.float32, device=dev)
    mask_row[:, :sample_begin] = 0.0
    use_graph = cuda_graph and _graphs_on(dev)
    st = _Beam(
        params, cross_k_b, cross_v_b, suppress_bias, max_initial_timestamp_index, dims, special, sample_begin,
        total, k, use_timestamp_rules, suppress_blank, length_penalty, (kv_k, kv_k1), (kv_v, kv_v1), tokens,
        torch.zeros((bk, total), dtype=torch.float32, device=dev), beam_lp,
        torch.full((bk, total), special.eot, dtype=torch.long, device=dev),
        torch.zeros((bk, total), dtype=torch.float32, device=dev),
        torch.full((bk,), NEG, dtype=torch.float32, device=dev), torch.zeros((bk,), dtype=torch.long, device=dev),
        torch.zeros((b,), dtype=torch.bool, device=dev), last_logits, mask_row, sample_begin,
        torch.tensor(sample_begin, dtype=torch.long, device=dev), torch.tensor(total, dtype=torch.long, device=dev),
        use_graph, [None, None],
    )
    return st, no_speech_prob


def _best(st: _Beam) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The best hypothesis per window: a finished one if any, else the best
    live one (scored at `length`, JAX's final position) → (tokens,
    token_logprobs, sum_logprob)."""
    k, penalty = st.beam_size, st.length_penalty
    b = st.done.shape[0]
    rows0 = torch.arange(b, device=st.tokens.device) * k
    fin_sum = st.fin_sum.reshape(b, k)
    fin_score = _length_score(fin_sum, st.fin_len.reshape(b, k), penalty)
    live_score = _length_score(st.beam_lp.reshape(b, k), st.length - st.sample_begin, penalty)
    have_fin = fin_sum > NEG / 2
    any_fin = have_fin.any(dim=1)
    rows_fin = rows0 + torch.where(have_fin, fin_score, NEG).argmax(dim=1)
    rows_live = rows0 + live_score.argmax(dim=1)
    pick_fin = any_fin[:, None]
    return (
        torch.where(pick_fin, st.fin_tokens[rows_fin], st.tokens[rows_live]),
        torch.where(pick_fin, st.fin_lps[rows_fin], st.tok_lps[rows_live]),
        torch.where(any_fin, st.fin_sum[rows_fin], st.beam_lp[rows_live]),
    )


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
    cuda_graph: bool = True,
) -> BeamDecodeOutput:
    """Beam search of up to `max_new_tokens` tokens per window after the
    prompt. On CUDA the steps replay a CUDA graph of one step per parity;
    `cuda_graph=False` runs them eagerly, for comparison only."""
    st, no_speech_prob = _start(
        params, cross_k, cross_v, prompt, suppress_bias, max_initial_timestamp_index, dims=dims, special=special,
        sample_begin=sample_begin, max_new_tokens=max_new_tokens, beam_size=beam_size, sot_index=sot_index,
        use_timestamp_rules=use_timestamp_rules, suppress_blank=suppress_blank, length_penalty=length_penalty,
        cuda_graph=cuda_graph,
    )
    try:
        _advance(st, stop_check_interval)
    finally:
        _release(st)
    tokens, token_logprobs, sum_logprob = _best(st)
    length = int(st.length)
    check_group(params)
    return BeamDecodeOutput(tokens, token_logprobs, sum_logprob, length, no_speech_prob)
