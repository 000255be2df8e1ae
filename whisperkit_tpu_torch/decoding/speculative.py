"""Lossless speculative decoding (port of whisperkit_tpu/decoding/speculative.py):
a small draft Whisper proposes k tokens, the target verifies them in ONE
T=k+1 teacher-forced pass.

The batch-1 latency mode: the target's step cost is dominated by reading
its weights and cross-KV, so verifying k+1 positions in one pass costs
little more than one step, and a 2-layer draft (distil-large-v3, or the
4-layer large-v3-turbo: large-v3's vocab and mel front end) steps far
cheaper than the 32-layer target.

GREEDY-LOSSLESS by construction: a draft token is accepted iff it equals
the target's filtered argmax given the same prefix, and the first mismatch
position is replaced by the target's own choice, so the committed sequence
is what `decoding/loop.decode_loop` produces at temperature 0, for any
draft model. Scope: batch 1, the greedy rung, no alignment capture.

KV discipline (as the JAX package's): both models write their caches at
the true token positions during draft and verify; entries past the
accepted prefix are stale but are always overwritten before any query
attends them. A round's draft phase makes k+1 writes (positions pos-1 ..
pos+k-1): the last one covers the full-accept case where pos advances by
k+1, which would otherwise leave a zero hole in the draft cache.

The JAX package runs the rounds in one `lax.while_loop`. Here one round
is one call of `_round`, which touches tensors only: the position, the
newest committed token and `done` live on the device, and the
acceptance (the first-token floor, the matches' cumulative product, the
first EOT, the commit capped at the budget) and the masked writes of the
committed tokens run there, as JAX's do. On CUDA the first round runs
eagerly and is then captured as a CUDA graph (`decoding/graph.py`), which
every later round replays; on the CPU and with `cuda_graph=False` the same
`_round` runs eagerly. The host counts rounds and reads `done` and the
position every `stop_check_interval` rounds. A round run after the stop
(every row done, or the budget reached) commits nothing: its provisional
draft tokens are overwritten by EOT, so the tokens, log-probabilities and
`length` stay as JAX's loop left them; its K/V writes land at pos-1 and
later, inside the prefills' headroom, where no committed query looks.

The draft's T==1 steps run K4 over the draft cache, each at its device
position with its own mask row; the verify pass runs the prefill's plain
self-attention over the whole cache at the device position, and K3 with
k+1 query rows when the target's cross-KV is int8.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from whisperkit_tpu_torch.core.signposts import signpost
from whisperkit_tpu_torch.decoding.filters import apply_suppress_blank, apply_timestamp_rules
from whisperkit_tpu_torch.decoding.graph import StepGraph
from whisperkit_tpu_torch.decoding.loop import DecodeLoopOutput, DecodeScalars, PrefillState, prefill_window
from whisperkit_tpu_torch.decoding.sampler import sample_token
from whisperkit_tpu_torch.models.whisper import WhisperDims, decoder_forward
from whisperkit_tpu_torch.text.tokenizer import SpecialTokens


# draft tokens proposed per round
DRAFT_K = 4


class SpeculativeState(NamedTuple):
    """The loop's final state (for tests: `return_state=True`)."""

    pos: int  # next position to commit
    kv_t_k: torch.Tensor  # target cache
    kv_t_v: torch.Tensor
    kv_d_k: torch.Tensor  # draft cache
    kv_d_v: torch.Tensor
    rounds: int = 0  # rounds that committed tokens: the target passes JAX's loop runs


def _graphs_on(device: torch.device) -> bool:
    """Whether rounds on `device` run as a CUDA graph: on a card."""
    return device.type == "cuda"


@dataclasses.dataclass
class _Spec:
    """One decode's state: the inputs that stay fixed, and the buffers the
    rounds write in place."""

    params: dict
    draft_params: dict
    cross_k: object
    cross_v: object
    draft_cross_k: object
    draft_cross_v: object
    suppress_bias: torch.Tensor
    scalars: DecodeScalars
    dims: WhisperDims
    draft_dims: WhisperDims
    special: SpecialTokens
    sample_begin: int
    total: int
    k: int
    use_timestamp_rules: bool
    suppress_blank: bool
    kv_t_k: torch.Tensor  # the target's cache, TOTAL + k + 1 positions
    kv_t_v: torch.Tensor
    kv_d_k: torch.Tensor  # the draft's
    kv_d_v: torch.Tensor
    tokens: torch.Tensor  # [1, TOTAL + k + 1]
    token_logprobs: torch.Tensor  # [1, TOTAL + k + 1]
    pos: torch.Tensor  # 0-d int64: the next position to commit
    last_token: torch.Tensor  # [1]: the newest committed token (at pos - 1)
    done: torch.Tensor  # [1] bool
    rounds: torch.Tensor  # 0-d int64: rounds that committed tokens


def _greedy(st: _Spec, logits: torch.Tensor, at: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The filtered argmax at the device position `at` and its log-prob."""
    sp = st.special
    logits = logits + st.suppress_bias[None, :]
    if st.suppress_blank:
        logits = apply_suppress_blank(logits, sp, at == st.sample_begin)
    if st.use_timestamp_rules:
        logits = apply_timestamp_rules(
            logits, st.tokens, at, st.sample_begin, sp, st.scalars.max_initial_timestamp_index,
        )
    return sample_token(logits, 0.0)


def _round(st: _Spec) -> None:
    """One draft-then-verify round at the position `st.pos` points at, on
    tensors only (what a CUDA graph captures): k draft steps and the extra
    draft write, one T = k+1 verify pass, the acceptance, the masked writes
    of the committed tokens and log-probs at pos .. pos+k, `done`, the
    newest token and the position advanced by the commit. No host value
    depends on the position."""
    sp, k = st.special, st.k
    pos = st.pos
    dev = pos.device
    idx = torch.arange(k + 1, device=dev)
    stopped = st.done[0] | (pos >= st.total)  # a round after the stop commits nothing

    # draft: k greedy steps, provisional writes; the draft has not seen the
    # last round's bonus token, so the round starts by forwarding
    # last_token at pos - 1 (a rewrite of the same K/V when accepted)
    drafts = []
    x = st.last_token
    for i in range(k):
        logits_d = decoder_forward(
            st.draft_params, x[:, None], pos - 1 + i, st.kv_d_k, st.kv_d_v, st.draft_cross_k, st.draft_cross_v,
            st.draft_dims,
        )
        at = pos + i
        x, _ = _greedy(st, logits_d[:, -1], at)
        st.tokens.index_copy_(1, at.view(1), x[:, None])
        drafts.append(x)
    # d_{k-1}'s K/V at pos + k - 1 (logits not read)
    decoder_forward(st.draft_params, x[:, None], pos - 1 + k, st.kv_d_k, st.kv_d_v, st.draft_cross_k,
                    st.draft_cross_v, st.draft_dims)

    # verify: one T = k+1 target pass, logits for positions pos .. pos+k
    draft_vec = torch.cat(drafts)  # [k]
    verify_in = torch.cat([st.last_token, draft_vec])[None]
    logits_t = decoder_forward(st.params, verify_in, pos - 1, st.kv_t_k, st.kv_t_v, st.cross_k, st.cross_v, st.dims)
    picks = [_greedy(st, logits_t[:, i], pos + i) for i in range(k + 1)]
    target = torch.cat([t for t, _ in picks])  # [k+1]
    lps = torch.cat([lp for _, lp in picks])

    # the first-token floor (reference TextDecoder.swift:662-678)
    first_fail = (pos == st.sample_begin) & (lps[0] < st.scalars.first_token_logprob_threshold)
    at_first = first_fail & (idx == 0)
    target = torch.where(at_first, sp.eot, target)
    lps = torch.where(at_first, 0.0, lps)

    # acceptance and commit
    n_acc = torch.where(first_fail, 0, torch.cumprod((draft_vec == target[:k]).long(), 0).sum())
    eot_hit = (target == sp.eot) & (idx <= n_acc)
    first_eot = torch.where(eot_hit.any(), eot_hit.long().argmax(), k + 1)
    commit_len = torch.minimum(torch.minimum(n_acc + 1, first_eot + 1), st.total - pos)
    commit_len = torch.where(stopped, 0, commit_len)
    committed = idx < commit_len
    write_tok = torch.where(committed, target, sp.eot)
    slots = pos + idx
    st.tokens.index_copy_(1, slots, write_tok[None])
    st.token_logprobs.index_copy_(1, slots, torch.where(committed, lps, 0.0)[None])
    st.done.copy_(st.done | (first_fail & ~stopped) | ((write_tok == sp.eot) & committed).any())
    newest = target.index_select(0, (commit_len - 1).clamp_min(0).view(1))
    st.last_token.copy_(torch.where(commit_len > 0, newest, st.last_token))
    st.rounds.add_((commit_len > 0).long())
    pos.add_(commit_len)


@torch.inference_mode()
def speculative_decode_loop(
    params,
    draft_params,
    cross_k,  # target cross-KV [L, 1, H, 1500, Dh] (or the int8 form)
    cross_v,
    draft_cross_k,  # draft cross-KV
    draft_cross_v,
    prompt: torch.Tensor,  # [1, P]
    suppress_bias: torch.Tensor,  # [V] f32 additive
    scalars: DecodeScalars,
    *,
    dims: WhisperDims,
    draft_dims: WhisperDims,
    special: SpecialTokens,
    sample_begin: int,
    max_new_tokens: int,
    draft_k: int = DRAFT_K,
    sot_index: int = 0,
    use_timestamp_rules: bool = True,
    suppress_blank: bool = False,
    prefill: Optional[PrefillState] = None,
    draft_prefill: Optional[PrefillState] = None,
    return_state: bool = False,
    stop_check_interval: int = 4,
    cuda_graph: bool = True,
):
    """Greedy decode equal to `decode_loop(temperature=0)`; the prefills,
    when given, must hold max_new_tokens + draft_k + 1 positions after the
    prompt. On CUDA the rounds replay a CUDA graph of one round;
    `cuda_graph=False` runs them eagerly, for comparison only."""
    b, p = prompt.shape
    if b != 1:
        raise ValueError(f"speculative decoding is the batch-1 mode, got a batch of {b}")
    if p != sample_begin:
        raise ValueError(f"prompt length {p} != sample_begin {sample_begin}")
    if dims.n_vocab != draft_dims.n_vocab:
        raise ValueError("the draft must share the target's vocab")
    k = draft_k
    total = sample_begin + max_new_tokens
    width = total + k + 1  # headroom: a round's writes never pass the buffers
    dev = prompt.device
    headroom = dict(special=special, sample_begin=sample_begin, max_new_tokens=max_new_tokens + k + 1,
                    sot_index=sot_index)
    if prefill is None:
        prefill = prefill_window(params, cross_k, cross_v, prompt, dims=dims, **headroom)
    if draft_prefill is None:
        draft_prefill = prefill_window(draft_params, draft_cross_k, draft_cross_v, prompt, dims=draft_dims, **headroom)

    tokens = torch.full((1, width), special.eot, dtype=torch.long, device=dev)
    tokens[:, :p] = prompt
    st = _Spec(
        params, draft_params, cross_k, cross_v, draft_cross_k, draft_cross_v, suppress_bias, scalars, dims,
        draft_dims, special, sample_begin, total, k, use_timestamp_rules, suppress_blank, prefill.kv_k, prefill.kv_v,
        draft_prefill.kv_k, draft_prefill.kv_v, tokens, torch.zeros((1, width), dtype=torch.float32, device=dev),
        torch.tensor(p, dtype=torch.long, device=dev), prompt[:, -1].clone(),
        torch.zeros((1,), dtype=torch.bool, device=dev), torch.zeros((), dtype=torch.long, device=dev),
    )
    use_graph = cuda_graph and _graphs_on(dev)
    graph = None
    at, stop = p, max_new_tokens <= 0  # the position and the stop, as the host last read them
    try:
        while not stop:
            for _ in range(stop_check_interval):
                if not use_graph:
                    _round(st)
                elif graph is None:
                    graph = StepGraph(lambda: _round(st), dev)  # runs this round, then captures it
                else:
                    graph.replay()
            # the loop's one host read, every few rounds
            with signpost("decode.stop_check", position=at):
                done, at = torch.stack([st.done[0].long(), st.pos]).tolist()
            stop = bool(done) or at >= total
    finally:
        if graph is not None:
            graph.close()

    out = DecodeLoopOutput(tokens[:, :total], st.token_logprobs[:, :total], min(at, total), prefill.no_speech_prob)
    if return_state:
        return out, SpeculativeState(at, st.kv_t_k, st.kv_t_v, st.kv_d_k, st.kv_d_v, int(st.rounds))
    return out
