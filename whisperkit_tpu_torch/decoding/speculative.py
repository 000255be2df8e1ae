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

The JAX package runs the rounds in one `lax.while_loop`. Here each round
is enqueued from the host, which reads the k+1 verified tokens once per
round to decide how many to commit. The draft's T==1 steps run K4 over the
draft cache; the verify pass runs the prefill's plain self-attention, and
K3 with k+1 query rows when the target's cross-KV is int8.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from whisperkit_tpu_torch.decoding.filters import apply_suppress_blank, apply_timestamp_rules
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
):
    """Greedy decode equal to `decode_loop(temperature=0)`; the prefills,
    when given, must hold max_new_tokens + draft_k + 1 positions after the
    prompt."""
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
    kv_t_k, kv_t_v = prefill.kv_k, prefill.kv_v
    kv_d_k, kv_d_v = draft_prefill.kv_k, draft_prefill.kv_v

    tokens = torch.full((1, width), special.eot, dtype=torch.long, device=dev)
    tokens[:, :p] = prompt
    token_logprobs = torch.zeros((1, width), dtype=torch.float32, device=dev)

    def greedy(logits: torch.Tensor, at: int) -> tuple[torch.Tensor, torch.Tensor]:
        logits = logits + suppress_bias[None, :]
        if suppress_blank:
            logits = apply_suppress_blank(logits, special, at == sample_begin)
        if use_timestamp_rules:
            logits = apply_timestamp_rules(
                logits, tokens, at, sample_begin, special, scalars.max_initial_timestamp_index,
            )
        return sample_token(logits, 0.0)

    pos = p
    last_token = prompt[:, -1]  # [1], the newest committed token (at pos - 1)
    done = False
    while pos < total and not done:
        # draft: k greedy steps, provisional writes; the draft has not seen
        # the last round's bonus token, so the round starts by forwarding
        # last_token at pos - 1 (a rewrite of the same K/V when accepted)
        drafts = []
        x = last_token
        for i in range(k):
            logits_d = decoder_forward(
                draft_params, x[:, None], pos - 1 + i, kv_d_k, kv_d_v, draft_cross_k, draft_cross_v, draft_dims,
            )
            x, _ = greedy(logits_d[:, -1], pos + i)
            tokens[:, pos + i] = x
            drafts.append(x)
        # d_{k-1}'s K/V at pos + k - 1 (logits not read)
        decoder_forward(draft_params, x[:, None], pos - 1 + k, kv_d_k, kv_d_v, draft_cross_k, draft_cross_v,
                        draft_dims)

        # verify: one T = k+1 target pass, logits for positions pos .. pos+k
        verify_in = torch.cat([last_token[:, None], torch.stack(drafts, dim=1)], dim=1)
        logits_t = decoder_forward(params, verify_in, pos - 1, kv_t_k, kv_t_v, cross_k, cross_v, dims)
        picks = [greedy(logits_t[:, i], pos + i) for i in range(k + 1)]
        # the round's one host read: the verified tokens, their log-probs
        # and the drafts (float64 holds each exactly)
        host = torch.cat([t for t, _ in picks] + [lp for _, lp in picks] + drafts).double().tolist()
        target = [int(x) for x in host[: k + 1]]
        lps = host[k + 1 : 2 * k + 2]
        draft = [int(x) for x in host[2 * k + 2 :]]

        # the first-token floor (reference TextDecoder.swift:662-678)
        first_fail = pos == sample_begin and lps[0] < scalars.first_token_logprob_threshold
        if first_fail:
            target[0], lps[0] = special.eot, 0.0
        n_acc = 0
        while not first_fail and n_acc < k and draft[n_acc] == target[n_acc]:
            n_acc += 1
        first_eot = next((i for i in range(n_acc + 1) if target[i] == special.eot), k + 1)
        commit_len = min(n_acc + 1, first_eot + 1, total - pos)
        write_tok = [t if i < commit_len else special.eot for i, t in enumerate(target)]
        write_lp = [x if i < commit_len else 0.0 for i, x in enumerate(lps)]
        tokens[0, pos : pos + k + 1] = torch.tensor(write_tok, dtype=torch.long, device=dev)
        token_logprobs[0, pos : pos + k + 1] = torch.tensor(write_lp, dtype=torch.float32, device=dev)
        done = first_fail or special.eot in write_tok[:commit_len]
        last_token = torch.tensor([target[commit_len - 1]], dtype=torch.long, device=dev)
        pos += commit_len

    out = DecodeLoopOutput(tokens[:, :total], token_logprobs[:, :total], min(pos, total), prefill.no_speech_prob)
    if return_state:
        return out, SpeculativeState(pos, kv_t_k, kv_t_v, kv_d_k, kv_d_v)
    return out
