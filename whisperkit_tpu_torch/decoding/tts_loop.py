"""Qwen3-TTS generation loop (port of whisperkit_tpu/decoding/tts_loop.py).

Reference: Sources/TTSKit/Qwen3TTS/Qwen3GenerateTask.swift — prefill
(:233-317) and the generation loop (:326-520): sample codec-0 (top-k,
repetition penalty, suppress set [2048, 3072) except EOS) → the 15-head
code predictor → the next backbone input is the SUM of all 16 code
embeddings plus the trailing text token's embedding (textPAD once the text
is exhausted) (:421-448), stopping on EOS, `max_new_tokens` or the
8x-prompt step cap (:370).

The JAX package runs the frame loop as one `lax.while_loop`; here it is a
host loop over frames that never reads the device within a segment: the
frame's tensors (codes, done, counts) stay on the device, and the host
reads `done` once per segment. `tts_generate_loop` runs segments of
`SEGMENT_FRAMES` until every row is done, which gives the same codes as
one long segment: a done row only ever emits EOS frames. The frames a
segment steps after every row is done are then taken back: the returned
`length` counts the frames up to the one that left every row done, as
JAX's loop does, and the cache slots the later frames wrote are zeroed.

Sampling is JAX's: top-k, then argmax(top_vals / max(T, 1e-4) + g) with
Gumbel noise g, which is what `jax.random.categorical` computes; the noise
comes from a `torch.Generator`, one draw per frame for code0 and the 15
heads together. Temperature 0 takes the argmax and draws nothing.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from whisperkit_tpu_torch.models.qwen3_tts import (
    CODEC_EOS,
    CODEC_VOCAB,
    SUPPRESS_BEGIN,
    SUPPRESS_END,
    Params,
    Qwen3TTSDims,
    code_decoder_forward,
    init_code_kv_cache,
    multicode_forward,
    sample_topk,
)
from whisperkit_tpu_torch.parallel.mesh import gumbel

# frames between two reads of `done` by the host in `tts_generate_loop`
SEGMENT_FRAMES = 16
HEAD_TOP_K = 5  # the code predictor's heads sample from their top 5


def suppress_bias(device) -> torch.Tensor:
    """[CODEC_VOCAB] f32: -inf on the control range [2048, 3072) but EOS
    (Qwen3Models.swift:76-82), 0 elsewhere."""
    bias = torch.zeros(CODEC_VOCAB, dtype=torch.float32)
    bias[SUPPRESS_BEGIN:SUPPRESS_END] = -float("inf")
    bias[CODEC_EOS] = 0.0
    return bias.to(device)


class TTSScalars(NamedTuple):
    temperature: float
    repetition_penalty: float  # 1.0 = off
    generator: torch.Generator  # on the loop's device, or a mesh shard's parallel.mesh.RowDraws


class TTSLoopOutput(NamedTuple):
    codes: torch.Tensor  # [B, MAX, 16] int32 (code0 + 15 heads), EOS-padded
    n_frames: torch.Tensor  # [B] frames generated per row (before EOS)
    kv: tuple  # final KV cache (for prompt caching)
    length: int  # frames stepped


def apply_repetition_penalty(logits: torch.Tensor, counts: torch.Tensor, penalty) -> torch.Tensor:
    """CTRL-style: seen tokens' logits are divided (if > 0) or multiplied
    (if < 0) by the penalty. Reference: Sampling.swift:54-96."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(counts > 0, penalized, logits)


@dataclasses.dataclass
class TTSGenState:
    """Resumable generation state: what a segment needs to continue, so that
    a stream can vocode and play each block as soon as its codes exist.
    `tts_generate_segment` advances it in place."""

    step: int  # frames generated so far
    bos_slot: int  # cache slot of the last prompt position (firstText + codecBOS)
    kv: tuple  # (k, v) [L, B, KVH, S, Dh]
    logits: torch.Tensor  # [B, 1, V] last backbone logits
    hidden: torch.Tensor  # [B, 1, D] last backbone hidden
    counts: torch.Tensor  # [B, CODEC_VOCAB] repetition-penalty history
    done: torch.Tensor  # [B] bool
    generator: torch.Generator
    prompt_pad: torch.Tensor  # [B]
    key_invalid: torch.Tensor  # [B, S]
    trailing_text: torch.Tensor  # [B, TT] text tokens fed one per frame, textPAD-padded
    step_cap: torch.Tensor  # [B] per-row frame budget (8x prompt rule)


@torch.inference_mode()
def tts_prefill_state(
    params: Params,
    prompt_embeds: torch.Tensor,  # [B, P, D] combined text+codec embeds, ending
    # with the variable position (firstText + codecBOS)
    trailing_text: torch.Tensor,  # [B, TT] textPAD-padded
    step_cap: torch.Tensor,  # [B]
    generator: torch.Generator,
    *,
    dims: Qwen3TTSDims,
    max_seq: int,
    cached_kv: Optional[tuple] = None,  # (k, v) prefix snapshot from tts_prefill, batch 1
    cached_len: int = 0,
    prompt_pad: Optional[torch.Tensor] = None,  # [B] left-pad counts within prompt_embeds
) -> TTSGenState:
    """Prefill the dual-track prompt after any cached prefix, whose KV is
    restored into every row (Qwen3GenerateTask.swift:233-317). Rotary
    positions shift left by each row's pad count so real tokens keep
    contiguous positions; the pad slots are hidden from attention."""
    b, p, _ = prompt_embeds.shape
    dev = prompt_embeds.device
    kv_k, kv_v = init_code_kv_cache(dims, b, max_seq, params["text_embed"].dtype, dev)
    if prompt_pad is None:
        prompt_pad = torch.zeros(b, dtype=torch.int64, device=dev)
    prompt_pad = prompt_pad.to(dev, torch.int64)
    slot = torch.arange(max_seq, device=dev)[None, :]
    key_invalid = (slot >= cached_len) & (slot < cached_len + prompt_pad[:, None])
    if cached_kv is not None and cached_len > 0:
        kv_k[:, :, :, :cached_len] = cached_kv[0][:, :1, :, :cached_len].to(dev)
        kv_v[:, :, :, :cached_len] = cached_kv[1][:, :1, :, :cached_len].to(dev)
    logits, hidden = code_decoder_forward(
        params, prompt_embeds.to(kv_k.dtype), cached_len, kv_k, kv_v, dims,
        rope_offset=cached_len - prompt_pad, key_invalid=key_invalid,
    )
    return TTSGenState(
        step=0,
        bos_slot=cached_len + p - 1,
        kv=(kv_k, kv_v),
        logits=logits[:, -1:],
        hidden=hidden[:, -1:],
        counts=torch.zeros((b, CODEC_VOCAB), dtype=torch.int32, device=dev),
        done=torch.zeros(b, dtype=torch.bool, device=dev),
        generator=generator,
        prompt_pad=prompt_pad,
        key_invalid=key_invalid,
        trailing_text=trailing_text.to(dev, torch.int64),
        step_cap=step_cap.to(dev, torch.int64),
    )


@torch.inference_mode()
def tts_generate_segment(
    params: Params,
    state: TTSGenState,
    scalars: TTSScalars,
    *,
    dims: Qwen3TTSDims,
    n_frames: int,
    top_k: int = 50,
) -> tuple[torch.Tensor, TTSGenState]:
    """Generate `n_frames` more frames → (codes [B, n_frames, 16] int32,
    the state advanced in place). A row that is done emits EOS frames;
    the host reads nothing from the device here."""
    kv_k, kv_v = state.kv
    b = state.counts.shape[0]
    dev = state.counts.device
    rows = torch.arange(b, device=dev)
    suppress = suppress_bias(dev)
    tt = state.trailing_text.shape[1]
    temperature = scalars.temperature
    frames = []
    for _ in range(n_frames):
        lg = apply_repetition_penalty(state.logits[:, -1] + suppress, state.counts, scalars.repetition_penalty)
        noise = None
        if temperature > 0:
            noise = gumbel(state.generator, (b, top_k + 15 * HEAD_TOP_K), dev)
        code0 = sample_topk(lg, temperature, top_k, None if noise is None else noise[:, :top_k])
        code0 = torch.where(state.done, CODEC_EOS, code0)
        eos = code0 == CODEC_EOS
        done = state.done | eos | (state.step + 1 >= state.step_cap)
        state.counts.index_put_((rows, code0), torch.ones_like(code0, dtype=torch.int32), accumulate=True)

        # the 15 RVQ heads; codec_sum is the sum of all 16 code embeddings
        head_noise = None if noise is None else noise[:, top_k:].reshape(b, 15, HEAD_TOP_K)
        mc, codec_sum = multicode_forward(
            params, state.hidden[:, -1], code0, temperature, HEAD_TOP_K, dims=dims, noise=head_noise,
        )
        frame = torch.cat([code0[:, None], mc], dim=1)
        frames.append(torch.where((done & eos)[:, None], CODEC_EOS, frame))

        # next backbone input: codec sum + the trailing text token's embedding
        text_tok = state.trailing_text[:, min(state.step, tt - 1)]
        text_emb = params["text_embed"][text_tok].to(codec_sum.dtype)
        nxt = (codec_sum + text_emb)[:, None].to(kv_k.dtype)
        slot = state.bos_slot + 1 + state.step
        state.logits, state.hidden = code_decoder_forward(
            params, nxt, slot, kv_k, kv_v, dims,
            rope_offset=slot - state.prompt_pad, key_invalid=state.key_invalid,
        )
        state.done = done
        state.step += 1
    codes = torch.stack(frames, dim=1).to(torch.int32) if frames else torch.full(
        (b, 0, 16), CODEC_EOS, dtype=torch.int32, device=dev)
    return codes, state


@torch.inference_mode()
def tts_generate_loop(
    params: Params,
    prompt_embeds: torch.Tensor,  # [B, P, D] combined dual-track embeds
    scalars: TTSScalars,
    *,
    dims: Qwen3TTSDims,
    max_new_tokens: int,
    top_k: int = 50,
    max_seq: int = 0,
    cached_kv: Optional[tuple] = None,
    cached_len: int = 0,
    prompt_pad: Optional[torch.Tensor] = None,  # [B] left-pad counts within prompt_embeds
    trailing_text: Optional[torch.Tensor] = None,  # [B, TT]; defaults to all-textPAD
    step_cap: Optional[torch.Tensor] = None,  # [B]; defaults to max_new_tokens
) -> TTSLoopOutput:
    """Prefill, then frames in segments of SEGMENT_FRAMES until every row is
    done or `max_new_tokens` frames exist → codes [B, max_new_tokens, 16]."""
    b, p, _ = prompt_embeds.shape
    dev = prompt_embeds.device
    max_seq = max_seq or cached_len + p + max_new_tokens + 1
    if trailing_text is None:
        trailing_text = torch.full((b, 1), dims.text_pad, dtype=torch.int64, device=dev)
    if step_cap is None:
        step_cap = torch.full((b,), max_new_tokens, dtype=torch.int64, device=dev)
    state = tts_prefill_state(
        params, prompt_embeds, trailing_text, step_cap, scalars.generator,
        dims=dims, max_seq=max_seq, cached_kv=cached_kv, cached_len=cached_len, prompt_pad=prompt_pad,
    )
    codes = torch.full((b, max_new_tokens, 16), CODEC_EOS, dtype=torch.int32, device=dev)
    while state.step < max_new_tokens:
        start = state.step
        seg, state = tts_generate_segment(
            params, state, scalars, dims=dims, n_frames=min(SEGMENT_FRAMES, max_new_tokens - start), top_k=top_k,
        )
        codes[:, start:state.step] = seg
        if bool(state.done.all()):
            break
    n_frames = (codes[:, :, 0] != CODEC_EOS).sum(dim=1)
    length = int(_frames_until_done(codes[:, :state.step, 0], state.step_cap))
    # JAX's loop stops at the frame that leaves every row done; the frames
    # stepped after it within the segment wrote slots JAX leaves at zero
    for cache in state.kv:
        cache[:, :, :, state.bos_slot + 1 + length:] = 0
    return TTSLoopOutput(codes=codes, n_frames=n_frames, kv=state.kv, length=length)


def _frames_until_done(code0: torch.Tensor, step_cap: torch.Tensor) -> torch.Tensor:
    """code0 [B, N] of the frames stepped → 0-d count of the frames JAX's
    `while_loop` steps: up to and including the first frame after which
    every row is done (an EOS so far, or the row's step cap reached), else N."""
    n = code0.shape[1]
    frame = torch.arange(1, n + 1, device=code0.device)
    done = ((code0 == CODEC_EOS).cumsum(dim=1) > 0) | (frame[None, :] >= step_cap[:, None])
    all_done = torch.cat([done.all(dim=0), torch.ones(1, dtype=torch.bool, device=code0.device)])
    return (all_done.int().argmax() + 1).clamp(max=n)


@torch.inference_mode()
def tts_prefill(params: Params, prompt_embeds: torch.Tensor, *, dims: Qwen3TTSDims, max_seq: int) -> tuple:
    """Prefill only → the (k, v) snapshot of the prompt cache.

    Reference: TTSKit.swift `buildPromptCache` (:609-683)."""
    kv_k, kv_v = init_code_kv_cache(
        dims, prompt_embeds.shape[0], max_seq, params["text_embed"].dtype, prompt_embeds.device)
    code_decoder_forward(params, prompt_embeds.to(kv_k.dtype), 0, kv_k, kv_v, dims)
    return kv_k, kv_v
