"""The Whisper decode loop (port of whisperkit_tpu/decoding/loop.py).

The JAX package runs the whole token loop as one `lax.while_loop` on the
device. Here the loop is a host `for` over positions that only enqueues
work: the position is a host integer, the per-row `done` mask stays on the
device, and the host reads it only every `stop_check_interval` steps to
stop early once every row has finished. Stopping late is exact, because a
finished row keeps emitting EOT with log-probability 0, which is what the
EOT-filled token buffer already holds.

Batching: every function is batched over B windows, with a per-row `done`
mask for heterogeneous finish times.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from whisperkit_tpu_torch.text.tokenizer import SpecialTokens
from whisperkit_tpu_torch.decoding.filters import apply_suppress_blank, apply_timestamp_rules
from whisperkit_tpu_torch.decoding.sampler import sample_token
from whisperkit_tpu_torch.models.whisper import (
    WhisperDims,
    compute_cross_kv,
    compute_cross_kv_quantized,
    decoder_forward,
    encoder_forward,
    init_kv_cache,
)


class DecodeScalars(NamedTuple):
    """Per-call decode settings (host values)."""

    temperature: float
    max_initial_timestamp_index: int  # timestamp-token offset cap
    first_token_logprob_threshold: float  # -inf disables
    generator: Optional[torch.Generator] = None  # for temperature > 0


# a self-attention KV cache: raw [L, B, H, S, Dh], or the int8 form
# {"q8": int8 [L, B, H, S, Dh], "scale": f32 [L, B, H, S, 1]}
KVCache = Union[torch.Tensor, dict[str, torch.Tensor]]


class DecodeLoopOutput(NamedTuple):
    tokens: torch.Tensor  # [B, TOTAL] (prompt + sampled, EOT-padded)
    token_logprobs: torch.Tensor  # [B, TOTAL] f32 (0 in the prompt region)
    length: int  # final write position
    no_speech_prob: torch.Tensor  # [B] f32


class PrefillState(NamedTuple):
    """Prompt-pass results, reusable across the temperature-fallback ladder.

    The decode loop writes the cache in place at positions ≥ sample_begin,
    and each step writes its position before reading it, so a later rung
    that reuses this state never reads a value an earlier rung left. The
    int8 cache is no different: a step writes the codes AND the scale of
    position `pos` before its attention reads them, and the positions after
    `pos`, where an earlier rung's rows may linger, are masked to -inf.
    The kernel does not read them at all; the plain version gives them
    probability 0, and their stale codes and scales are finite, so nothing
    of them reaches the output."""

    kv_k: KVCache  # [L, B, H, TOTAL, Dh] (or int8 form) with the prompt rows filled
    kv_v: KVCache
    last_logits: torch.Tensor  # [B, V] logits at the last prompt position
    no_speech_prob: torch.Tensor  # [B]


def _batch(cross) -> int:
    return (cross["q8"] if isinstance(cross, dict) else cross).shape[1]


@torch.inference_mode()
def encode_window(
    params, mel: torch.Tensor, dims: WhisperDims, quantize_kv: bool = False, act8: bool = False
):
    """mel [B, n_mels, 3000] → (enc_out [B,1500,D], cross_k, cross_v).

    `quantize_kv=True` emits the int8 {"q8", "scale"} cross-KV through the
    per-layer fused project+quantize, so the whole-batch bf16 cross-KV
    never exists. `act8=True` (the "w8a8" scheme) runs the int8-quantized
    encoder linears with int8 activations."""
    enc_out = encoder_forward(params, mel, dims, act8=act8)
    if quantize_kv:
        cross_k, cross_v = compute_cross_kv_quantized(params, enc_out, dims)
    else:
        cross_k, cross_v = compute_cross_kv(params, enc_out, dims)
    return enc_out, cross_k, cross_v


@torch.inference_mode()
def prefill_window(
    params,
    cross_k,
    cross_v,
    prompt: torch.Tensor,  # [B, P]
    *,
    dims: WhisperDims,
    special: SpecialTokens,
    sample_begin: int,
    max_new_tokens: int,
    sot_index: int,
    quantize_self_kv: bool = False,
) -> PrefillState:
    """Run the prompt through the decoder once; see PrefillState.

    `quantize_self_kv=True` allocates the self-attention cache in the int8
    per-token-scale form: rows are quantized as they are written, and the
    decode step reads them through K5 (half the bytes of the bf16 cache).
    The cache's form is fixed here; the decode loop uses whichever it gets."""
    b, p = prompt.shape
    if p != sample_begin:
        raise ValueError(f"prompt length {p} != sample_begin {sample_begin}")
    total = sample_begin + max_new_tokens
    dtype = params["decoder"]["token_embed"].dtype
    kv_k, kv_v = init_kv_cache(dims, b, total, dtype, prompt.device, quantize=quantize_self_kv)
    logits = decoder_forward(params, prompt, 0, kv_k, kv_v, cross_k, cross_v, dims)
    no_speech_prob = torch.softmax(logits[:, sot_index], dim=-1)[:, special.nospeech]
    return PrefillState(kv_k, kv_v, logits[:, -1], no_speech_prob)


@torch.inference_mode()
def decode_loop(
    params,
    cross_k,
    cross_v,
    prompt: torch.Tensor,  # [B, P]
    suppress_bias: torch.Tensor,  # [V] f32 additive
    scalars: DecodeScalars,
    *,
    dims: WhisperDims,
    special: SpecialTokens,
    sample_begin: int,
    max_new_tokens: int,
    top_k: int,
    sot_index: int,
    use_timestamp_rules: bool,
    suppress_blank: bool,
    prefill: Optional[PrefillState] = None,
    stop_check_interval: int = 16,
    quantize_self_kv: bool = False,
) -> DecodeLoopOutput:
    """Greedy (temperature 0) or top-k sampled decode of up to
    `max_new_tokens` tokens per row after the prompt. `quantize_self_kv`
    selects the int8 self-KV cache when there is no `prefill` to reuse."""
    b, p = prompt.shape
    total = sample_begin + max_new_tokens
    dev = prompt.device
    if prefill is None:
        prefill = prefill_window(
            params, cross_k, cross_v, prompt,
            dims=dims, special=special, sample_begin=sample_begin,
            max_new_tokens=max_new_tokens, sot_index=sot_index,
            quantize_self_kv=quantize_self_kv,
        )
    kv_k, kv_v = prefill.kv_k, prefill.kv_v
    s_max = (kv_k["q8"] if isinstance(kv_k, dict) else kv_k).shape[3]

    tokens = torch.full((b, total), special.eot, dtype=torch.long, device=dev)
    tokens[:, :p] = prompt
    token_logprobs = torch.zeros((b, total), dtype=torch.float32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    last_logits = prefill.last_logits
    # additive causal mask row of the T==1 step, opened one position per step
    mask_row = torch.full((1, s_max), float("-inf"), dtype=torch.float32, device=dev)
    mask_row[:, :sample_begin] = 0.0
    first_threshold = scalars.first_token_logprob_threshold

    pos = sample_begin
    while pos < total:
        if pos > sample_begin and (pos - sample_begin) % stop_check_interval == 0:
            if bool(done.all()):  # the loop's one host sync, every K steps
                break
        logits = last_logits + suppress_bias[None, :]
        if suppress_blank:
            logits = apply_suppress_blank(logits, special, pos == sample_begin)
        if use_timestamp_rules:
            logits = apply_timestamp_rules(
                logits, tokens, pos, sample_begin, special,
                scalars.max_initial_timestamp_index,
            )
        token, logprob = sample_token(logits, scalars.temperature, scalars.generator, top_k)

        # stop checks: EOT, the context cap (loop bound), first-token floor
        stop = done
        if pos == sample_begin and first_threshold != float("-inf"):
            stop = stop | (logprob < first_threshold)
        token = torch.where(stop, special.eot, token)
        logprob = torch.where(stop, 0.0, logprob)
        tokens[:, pos] = token
        token_logprobs[:, pos] = logprob
        done = stop | (token == special.eot)

        pos += 1
        if pos < total:  # the last position's logits would never be read
            mask_row[:, pos - 1] = 0.0
            last_logits = decoder_forward(
                params, token[:, None], pos - 1, kv_k, kv_v, cross_k, cross_v, dims,
                mask_row=mask_row,
            )[:, -1]
    return DecodeLoopOutput(tokens, token_logprobs, pos, prefill.no_speech_prob)


@torch.inference_mode()
def detect_language_logits(
    params, cross_k, cross_v, *, dims: WhisperDims, special: SpecialTokens
) -> torch.Tensor:
    """One decode step from SOT → language probabilities [B, n_languages].
    Its tiny cache is always raw, whatever the serving mode (as in JAX)."""
    b = _batch(cross_k)
    dev = (cross_k["q8"] if isinstance(cross_k, dict) else cross_k).device
    dtype = params["decoder"]["token_embed"].dtype
    kv_k, kv_v = init_kv_cache(dims, b, 8, dtype, dev)  # tiny cache for one step
    prompt = torch.full((b, 1), special.sot, dtype=torch.long, device=dev)
    logits = decoder_forward(params, prompt, 0, kv_k, kv_v, cross_k, cross_v, dims)
    lang = logits[:, 0, special.language_begin : special.language_begin + special.n_languages]
    return torch.softmax(lang, dim=-1)
