"""Qwen3-TTS generation loop (port of whisperkit_tpu/decoding/tts_loop.py).

Reference: Sources/TTSKit/Qwen3TTS/Qwen3GenerateTask.swift — prefill
(:233-317) and the generation loop (:326-520): sample codec-0 (top-k,
repetition penalty, suppress set [2048, 3072) except EOS) → the 15-head
code predictor → the next backbone input is the SUM of all 16 code
embeddings plus the trailing text token's embedding (textPAD once the text
is exhausted) (:421-448), stopping on EOS, `max_new_tokens` or the
8x-prompt step cap (:370).

The JAX package runs the frame loop as one `lax.while_loop` on the
device. Here one frame is one call of `_frame`, which touches tensors
only: the frame index lives on the device (`TTSGenState.step_dev`, a 0-d
int64 tensor, as JAX's traced `step`), and the frame writes its codes,
`done`, the repetition counts, the backbone's K/V, logits and hidden
state into buffers whose addresses stay put. On CUDA a segment's first
frame runs eagerly and is then captured as a CUDA graph
(`decoding/graph.py`), which every later frame replays, across segments
too: one launch from the host instead of thousands. On the CPU, and with
`cuda_graph=False`, the same `_frame` runs eagerly. The host counts the
frames, draws the sampler's noise into a buffer before each frame, and
`tts_generate_loop` reads `done` once per `SEGMENT_FRAMES` frames to stop
once every row is done (a `tts.stop_check` span, core/signposts.py, inside
the loop's `tts.frames`, after its `tts.prefill`). That gives the codes of
one long segment: a done row only ever emits EOS frames. The frames a segment steps after every
row is done are then taken back: the returned `length` counts the frames
up to the one that left every row done, as JAX's loop does, and the
cache slots the later frames wrote are zeroed.

Sampling is JAX's: top-k, then argmax(top_vals / max(T, 1e-4) + g) with
Gumbel noise g, which is what `jax.random.categorical` computes; g is made
on the device from uniform draws that the host takes from a
`torch.Generator` (or a mesh shard's `parallel.mesh.RowDraws`) before the
frame, one draw per frame for code0 and the 15 heads together.
Temperature 0 takes the argmax and draws nothing.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from whisperkit_tpu_torch.core.signposts import signpost
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
from whisperkit_tpu_torch.decoding.graph import StepGraph
from whisperkit_tpu_torch.parallel.mesh import gumbel_from_uniform, uniform

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
    length: int  # frames up to the one that left every row done (JAX's loop count)
    steps: int = 0  # frames the loop ran on the device: `length` up to the end of its segment


def apply_repetition_penalty(logits: torch.Tensor, counts: torch.Tensor, penalty) -> torch.Tensor:
    """CTRL-style: seen tokens' logits are divided (if > 0) or multiplied
    (if < 0) by the penalty. Reference: Sampling.swift:54-96."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(counts > 0, penalized, logits)


@dataclasses.dataclass
class TTSGenState:
    """Resumable generation state: what a segment needs to continue, so that
    a stream can vocode and play each block as soon as its codes exist.
    `tts_generate_segment` advances it in place; the tensors keep their
    addresses, which a CUDA graph of the frame relies on."""

    step: int  # frames generated so far, as the host counts them
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
    step_dev: torch.Tensor  # the same as `step`, 0-d int64 on the device: what the frame reads
    codes: torch.Tensor  # [B, S - bos_slot - 1, 16] int32, EOS-filled: frame i at [:, i]
    suppress: torch.Tensor  # [CODEC_VOCAB] f32 suppress_bias
    noise_u: Optional[torch.Tensor] = None  # [B, top_k + 15·HEAD_TOP_K] uniform draws, temperature > 0
    graph: Optional[StepGraph] = None  # the frame's graph, once captured
    graph_key: tuple = ()  # the (temperature, penalty, top_k) the frame was captured with


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
    bos_slot = cached_len + p - 1
    return TTSGenState(
        step=0,
        bos_slot=bos_slot,
        kv=(kv_k, kv_v),
        logits=logits[:, -1:].clone(),
        hidden=hidden[:, -1:].clone(),
        counts=torch.zeros((b, CODEC_VOCAB), dtype=torch.int32, device=dev),
        done=torch.zeros(b, dtype=torch.bool, device=dev),
        generator=generator,
        prompt_pad=prompt_pad,
        key_invalid=key_invalid,
        trailing_text=trailing_text.to(dev, torch.int64),
        step_cap=step_cap.to(dev, torch.int64),
        step_dev=torch.zeros((), dtype=torch.int64, device=dev),
        codes=torch.full((b, max_seq - bos_slot - 1, 16), CODEC_EOS, dtype=torch.int32, device=dev),
        suppress=suppress_bias(dev),
    )


def _frame(params: Params, st: TTSGenState, dims: Qwen3TTSDims, temperature: float, penalty: float,
           top_k: int) -> None:
    """Generate the frame `st.step_dev` points at, on tensors only (what a
    CUDA graph captures): sample code0 from the last logits (the noise in
    `st.noise_u`), run the code predictor's 15 heads, write the frame's
    codes, `done` and the counts, feed the codec sum and the trailing text
    token to the backbone at slot bos_slot + 1 + step, keep its logits and
    hidden state, and advance `step_dev`. No host value depends on the
    frame index."""
    b = st.counts.shape[0]
    step = st.step_dev
    lg = apply_repetition_penalty(st.logits[:, -1] + st.suppress, st.counts, penalty)
    noise = None if st.noise_u is None else gumbel_from_uniform(st.noise_u)
    code0 = sample_topk(lg, temperature, top_k, None if noise is None else noise[:, :top_k])
    code0 = torch.where(st.done, CODEC_EOS, code0)
    eos = code0 == CODEC_EOS
    done = st.done | eos | (step + 1 >= st.step_cap)
    # JAX's `.at[rows, code0].add(1)`: an integer sum, which a capture holds
    st.counts.scatter_add_(1, code0[:, None], torch.ones_like(st.counts[:, :1]))

    # the 15 RVQ heads; codec_sum is the sum of all 16 code embeddings
    head_noise = None if noise is None else noise[:, top_k:].reshape(b, 15, HEAD_TOP_K)
    mc, codec_sum = multicode_forward(
        params, st.hidden[:, -1], code0, temperature, HEAD_TOP_K, dims=dims, noise=head_noise,
    )
    frame = torch.cat([code0[:, None], mc], dim=1)
    frame = torch.where((done & eos)[:, None], CODEC_EOS, frame)
    st.codes.index_copy_(1, step.view(1), frame[:, None].to(torch.int32))

    # next backbone input: codec sum + the trailing text token's embedding
    tt = st.trailing_text.shape[1]
    text_tok = st.trailing_text.index_select(1, step.clamp(max=tt - 1).view(1))[:, 0]
    text_emb = params["text_embed"][text_tok].to(codec_sum.dtype)
    kv_k, kv_v = st.kv
    nxt = (codec_sum + text_emb)[:, None].to(kv_k.dtype)
    slot = st.bos_slot + 1 + step
    logits, hidden = code_decoder_forward(
        params, nxt, slot, kv_k, kv_v, dims, rope_offset=slot - st.prompt_pad, key_invalid=st.key_invalid,
    )
    st.logits.copy_(logits)
    st.hidden.copy_(hidden)
    st.done.copy_(done)
    step.add_(1)


def _graphs_on(device: torch.device) -> bool:
    """Whether frames on `device` run as a CUDA graph: on a card."""
    return device.type == "cuda"


def tts_release(state: TTSGenState) -> None:
    """Free the frame's graph and its memory pool (the loop's end)."""
    if state.graph is not None:
        state.graph.close()
        state.graph = None


@torch.inference_mode()
def tts_generate_segment(
    params: Params,
    state: TTSGenState,
    scalars: TTSScalars,
    *,
    dims: Qwen3TTSDims,
    n_frames: int,
    top_k: int = 50,
    cuda_graph: bool = True,
) -> tuple[torch.Tensor, TTSGenState]:
    """Generate `n_frames` more frames → (codes [B, n_frames, 16] int32,
    the state advanced in place). A row that is done emits EOS frames;
    the host reads nothing from the device here. On CUDA the frames
    replay a CUDA graph of one frame, captured at the state's first frame
    (or anew when the temperature, penalty or top-k change) and kept in
    the state until `tts_release`; the params and dims must stay those it
    was captured with. `cuda_graph=False` runs them eagerly, for
    comparison only."""
    start = state.step
    if start + n_frames > state.codes.shape[1]:
        raise ValueError(f"frames {start}..{start + n_frames} exceed the cache's {state.codes.shape[1]}")
    b, dev = state.counts.shape[0], state.counts.device
    key = (scalars.temperature, scalars.repetition_penalty, top_k)
    if key != state.graph_key:
        tts_release(state)
        state.graph_key = key
        width = top_k + 15 * HEAD_TOP_K
        state.noise_u = torch.zeros((b, width), device=dev) if scalars.temperature > 0 else None
    use_graph = cuda_graph and _graphs_on(dev)

    def frame() -> None:
        _frame(params, state, dims, scalars.temperature, scalars.repetition_penalty, top_k)

    for _ in range(n_frames):
        if state.noise_u is not None:  # the frame's noise, in the eager sampler's draw order
            state.noise_u.copy_(uniform(state.generator, state.noise_u.shape, dev))
        if not use_graph:
            frame()
        elif state.graph is None:
            state.graph = StepGraph(frame, dev)  # runs this frame, then captures it
        else:
            state.graph.replay()
        state.step += 1
    return state.codes[:, start:state.step].clone(), state


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
    cuda_graph: bool = True,
) -> TTSLoopOutput:
    """Prefill, then frames in segments of SEGMENT_FRAMES until every row is
    done or `max_new_tokens` frames exist → codes [B, max_new_tokens, 16].
    On CUDA every frame after the first replays one CUDA graph, released
    at the end; `cuda_graph=False` runs them eagerly, for comparison only."""
    b, p, _ = prompt_embeds.shape
    dev = prompt_embeds.device
    max_seq = max_seq or cached_len + p + max_new_tokens + 1
    if trailing_text is None:
        trailing_text = torch.full((b, 1), dims.text_pad, dtype=torch.int64, device=dev)
    if step_cap is None:
        step_cap = torch.full((b,), max_new_tokens, dtype=torch.int64, device=dev)
    with signpost("tts.prefill", rows=b, positions=p, cached=cached_len):
        state = tts_prefill_state(
            params, prompt_embeds, trailing_text, step_cap, scalars.generator,
            dims=dims, max_seq=max_seq, cached_kv=cached_kv, cached_len=cached_len, prompt_pad=prompt_pad,
        )
    with signpost("tts.frames", rows=b) as span:
        try:
            while state.step < max_new_tokens:
                tts_generate_segment(
                    params, state, scalars, dims=dims, n_frames=min(SEGMENT_FRAMES, max_new_tokens - state.step),
                    top_k=top_k, cuda_graph=cuda_graph,
                )
                with signpost("tts.stop_check", frame=state.step):
                    all_done = bool(state.done.all())  # the loop's one host read, every SEGMENT_FRAMES frames
                if all_done:
                    break
        finally:
            tts_release(state)
        codes = state.codes[:, :max_new_tokens]
        n_frames = (codes[:, :, 0] != CODEC_EOS).sum(dim=1)
        length = int(_frames_until_done(codes[:, :state.step, 0], state.step_cap))
        # JAX's loop stops at the frame that leaves every row done; the frames
        # stepped after it within the segment wrote slots JAX leaves at zero
        for cache in state.kv:
            cache[:, :, :, state.bos_slot + 1 + length:] = 0
        span.attrs["frames"] = state.step
    return TTSLoopOutput(codes=codes, n_frames=n_frames, kv=state.kv, length=length, steps=state.step)


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
