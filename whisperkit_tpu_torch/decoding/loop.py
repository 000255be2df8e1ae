"""The Whisper decode loop (port of whisperkit_tpu/decoding/loop.py).

The JAX package runs the whole token loop as one `lax.while_loop` on the
device. Here one position is one call of `_step`, which touches tensors
only: the position lives on the device (a 0-d int64 tensor, as JAX's
traced `pos`), and the step writes the tokens, log-probabilities, `done`
mask, mask row, caches and alignment row at it, in place. On CUDA the
first step runs eagerly and is then captured as a CUDA graph
(`decoding/graph.py`), which every later position replays: one launch
from the host instead of a few thousand. Under tensor parallelism each
rank captures and replays its own graph: the step's all-reduces are
device kernels (parallel/group.py) that meet the peers' in device memory,
and every rank's logits are the same bits, so the ranks decide alike. On
the CPU and with `cuda_graph=False` the same `_step` runs eagerly. The
host counts positions, draws the sampler's noise into a buffer before
each step, and reads `done` only every `stop_check_interval` steps to stop
early once every row has finished (under tp it then checks that the
group's device collectives did not fail). Stopping late is exact,
because a finished row keeps emitting EOT with log-probability 0, which is
what the EOT-filled token buffer already holds; the step keeps on the
device the position after the step that left every row done, which is
where JAX's loop stops, and the loops return it as `length`.

Batching: every function is batched over B windows, with a per-row `done`
mask for heterogeneous finish times.

`decode_loop_segmented` polls the host every `segment_tokens` positions:
for cancellation (`should_stop`) and, with `compact`, to gather the rows
still decoding into a smaller batch. With `alignment_heads`, every step
also writes the cross-attention probabilities of those heads into an
alignment buffer (word timestamps); `alignment_forward` computes the same
in one teacher-forced pass (beam search).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Union

import torch

from whisperkit_tpu_torch.text.tokenizer import SpecialTokens
from whisperkit_tpu_torch.core.signposts import signpost
from whisperkit_tpu_torch.decoding.filters import apply_suppress_blank, apply_timestamp_rules
from whisperkit_tpu_torch.decoding.graph import StepGraph
from whisperkit_tpu_torch.decoding.sampler import sample_token
from whisperkit_tpu_torch.parallel.mesh import RowDraws, gumbel_from_uniform, uniform
from whisperkit_tpu_torch.models.whisper import (
    WhisperDims,
    check_group,
    compute_cross_kv,
    compute_cross_kv_quantized,
    decoder_forward,
    encoder_forward,
    gather_alignment,
    init_kv_cache,
    local_heads,
    rank_captured,
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


# (layer, head) pairs of the cross-attention heads whose probabilities
# word timestamps read
AlignmentHeads = Optional[Sequence[Sequence[int]]]


class DecodeLoopOutput(NamedTuple):
    tokens: torch.Tensor  # [B, TOTAL] (prompt + sampled, EOT-padded)
    token_logprobs: torch.Tensor  # [B, TOTAL] f32 (0 in the prompt region)
    length: int  # final write position: after the step that left every row done, else where the loop stopped
    no_speech_prob: torch.Tensor  # [B] f32
    alignment: Optional[torch.Tensor] = None  # [TOTAL, B, A, 1500] f32, with alignment heads


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
    align_prefix: Optional[torch.Tensor] = None  # [P, B, A, 1500] f32, with alignment heads


def _codes(x) -> torch.Tensor:
    """A raw tensor, or the codes of an int8 {"q8", "scale"} form."""
    return x["q8"] if isinstance(x, dict) else x


def _batch(cross) -> int:
    return _codes(cross).shape[1]


def _alignment_buffer(rows: int, b: int, alignment_heads, cross_k) -> torch.Tensor:
    """Zeros [rows, B, A, frames] f32 on the cross-KV's device."""
    codes = _codes(cross_k)
    return torch.zeros((rows, b, len(alignment_heads), codes.shape[3]), dtype=torch.float32, device=codes.device)


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
    alignment_heads: AlignmentHeads = None,
    quantize_self_kv: bool = False,
) -> PrefillState:
    """Run the prompt through the decoder once; see PrefillState.

    `quantize_self_kv=True` allocates the self-attention cache in the int8
    per-token-scale form: rows are quantized as they are written, and the
    decode step reads them through K5 (half the bytes of the bf16 cache).
    The cache's form is fixed here; the decode loop uses whichever it gets.
    With `alignment_heads`, the prompt rows' alignment is captured too
    (`align_prefix`)."""
    b, p = prompt.shape
    if p != sample_begin:
        raise ValueError(f"prompt length {p} != sample_begin {sample_begin}")
    total = sample_begin + max_new_tokens
    dtype = params["decoder"]["token_embed"].dtype
    kv_k, kv_v = init_kv_cache(dims, b, total, dtype, prompt.device, quantize=quantize_self_kv,
                               n_head=local_heads(params, dims.n_text_head))
    align = None if alignment_heads is None else _alignment_buffer(p, b, alignment_heads, cross_k)
    logits = decoder_forward(
        params, prompt, 0, kv_k, kv_v, cross_k, cross_v, dims,
        alignment_heads=alignment_heads, align_out=align,
    )
    no_speech_prob = torch.softmax(logits[:, sot_index], dim=-1)[:, special.nospeech]
    return PrefillState(kv_k, kv_v, logits[:, -1], no_speech_prob, align)


def _graphs_on(device: torch.device) -> bool:
    """Whether decode steps on `device` run as CUDA graphs: on a card."""
    return device.type == "cuda"


@dataclasses.dataclass
class _Decode:
    """One decode's state between host checkpoints: the loop's inputs that
    stay fixed, and the buffers and caches that the steps advance."""

    params: dict
    cross_k: object
    cross_v: object
    suppress_bias: torch.Tensor
    scalars: DecodeScalars
    dims: WhisperDims
    special: SpecialTokens
    sample_begin: int
    total: int
    top_k: int
    use_timestamp_rules: bool
    suppress_blank: bool
    alignment_heads: AlignmentHeads
    kv_k: KVCache
    kv_v: KVCache
    tokens: torch.Tensor  # [B, TOTAL]
    token_logprobs: torch.Tensor  # [B, TOTAL]
    done: torch.Tensor  # [B] bool
    last_logits: torch.Tensor  # [B, V], written in place
    mask_row: torch.Tensor  # [1, TOTAL] additive mask of the T==1 step
    align: Optional[torch.Tensor]  # [TOTAL, B, A, 1500] with alignment heads
    pos: int  # next write position, as the host counts it
    pos_dev: torch.Tensor  # the same, 0-d int64 on the device: what the step reads
    length: torch.Tensor  # 0-d int64: the position after the step that left every row done, else TOTAL
    noise_u: Optional[torch.Tensor]  # [B, top_k] uniform draws for the step, temperature > 0
    align_stage: Optional[torch.Tensor]  # [1, B, A, 1500]: the step's alignment row
    use_graph: bool  # replay a CUDA graph of the step
    graph: Optional[StepGraph] = None  # the step's graph, once captured


def _start(
    params, cross_k, cross_v, prompt, suppress_bias, scalars, prefill: Optional[PrefillState], *,
    dims, special, sample_begin, max_new_tokens, top_k, sot_index, use_timestamp_rules, suppress_blank,
    alignment_heads, quantize_self_kv, cuda_graph,
) -> tuple[_Decode, PrefillState]:
    """The decode's state after the prompt: `prefill`'s, or a new prefill's."""
    if prefill is None:
        prefill = prefill_window(
            params, cross_k, cross_v, prompt,
            dims=dims, special=special, sample_begin=sample_begin,
            max_new_tokens=max_new_tokens, sot_index=sot_index,
            alignment_heads=alignment_heads, quantize_self_kv=quantize_self_kv,
        )
    b, p = prompt.shape
    total = sample_begin + max_new_tokens
    dev = prompt.device
    tokens = torch.full((b, total), special.eot, dtype=torch.long, device=dev)
    tokens[:, :p] = prompt
    align = None
    if alignment_heads is not None:
        if prefill.align_prefix is None:
            raise ValueError("alignment_heads given, but the prefill did not capture the alignment")
        align = _alignment_buffer(total, b, alignment_heads, cross_k)
        align[:p] = prefill.align_prefix
    # additive causal mask row of the T==1 step, opened one position per step
    mask_row = torch.full((1, _codes(prefill.kv_k).shape[3]), float("-inf"), dtype=torch.float32, device=dev)
    mask_row[:, :sample_begin] = 0.0
    noise_u = None
    if scalars.temperature > 0:
        noise_u = torch.zeros((b, top_k), dtype=torch.float32, device=dev)
    use_graph = cuda_graph and _graphs_on(dev)
    st = _Decode(
        params, cross_k, cross_v, suppress_bias, scalars, dims, special, sample_begin, total, top_k,
        use_timestamp_rules, suppress_blank, alignment_heads, prefill.kv_k, prefill.kv_v, tokens,
        torch.zeros((b, total), dtype=torch.float32, device=dev), torch.zeros((b,), dtype=torch.bool, device=dev),
        # a copy: the step writes it in place, and the prefill serves every rung
        prefill.last_logits.clone(), mask_row, align, sample_begin,
        torch.tensor(sample_begin, dtype=torch.long, device=dev), torch.tensor(total, dtype=torch.long, device=dev),
        noise_u,
        None if align is None else torch.zeros_like(align[:1]), use_graph,
    )
    return st, prefill


def _step(st: _Decode, forward: bool) -> None:
    """Decode the position `st.pos_dev` points at, on tensors only (what a
    CUDA graph captures): filter the last logits, sample (with the noise
    in `st.noise_u`), apply the stop checks, write the token, its
    log-probability and `done` at the position; with `forward`, open the
    mask row there and run the decoder on the token (its logits into
    `st.last_logits`, its alignment row into `st.align`); then advance the
    position. No host value depends on the position."""
    sp = st.special
    pos = st.pos_dev
    at = pos.view(1)
    logits = st.last_logits + st.suppress_bias[None, :]
    if st.suppress_blank:
        logits = apply_suppress_blank(logits, sp, pos == st.sample_begin)
    if st.use_timestamp_rules:
        logits = apply_timestamp_rules(
            logits, st.tokens, pos, st.sample_begin, sp, st.scalars.max_initial_timestamp_index,
        )
    noise = None if st.noise_u is None else gumbel_from_uniform(st.noise_u)
    token, logprob = sample_token(logits, st.scalars.temperature, top_k=st.top_k, noise=noise)

    # stop checks: EOT, the context cap (loop bound), first-token floor
    stop = st.done
    first_threshold = st.scalars.first_token_logprob_threshold
    if first_threshold != float("-inf"):
        stop = stop | ((pos == st.sample_begin) & (logprob < first_threshold))
    token = torch.where(stop, sp.eot, token)
    logprob = torch.where(stop, 0.0, logprob)
    st.tokens.index_copy_(1, at, token[:, None])
    st.token_logprobs.index_copy_(1, at, logprob[:, None])
    st.done.copy_(stop | (token == sp.eot))
    st.length.copy_(torch.where(st.done.all(), torch.minimum(st.length, pos + 1), st.length))

    if forward:
        st.mask_row.index_fill_(1, at, 0.0)
        capture = {}
        if st.align is not None:
            capture = {"alignment_heads": st.alignment_heads, "align_out": st.align_stage}
        logits = decoder_forward(
            st.params, token[:, None], pos, st.kv_k, st.kv_v, st.cross_k, st.cross_v, st.dims,
            mask_row=st.mask_row, **capture,
        )
        st.last_logits.copy_(logits[:, -1])
        if st.align is not None:
            st.align.index_copy_(0, at, st.align_stage)
    pos.add_(1)


def _advance(st: _Decode, end: int, stop_check_interval: int) -> None:
    """Decode positions st.pos .. end - 1, or stop sooner once the host,
    which reads the `done` mask every `stop_check_interval` positions,
    sees every row done. The step at the last position runs only to
    capture its alignment: its logits are never read, and without an
    alignment buffer it runs no decoder (eagerly: the graph holds the
    decoder). With `st.use_graph`, the first step with a decoder runs
    eagerly and is captured, and every later one replays the capture."""
    while st.pos < end:
        if st.pos > st.sample_begin and (st.pos - st.sample_begin) % stop_check_interval == 0:
            with signpost("decode.stop_check", position=st.pos):
                all_done = bool(st.done.all())  # the loop's one host sync, every K steps
            check_group(st.params)
            if all_done:
                return
        if st.noise_u is not None:  # the step's noise, in the eager sampler's draw order
            st.noise_u.copy_(uniform(st.scalars.generator, st.noise_u.shape, st.noise_u.device))
        forward = st.pos + 1 < st.total or st.align is not None
        if not (st.use_graph and forward):
            _step(st, forward)
        elif st.graph is None:
            st.graph = StepGraph(lambda: _step(st, True), st.tokens.device)  # runs this position, then captures
            rank_captured(st.params)
        else:
            st.graph.replay()
        st.pos += 1


def _length(st: _Decode) -> int:
    """JAX's `length`: the position after the step that left every row
    done, or where the loop stopped (the budget, a cancellation)."""
    length = min(st.pos, int(st.length))
    check_group(st.params)
    return length


def _release(st: _Decode) -> None:
    """Free the step's graph and its memory pool."""
    if st.graph is not None:
        st.graph.close()
        st.graph = None


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
    alignment_heads: AlignmentHeads = None,
    prefill: Optional[PrefillState] = None,
    stop_check_interval: int = 16,
    quantize_self_kv: bool = False,
    cuda_graph: bool = True,
) -> DecodeLoopOutput:
    """Greedy (temperature 0) or top-k sampled decode of up to
    `max_new_tokens` tokens per row after the prompt. `quantize_self_kv`
    selects the int8 self-KV cache when there is no `prefill` to reuse.
    With `alignment_heads`, the output carries each position's alignment
    (a `prefill` must then have captured it too). On CUDA the steps replay
    a CUDA graph of one step; `cuda_graph=False` runs them eagerly, for
    comparison only."""
    st, prefill = _start(
        params, cross_k, cross_v, prompt, suppress_bias, scalars, prefill,
        dims=dims, special=special, sample_begin=sample_begin, max_new_tokens=max_new_tokens,
        top_k=top_k, sot_index=sot_index, use_timestamp_rules=use_timestamp_rules,
        suppress_blank=suppress_blank, alignment_heads=alignment_heads, quantize_self_kv=quantize_self_kv,
        cuda_graph=cuda_graph,
    )
    _advance(st, st.total, stop_check_interval)
    _release(st)
    return DecodeLoopOutput(
        st.tokens, st.token_logprobs, _length(st), prefill.no_speech_prob, gather_alignment(params, st.align),
    )


def _take_rows(x, index: torch.Tensor, dim: int):
    """Rows `index` of axis `dim` of a tensor or of each part of an int8
    {"q8", "scale"} form."""
    if isinstance(x, dict):
        return {k: v.index_select(dim, index) for k, v in x.items()}
    return x.index_select(dim, index)


def _compact(st: _Decode, rows: list[int], n_active: int) -> None:
    """Gather the decode's batch down to `rows` (current row indices; the
    first `n_active` still decoding, the rest repeats of the first, marked
    done): the caches, the cross-KV, the buffers, the alignment, and a mesh
    shard's view of its group's draws, so each kept row goes on sampling
    with its own noise. The kernels then run on the smaller, contiguous
    batch."""
    _release(st)  # the graph froze the old batch's tensors: the next step captures anew
    index = torch.tensor(rows, dtype=torch.long, device=st.tokens.device)
    if isinstance(st.scalars.generator, RowDraws):
        st.scalars = st.scalars._replace(generator=st.scalars.generator.take(rows))
    st.tokens = st.tokens.index_select(0, index)
    st.token_logprobs = st.token_logprobs.index_select(0, index)
    st.last_logits = st.last_logits.index_select(0, index)
    st.done = st.done.index_select(0, index)
    st.done[n_active:] = True
    st.kv_k, st.kv_v = _take_rows(st.kv_k, index, 1), _take_rows(st.kv_v, index, 1)
    st.cross_k, st.cross_v = _take_rows(st.cross_k, index, 1), _take_rows(st.cross_v, index, 1)
    if st.align is not None:
        st.align = st.align.index_select(1, index)
        st.align_stage = st.align_stage.index_select(1, index)
    if st.noise_u is not None:
        st.noise_u = st.noise_u.index_select(0, index)


class _Banked(NamedTuple):
    """Per original row, the final buffers of rows compacted out so far."""

    tokens: torch.Tensor  # [B0, TOTAL]
    token_logprobs: torch.Tensor
    align: Optional[torch.Tensor]  # [TOTAL, B0, A, 1500]


def _bank(banked: Optional[_Banked], st: _Decode, pairs: list[tuple[int, int]], b0: int) -> _Banked:
    """Copy the buffers of current rows to their original rows; `pairs` =
    [(current row, original row)]."""
    if banked is None:
        align = None if st.align is None else st.align.new_zeros((st.align.shape[0], b0, *st.align.shape[2:]))
        banked = _Banked(st.tokens.new_empty((b0, st.total)), st.token_logprobs.new_empty((b0, st.total)), align)
    if pairs:
        dev = st.tokens.device
        cur = torch.tensor([c for c, _ in pairs], dtype=torch.long, device=dev)
        orig = torch.tensor([o for _, o in pairs], dtype=torch.long, device=dev)
        banked.tokens.index_copy_(0, orig, st.tokens.index_select(0, cur))
        banked.token_logprobs.index_copy_(0, orig, st.token_logprobs.index_select(0, cur))
        if banked.align is not None:
            banked.align.index_copy_(1, orig, st.align.index_select(1, cur))
    return banked


@torch.inference_mode()
def decode_loop_segmented(
    params,
    cross_k,
    cross_v,
    prompt: torch.Tensor,
    suppress_bias: torch.Tensor,
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
    alignment_heads: AlignmentHeads = None,
    prefill: Optional[PrefillState] = None,
    segment_tokens: int = 32,
    should_stop: Optional[Callable[[], bool]] = None,
    compact: bool = False,
    quantize_self_kv: bool = False,
    stop_check_interval: int = 16,
    cuda_graph: bool = True,
) -> DecodeLoopOutput:
    """decode_loop with host checkpoints every `segment_tokens` positions
    (the JAX `decode_loop_segmented`).

    Between segments the host reads the `done` mask, stops once every row
    is done, and polls `should_stop` (mid-window cancellation: the
    reference's EarlyStopActor, Models.swift:643-728, at segment
    granularity); cancelled rows keep the tokens decoded so far, the rest
    of the buffer EOT. With `compact=True`, whenever the rows still
    decoding fit in half the batch (and two or more segments remain), the
    decode is gathered down to the next power of two of them
    (`_compact`), the finished rows' buffers banked at their original
    rows, so finished rows stop costing the steps their attention. On CUDA
    the steps replay a CUDA graph, captured anew after each compaction
    (`cuda_graph=False`: eager, for comparison only)."""
    st, prefill = _start(
        params, cross_k, cross_v, prompt, suppress_bias, scalars, prefill,
        dims=dims, special=special, sample_begin=sample_begin, max_new_tokens=max_new_tokens,
        top_k=top_k, sot_index=sot_index, use_timestamp_rules=use_timestamp_rules,
        suppress_blank=suppress_blank, alignment_heads=alignment_heads, quantize_self_kv=quantize_self_kv,
        cuda_graph=cuda_graph,
    )
    b0 = prompt.shape[0]
    rows: list[Optional[int]] = list(range(b0))  # original row of each current row; None: a pad
    banked: Optional[_Banked] = None
    n_segments = -(-max_new_tokens // segment_tokens)
    for seg in range(n_segments):
        _advance(st, min(st.pos + segment_tokens, st.total), stop_check_interval)
        with signpost("decode.stop_check", position=st.pos):
            done = st.done.tolist()
        check_group(st.params)
        if all(done):
            break
        if should_stop is not None and should_stop():
            break
        if not compact or seg >= n_segments - 2:
            continue
        active = [i for i, r in enumerate(rows) if r is not None and not done[i]]
        b_new = 1 << (len(active) - 1).bit_length()
        if b_new > len(rows) // 2:
            continue
        banked = _bank(banked, st, [(i, r) for i, r in enumerate(rows) if r is not None and done[i]], b0)
        _compact(st, active + [active[0]] * (b_new - len(active)), len(active))
        rows = [rows[i] for i in active] + [None] * (b_new - len(active))
    _release(st)

    if banked is None:  # never compacted
        return DecodeLoopOutput(
            st.tokens, st.token_logprobs, _length(st), prefill.no_speech_prob, gather_alignment(params, st.align),
        )
    banked = _bank(banked, st, [(i, r) for i, r in enumerate(rows) if r is not None], b0)
    return DecodeLoopOutput(
        banked.tokens, banked.token_logprobs, _length(st), prefill.no_speech_prob,
        gather_alignment(params, banked.align),
    )


@torch.inference_mode()
def alignment_forward(
    params, cross_k, cross_v, tokens: torch.Tensor, *, dims: WhisperDims, alignment_heads,
) -> torch.Tensor:
    """One teacher-forced pass over whole sequences `tokens` [B, T]
    (prompt + sampled) capturing the alignment heads → [T, B, A, 1500]
    f32: for decodes whose loop did not capture it (beam search), as
    openai/whisper timing.py does. Its cache is raw in the weights' dtype."""
    b, t = tokens.shape
    kv_k, kv_v = init_kv_cache(dims, b, t, params["decoder"]["token_embed"].dtype, tokens.device,
                               n_head=local_heads(params, dims.n_text_head))
    align = _alignment_buffer(t, b, alignment_heads, cross_k)
    decoder_forward(
        params, tokens, 0, kv_k, kv_v, cross_k, cross_v, dims,
        alignment_heads=alignment_heads, align_out=align,
    )
    return gather_alignment(params, align)


@torch.inference_mode()
def detect_language_logits(
    params, cross_k, cross_v, *, dims: WhisperDims, special: SpecialTokens
) -> torch.Tensor:
    """One decode step from SOT → language probabilities [B, n_languages].
    Its tiny cache is always raw, whatever the serving mode (as in JAX)."""
    b = _batch(cross_k)
    dev = _codes(cross_k).device
    dtype = params["decoder"]["token_embed"].dtype
    kv_k, kv_v = init_kv_cache(dims, b, 8, dtype, dev, n_head=local_heads(params, dims.n_text_head))
    prompt = torch.full((b, 1), special.sot, dtype=torch.long, device=dev)
    logits = decoder_forward(params, prompt, 0, kv_k, kv_v, cross_k, cross_v, dims)
    lang = logits[:, 0, special.language_begin : special.language_begin + special.n_languages]
    return torch.softmax(lang, dim=-1)
