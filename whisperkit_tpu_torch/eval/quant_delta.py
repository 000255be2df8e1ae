"""End-to-end quantization quality harness: WER delta + token divergence
vs the bf16 pipeline on the same weights and audio (port of
whisperkit_tpu/eval/quant_delta.py).

Reference: Tests/WhisperKitTests/RegressionTests.swift:293-296 — the
reference's correctness metric for a model variant is WER vs reference
transcripts. Without trained weights, the strongest offline statement is
DIVERGENCE FROM BF16: run the identical checkpoint through each
quantization scheme on the same audio and measure (a) text WER of the
quantized transcript against the bf16 transcript and (b) token-level edit
distance — both zero when a scheme is lossless at decode-decision level.

On the card, `quant_divergence` runs the port's whole pipeline once per
scheme (the kernels K1, K2 and K4, K3 for the int8 cross-KV schemes, K5
for `int8_self_kv`); `teacher_forced_divergence` runs the bf16 teacher
trajectory as T == 1 decoder steps (K4) and each scheme's full-sequence
pass (the prefill path: plain self-attention, K3 over an int8 cross-KV).
The scoring (argmax, margins, edit distance, WER) is numpy host code, as
in the JAX package.

Used by whisperkit_tpu_torch/tools/eval_quant_wer.py and chip_smoke.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from whisperkit_tpu_torch.core.device import DeviceLike, resolve_device
from whisperkit_tpu_torch.eval.wer import align_words, evaluate

# scheme name → (weight_bits or None, ComputeOptions overrides)
DEFAULT_SCHEMES: dict[str, tuple[Optional[int], dict]] = {
    # the blessed serving preset: int8 cross-KV, bf16 weights
    "serving_int8_cross_kv": (None, {"quantize_cross_kv": True}),
    "int8_self_kv": (None, {"quantize_self_kv": True}),
    "w8a16_int8kv": (8, {"quantize_cross_kv": True, "quantization": "w8a16"}),
    "w8a8_int8kv": (8, {"quantize_cross_kv": True, "quantization": "w8a8"}),
    "w4a16_int8kv": (4, {"quantize_cross_kv": True, "quantization": "w4a16"}),
}


@dataclasses.dataclass
class SchemeDelta:
    scheme: str
    wer_vs_bf16: float  # normalized-text WER, bf16 transcript as reference
    token_divergence: float  # token edit distance / bf16 token count
    n_ref_tokens: int
    n_diverged_tokens: int
    identical_text: bool


@dataclasses.dataclass
class TeacherForcedDelta:
    """Per-STEP decision stability, free of trajectory compounding.

    Free-running greedy divergence (SchemeDelta) saturates on random-init
    weights: logit margins are near zero, so the first flipped token
    decorrelates everything after it. Teacher forcing feeds every scheme
    the SAME bf16-greedy prefix at every position and asks only "would
    this scheme have picked the same next token?" — the per-step flip
    probability, plus the bf16 logit margins that contextualize it
    (a flip at margin 0.001 is noise; a flip at margin 5 is damage)."""

    scheme: str
    tf_agreement: float  # fraction of steps whose argmax matches bf16
    n_steps: int
    n_flips: int
    margin_bf16_median: float  # median top1-top2 bf16 logit gap, all steps
    flip_margin_median: Optional[float]  # median bf16 margin at flips (None if none)
    mean_abs_logit_delta: float  # mean |logits_scheme - logits_bf16|, eval rows


def _result_tokens(result) -> list[int]:
    out: list[int] = []
    for seg in result.segments:
        out.extend(int(t) for t in seg.tokens)
    return out


def _token_edit_distance(ref: list[int], hyp: list[int]) -> int:
    if not ref and not hyp:
        return 0
    chunks = align_words([str(t) for t in ref], [str(t) for t in hyp])
    dist = 0
    for c in chunks:
        if c.kind != "equal":
            dist += max(c.ref_end - c.ref_start, c.hyp_end - c.hyp_start)
    return dist


def _scheme_delta(name, base_texts, base_tokens, texts, tokens, normalizer=None) -> SchemeDelta:
    """One scheme's transcripts against the bf16 ones: WER over the pooled
    reference words and the token edit distance over the pooled tokens."""
    n_ref = sum(len(t) for t in base_tokens)
    dist = sum(_token_edit_distance(r, h) for r, h in zip(base_tokens, tokens))
    wers = [evaluate(r, h, normalizer=normalizer) for r, h in zip(base_texts, texts)]
    total_ref_words = sum(w.n_ref_words for w in wers) or 1
    wer = sum(w.substitutions + w.deletions + w.insertions for w in wers) / total_ref_words
    return SchemeDelta(
        scheme=name,
        wer_vs_bf16=round(wer, 5),
        token_divergence=round(dist / max(n_ref, 1), 5),
        n_ref_tokens=n_ref,
        n_diverged_tokens=dist,
        identical_text=texts == base_texts,
    )


def _tree_for(params, bits: Optional[int], cache: dict):
    """The tree of a scheme's weights: `params` itself, or its W8A16/W4A16
    form (quantized once per bit width, on the weights' device)."""
    if bits is None:
        return params
    if bits not in cache:
        from whisperkit_tpu_torch.ops.quant import quantize_whisper_params

        cache[bits] = quantize_whisper_params(params, bits=bits)
    return cache[bits]


def quant_divergence(
    dims,
    params,
    audio_list: Sequence[np.ndarray],
    options,
    schemes: Optional[dict] = None,
    normalizer=None,
    device: DeviceLike = "cuda",
) -> list[SchemeDelta]:
    """Transcribe `audio_list` with bf16 and with each scheme (same weight
    tree, quantized where the scheme says) on `device` and report
    per-scheme deltas.

    `options` should disable the fallback ladder when weights are
    random-init (tools/workload.pipeline_options does) so every scheme
    decodes one honest pass per window.
    """
    from whisperkit_tpu_torch.core.configurations import ComputeOptions, WhisperConfig
    from whisperkit_tpu_torch.models.whisper import _map
    from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline

    schemes = DEFAULT_SCHEMES if schemes is None else schemes
    dev = resolve_device(device)
    params = _map(lambda _, t: t.to(dev), params)

    def run(compute: ComputeOptions, p) -> tuple[list[str], list[list[int]]]:
        pipe = WhisperPipeline(WhisperConfig(compute_options=compute), dims=dims, params=p, device=dev)
        texts, tokens = [], []
        for audio in audio_list:
            res = pipe.transcribe(audio, options)
            texts.append(res.text)
            tokens.append(_result_tokens(res))
        pipe.params = None
        return texts, tokens

    base_texts, base_tokens = run(ComputeOptions(), params)
    quant_trees: dict[int, object] = {}
    reports: list[SchemeDelta] = []
    for name, (bits, overrides) in schemes.items():
        texts, tokens = run(ComputeOptions(**overrides), _tree_for(params, bits, quant_trees))
        reports.append(_scheme_delta(name, base_texts, base_tokens, texts, tokens, normalizer))
    return reports


@torch.inference_mode()
def _scheme_logits(dims, tree, mel: torch.Tensor, seq: Sequence[int], overrides: dict) -> np.ndarray:
    """Full-sequence teacher-forced decoder logits [T, V] f32 for one
    scheme's compute path (the same model functions the pipeline wires:
    act8 encoder for w8a8, int8 cross-KV, int8 self-KV cache layout), on
    the device of `mel` ([1, n_mels, 3000])."""
    from whisperkit_tpu_torch.models.whisper import (
        compute_cross_kv,
        compute_cross_kv_quantized,
        decoder_forward,
        encoder_forward,
        init_kv_cache,
    )

    act8 = overrides.get("quantization") == "w8a8"
    q8_cross = bool(overrides.get("quantize_cross_kv"))
    q8_self = bool(overrides.get("quantize_self_kv"))
    enc = encoder_forward(tree, mel, dims, act8=act8)
    cross_k, cross_v = (compute_cross_kv_quantized if q8_cross else compute_cross_kv)(tree, enc, dims)
    kv_k, kv_v = init_kv_cache(dims, 1, len(seq), tree["decoder"]["token_embed"].dtype, mel.device,
                               quantize=q8_self)
    tokens = torch.tensor([list(seq)], dtype=torch.long, device=mel.device)
    logits = decoder_forward(tree, tokens, 0, kv_k, kv_v, cross_k, cross_v, dims)
    return logits[0].float().cpu().numpy()


@torch.inference_mode()
def _teacher_trajectory(dims, params, mel: torch.Tensor, prompt: list[int], max_tokens: int, eot: int) -> list[int]:
    """The bf16 raw-greedy trajectory after `prompt`: one prefill, then
    T == 1 steps over a cache of n_text_ctx positions (the JAX harness's
    cache), stopping after EOT or `max_tokens` tokens."""
    from whisperkit_tpu_torch.models.whisper import (
        compute_cross_kv,
        decoder_forward,
        encoder_forward,
        init_kv_cache,
    )

    dev = mel.device
    cross_k, cross_v = compute_cross_kv(params, encoder_forward(params, mel, dims), dims)
    kv_k, kv_v = init_kv_cache(dims, 1, dims.n_text_ctx, params["decoder"]["token_embed"].dtype, dev)
    logits = decoder_forward(params, torch.tensor([prompt], dtype=torch.long, device=dev), 0, kv_k, kv_v,
                             cross_k, cross_v, dims)
    teacher: list[int] = []
    nxt = int(logits[0, -1].argmax())
    for pos in range(len(prompt), len(prompt) + max_tokens):
        teacher.append(nxt)
        if nxt == eot:
            break
        logits = decoder_forward(params, torch.tensor([[nxt]], dtype=torch.long, device=dev), pos, kv_k, kv_v,
                                 cross_k, cross_v, dims)
        nxt = int(logits[0, -1].argmax())
    return teacher


def teacher_forced_divergence(
    dims,
    params,
    audio: np.ndarray,
    language: str = "en",
    schemes: Optional[dict] = None,
    max_tokens: int = 96,
    device: DeviceLike = "cuda",
) -> list[TeacherForcedDelta]:
    """Per-step argmax agreement of each scheme vs bf16 under teacher
    forcing (see TeacherForcedDelta), on `device`. The teacher sequence is
    the bf16 raw-greedy trajectory on the first 30 s window (no logit
    filters — this probes the model numerics, not the decode rules); every
    scheme then scores the identical [prompt + teacher] sequence in ONE
    full-sequence decoder pass, so flips cannot compound.

    Reference metric analog: RegressionTests.swift:293-296 measures WER on
    real weights; offline, per-step flip rate + margins is the sharpest
    scheme-quality statement random-init weights admit."""
    from whisperkit_tpu_torch.audio.io import pad_or_trim
    from whisperkit_tpu_torch.models.whisper import _map
    from whisperkit_tpu_torch.ops.mel import log_mel_spectrogram
    from whisperkit_tpu_torch.text.tokenizer import special_tokens_for_vocab

    schemes = DEFAULT_SCHEMES if schemes is None else schemes
    dev = resolve_device(device)
    params = _map(lambda _, t: t.to(dev), params)
    sp = special_tokens_for_vocab(dims.n_vocab)
    window = torch.from_numpy(pad_or_trim(np.asarray(audio, np.float32))).to(dev)
    mel = log_mel_spectrogram(window, n_mels=dims.n_mels)[None]

    prompt = [sp.sot, sp.language_token(language), sp.transcribe, sp.notimestamps]
    seq = prompt + _teacher_trajectory(dims, params, mel, prompt, max_tokens, sp.eot)
    eval_lo = len(prompt) - 1  # row i predicts seq[i+1]
    base = _scheme_logits(dims, params, mel, seq, {})
    rows = base[eval_lo:-1] if len(seq) > eval_lo + 1 else base[eval_lo:eval_lo + 1]
    base_arg = rows.argmax(axis=-1)
    part = np.partition(rows, -2, axis=-1)
    margins = part[:, -1] - part[:, -2]

    quant_trees: dict[int, object] = {}
    reports: list[TeacherForcedDelta] = []
    for name, (bits, overrides) in schemes.items():
        ql = _scheme_logits(dims, _tree_for(params, bits, quant_trees), mel, seq, overrides)
        qrows = ql[eval_lo:-1] if len(seq) > eval_lo + 1 else ql[eval_lo:eval_lo + 1]
        flips = qrows.argmax(axis=-1) != base_arg
        n = len(base_arg)
        reports.append(
            TeacherForcedDelta(
                scheme=name,
                tf_agreement=round(float(1.0 - flips.mean()), 5),
                n_steps=n,
                n_flips=int(flips.sum()),
                margin_bf16_median=round(float(np.median(margins)), 5),
                flip_margin_median=(
                    round(float(np.median(margins[flips])), 5) if flips.any() else None
                ),
                mean_abs_logit_delta=round(float(np.abs(qrows - rows).mean()), 5),
            )
        )
    return reports
