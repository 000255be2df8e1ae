"""The system under test for a Qwen3-TTS configuration: the port's
`TTSPipeline` over the benchmark's weights.

The benchmark makes the weight tree on the device from the seed
(`references.qwen3_tts.init_weights`, the port's `init_tts_params` layout:
the talker and the code predictor bf16, the vocoder in the configuration's
`serving.vocoder` format) and hands it over; the port's own quantizer makes
the stated weight format (`ops/quant.quantize_tts_params`, min_size 1: every
block linear, the code0 head and the 15 heads). The tokenizer is the one the
pipeline builds without a download (`ByteFallbackTokenizer`).

A paragraph's answer (`Answer`) is the pipeline's crossfaded audio, with
what the check needs to judge it, recorded by `instrument`'s wrapper of the
frame loop as the loop runs: the served codes of every row, each row's
frames, and the uniform draws the loop took for the sampler's noise, frame
by frame (the port's `SharedDraws` view of the rows, recorded as it hands
each draw out: the numbers the frame read, not a redraw).

Besides `System`, what the harness and its tools take from a system module:
`instrument(spans)`, the benchmark's spans around the frame loop and the
vocoder; `counters()`, the port's counters read around a window; `LOWER`,
the control's weight format for each stated one; `FAULTS`, the faults the
control script can plant.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from benchmark.references.qwen3_tts import Dims, init_weights
from benchmark.spans import Call

WEIGHT_BITS = {"w8a16": 8, "w4a16": 4}
LOWER = {"w8a16": "w4a16"}  # the next weight format below the stated one

# each frame-loop call of the answer in flight: (the loop's output, its
# draws, the prompt positions it prefilled, the prompt's positions with the
# cached prefix)
_loops: list = []


@dataclasses.dataclass
class LoopCall(Call):
    positions: int = 0  # the prompt positions the call prefilled


@dataclasses.dataclass
class Answer:
    """One paragraph's answer: the audio the caller gets, and what the
    frame loop served on the way."""

    audio: np.ndarray  # the crossfaded waveform, 24 kHz
    codes: object  # [rows, max_new_tokens, 16] int32 on the device, EOS after each row's frames
    n_frames: object  # [rows] frames of each row, on the device
    draws: list  # per frame stepped, the [rows, top_k + 15 x 5] uniform draws on the device
    timings: object  # the port's SpeechTimings
    prefilled: int  # prompt positions the loop prefilled (the rest came from the prompt cache)
    prompt_len: int  # the prompt's positions
    steps: int  # frames the loop ran (the port's `TTSLoopOutput.steps`; 0 where the port has no such count)
    t0: float  # the paragraph's start and end on the host's `perf_counter` clock
    t1: float


def port_dims(dims: Dims):
    """The port's `Qwen3TTSDims` of the reference's dims."""
    from whisperkit_tpu_torch.models import qwen3_tts as model

    fixed = {"codec_vocab": model.CODEC_VOCAB, "codebook": model.HEAD_VOCAB, "groups": 16}
    if any(getattr(dims, k) != v for k, v in fixed.items()) or {dims.talker.eps, dims.predictor.eps} != {1e-6}:
        raise ValueError(f"the port's Qwen3-TTS takes {fixed} and norms at 1e-6")
    t, c, v = dims.talker, dims.predictor, dims.vocoder
    out = model.Qwen3TTSDims(
        text_vocab=dims.text_vocab, d_model=dims.d_model, n_layer=t.layers, n_head=t.heads,
        n_kv_head=t.kv_heads, head_dim=t.head_dim, d_ff=t.ffn, rope_theta=t.rope_theta,
        text_pad=dims.text_pad, text_bos=dims.text_bos, cp_layer=c.layers, cp_head=c.heads,
        cp_kv_head=c.kv_heads, cp_head_dim=c.head_dim, cp_ff=c.ffn, cp_rope_theta=c.rope_theta,
        c2w=model.Code2WavDims(
            d_model=dims.vocoder_dim, n_layer=v.layers, n_head=v.heads, n_kv_head=v.kv_heads, d_ff=v.ffn,
            sliding_window=dims.window, rope_theta=v.rope_theta, rms_eps=v.eps,
            layer_scale_init=dims.layer_scale, codebook=dims.codebook, n_quantizers=dims.groups,
            upsampling_ratios=dims.upsampling, upsample_rates=dims.rates, decoder_dim=dims.decoder_dim),
    )
    if out.c2w.head_dim != v.head_dim:
        raise ValueError("the port's vocoder takes a head size of hidden / heads")
    return out


class System:
    def __init__(self, config: dict, seed: int, device: str = "cuda"):
        import torch

        from whisperkit_tpu_torch.decoding.tts_loop import HEAD_TOP_K
        from whisperkit_tpu_torch.ops.quant import quantize_tts_params
        from whisperkit_tpu_torch.pipelines.tts import TTSPipeline

        dims = Dims.of(config["model"])
        self.dims = port_dims(dims)
        if config["model"]["code_predictor"].get("head_top_k", HEAD_TOP_K) != HEAD_TOP_K:
            raise ValueError(f"the port's code predictor samples its heads from their top {HEAD_TOP_K}")
        serving = config["serving"]
        if serving["activations"] != "bfloat16" or serving["kv_cache"] != "bfloat16":
            raise ValueError("the port's TTS frame runs in bf16 activations and a bf16 cache")
        vocoder = {"float32": torch.float32, "bfloat16": torch.bfloat16}[serving["vocoder"]]
        tree = init_weights(dims, seed, device, torch.bfloat16, vocoder)
        if serving["weights"] != "bfloat16":
            # min_size 1: the configuration states every block linear and head in the format
            tree = quantize_tts_params(tree, min_size=1, bits=WEIGHT_BITS[serving["weights"]])
        self.pipeline = TTSPipeline(self.dims, params=tree, device=device)
        self.device = torch.device(device)

    def options(self, traffic: dict, seed: int = 0):
        """The generation options of `traffic` (the port's GenerationOptions)."""
        from whisperkit_tpu_torch.pipelines.tts import GenerationOptions

        o = traffic["options"]
        return GenerationOptions(
            voice=o["voice"], language=o["language"], temperature=o["temperature"], top_k=o["top_k"],
            repetition_penalty=o["repetition_penalty"], max_new_tokens=o["max_new_tokens"], seed=seed,
            chunking_strategy="sentence", target_chunk_size=o["target_chunk_size"],
            min_chunk_size=o["min_chunk_size"], crossfade_seconds=o["crossfade_seconds"],
            use_prompt_cache=o["prompt_cache"],
        )

    def build_prompt_cache(self, options) -> None:
        self.pipeline.build_prompt_cache(options)

    def synthesize(self, text: str, options) -> Answer:
        """The pipeline's `generate` of `text`, and what its frame loop served."""
        del _loops[:]
        t0 = time.perf_counter()
        result = self.pipeline.generate(text, options)
        t1 = time.perf_counter()
        if len(_loops) != 1:
            raise RuntimeError(f"a paragraph ran {len(_loops)} frame loops, not one (a mesh of one device)")
        (out, draws, prefilled, prompt_len), = _loops
        del _loops[:]
        rows = result.timings.chunks
        return Answer(result.audio, out.codes[:rows], out.n_frames[:rows], draws, result.timings, prefilled,
                      prompt_len, int(getattr(out, "steps", 0)), t0, t1)

    def close(self) -> None:
        """Drop the pipeline and its weights."""
        import torch

        self.pipeline = None
        del _loops[:]
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def _recording(view):
    """A RowDraws view over the same draws that keeps each draw it hands out."""
    from whisperkit_tpu_torch.parallel.mesh import RowDraws

    class Recording(RowDraws):
        def __init__(self):
            super().__init__(view.shared, view.index)
            self.drawn = []

        def rand(self, shape, device):
            u = super().rand(shape, device)
            self.drawn.append(u)
            return u

    return Recording()


def instrument(spans):
    """Wrap the two calls that `TTSPipeline.generate` makes for a paragraph
    (`tts_generate_loop`, the prefill and every frame, and
    `speech_decoder_forward`, the vocoder, as `pipelines/tts.py` names them)
    so that `spans` records them: a loop call's rows, frames stepped (the
    port's `TTSLoopOutput.steps`, 0 where the port has no such count) and
    prompt positions, a vocoder call's rows and frames. The loop call opens
    and closes a requested trace slice, and records its output and its draws
    for the answer. Two clock reads a call. Returns the undo."""
    from whisperkit_tpu_torch.parallel.mesh import RowDraws
    from whisperkit_tpu_torch.pipelines import tts as pipeline

    loop, vocode = pipeline.tts_generate_loop, pipeline.speech_decoder_forward

    def tts_generate_loop(params, prompt_embeds, scalars, **kwargs):
        spans.maybe_trace()
        rec = _recording(scalars.generator) if isinstance(scalars.generator, RowDraws) else None
        if rec is not None:
            scalars = scalars._replace(generator=rec)
        t0 = time.perf_counter()
        out = loop(params, prompt_embeds, scalars, **kwargs)
        spans.calls.append(LoopCall("frames", t0, time.perf_counter(), int(prompt_embeds.shape[0]),
                                    int(getattr(out, "steps", 0)), int(prompt_embeds.shape[1])))
        p = int(prompt_embeds.shape[1])
        _loops.append((out, [] if rec is None else rec.drawn, p, kwargs.get("cached_len", 0) + p))
        return out

    def speech_decoder_forward(params, codes, dims):
        t0 = time.perf_counter()
        out = vocode(params, codes, dims)
        spans.record("vocode", t0, int(codes.shape[0]), int(codes.shape[1]))
        return out

    pipeline.tts_generate_loop, pipeline.speech_decoder_forward = tts_generate_loop, speech_decoder_forward

    def undo():
        pipeline.tts_generate_loop, pipeline.speech_decoder_forward = loop, vocode

    return undo


def counters() -> dict:
    """The frame graphs' captures, replays and capture seconds, summed over
    the devices (the port's `decoding/graph.stats_by_device`)."""
    from whisperkit_tpu_torch.decoding import graph

    out = dict.fromkeys(graph.STATS, 0.0)
    for per in graph.stats_by_device.values():
        for key in graph.STATS:
            out[key] += per.get(key, 0)
    return out


def rows_mixed():
    """The batch's fault: each row is vocoded from the next row's codes.
    Returns the undo."""
    from whisperkit_tpu_torch.pipelines import tts as pipeline

    vocode = pipeline.speech_decoder_forward

    def mixed(params, codes, dims):
        return vocode(params, codes.roll(-1, 0), dims)

    pipeline.speech_decoder_forward = mixed
    return lambda: setattr(pipeline, "speech_decoder_forward", vocode)


def vocoder_tf32():
    """The vocoder one precision below its stated IEEE float32: its
    convolutions and products in TF32 (the port's `speech_decoder_forward`
    without its `ieee_float32` guard, cuDNN's and cuBLAS's TF32 on): the
    control for `wave_err`, which the weight format's control leaves
    alone. Returns the undo."""
    import torch

    from whisperkit_tpu_torch.pipelines import tts as pipeline

    vocode = pipeline.speech_decoder_forward

    def tf32(params, codes, dims):
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return vocode.__wrapped__(params, codes, dims)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

    pipeline.speech_decoder_forward = tf32
    return lambda: setattr(pipeline, "speech_decoder_forward", vocode)


FAULTS = {"rows_mixed": rows_mixed, "vocoder_tf32": vocoder_tf32}
