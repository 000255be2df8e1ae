"""The system under test for a Whisper configuration: the port's
`WhisperPipeline` (and, for request traffic, its `BatchScheduler`) over the
benchmark's weights.

The benchmark makes the bf16 weight tree on the device from the seed
(`references.whisper.init_weights`, the port's `init_params` layout) and
hands it over; the port's own set-up does the rest, as its loader would:
the float32 view of the embedding that its logits read, the W8A16 (or
W4A16) quantization of the linears (`ops/quant.quantize_whisper_params`),
and the `ComputeOptions` of the configuration's `serving` block. The
tokenizer is the one the port builds without a download (`FakeTokenizer`).

Besides `System`, what the harness and its tools take from a system module:
`instrument(spans)`, the benchmark's spans around the pipeline's calls;
`counters()`, the port's counters read around a window; `LOWER`, the
control's weight format for each stated one; `FAULTS`, the faults the
control script can plant.
"""

from __future__ import annotations

import time

from benchmark.references.whisper import Dims, init_weights
from benchmark.workload import pipeline_options

WEIGHT_BITS = {"w8a16": 8, "w4a16": 4}
LOWER = {"w8a16": "w4a16"}  # the next weight format below the stated one


class System:
    def __init__(self, config: dict, seed: int, device: str = "cuda"):
        import torch

        from whisperkit_tpu_torch.core.configurations import ComputeOptions, WhisperConfig
        from whisperkit_tpu_torch.models.whisper import WhisperDims
        from whisperkit_tpu_torch.ops.quant import quantize_whisper_params
        from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline

        dims = Dims.of(config["model"])
        if dims.encoder_ffn != 4 * dims.d_model or dims.decoder_ffn != 4 * dims.d_model:
            raise ValueError("the port's Whisper takes feed-forward widths of 4 x d_model")
        serving = config["serving"]
        self.dims = WhisperDims(dims.n_mels, dims.n_vocab, dims.n_audio_ctx, dims.d_model, dims.encoder_heads,
                                dims.encoder_layers, dims.n_text_ctx, dims.d_model, dims.decoder_heads,
                                dims.decoder_layers)
        tree = init_weights(dims, seed, device)
        tree["decoder"]["token_embed_f32"] = tree["decoder"]["token_embed"].float()
        quantization = None if serving["weights"] == "bfloat16" else serving["weights"]
        if quantization is not None:
            # min_size 1: the configuration states every block linear in the format
            tree = quantize_whisper_params(tree, min_size=1, bits=WEIGHT_BITS[quantization])
        compute = ComputeOptions(
            quantization=quantization,
            quantize_cross_kv=serving["cross_kv"] == "int8",
            quantize_self_kv=serving["self_kv"] == "int8",
        )
        self.pipeline = WhisperPipeline(WhisperConfig(compute_options=compute, load=False),
                                        dims=self.dims, params=tree, device=device)
        self.device = torch.device(device)
        self.scheduler = None

    def options(self, group: int):
        from whisperkit_tpu_torch.core.configurations import DecodingOptions

        return DecodingOptions(**pipeline_options(group))

    def transcribe(self, audio, options):
        return self.pipeline.transcribe(audio, options)

    def start_scheduler(self, max_batch: int, max_wait_ms: float):
        from whisperkit_tpu_torch.pipelines.scheduler import BatchScheduler

        self.scheduler = BatchScheduler(self.pipeline, max_batch=max_batch, max_wait_ms=max_wait_ms)
        return self.scheduler

    def batch_counts(self) -> list[int]:
        """Real windows of each batch the scheduler has run."""
        return list(self.scheduler.stats["windows_per_batch"])

    def close(self) -> None:
        """Stop the scheduler's thread and drop the pipeline and its weights."""
        import torch

        if self.scheduler is not None:
            self.scheduler.shutdown()
            if self.scheduler._thread.is_alive():
                raise RuntimeError("the scheduler's collector thread did not stop")
            self.scheduler = None
        self.pipeline = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def instrument(spans):
    """Wrap the two calls that `WhisperPipeline` makes for every group of
    windows (`encode_window` and `decode_loop`, as `pipelines/whisper.py`
    names them; the batcher reaches them through the pipeline too) so that
    `spans` records them: an encode's rows, a decode's rows and positions.
    The encode call opens and closes a requested trace slice. Two clock
    reads a call. Returns the undo."""
    from whisperkit_tpu_torch.pipelines import whisper as pipeline

    encode, decode = pipeline.encode_window, pipeline.decode_loop

    def encode_window(params, mel, *args, **kwargs):
        spans.maybe_trace()
        t0 = time.perf_counter()
        out = encode(params, mel, *args, **kwargs)
        spans.record("encode", t0, int(mel.shape[0]))
        return out

    def decode_loop(params, cross_k, cross_v, prompt, *args, **kwargs):
        t0 = time.perf_counter()
        out = decode(params, cross_k, cross_v, prompt, *args, **kwargs)
        spans.record("decode", t0, int(prompt.shape[0]), int(out.length) - int(kwargs["sample_begin"]))
        return out

    pipeline.encode_window, pipeline.decode_loop = encode_window, decode_loop

    def undo():
        pipeline.encode_window, pipeline.decode_loop = encode, decode

    return undo


def counters() -> dict:
    """The decode graphs' captures, replays and capture seconds, summed over
    the devices (the port's `decoding/graph.stats_by_device`)."""
    from whisperkit_tpu_torch.decoding import graph

    out = dict.fromkeys(graph.STATS, 0.0)
    for per in graph.stats_by_device.values():
        for key in graph.STATS:
            out[key] += per.get(key, 0)
    return out


def rows_mixed():
    """The batcher's fault: each row of a group decodes against the next
    row's encoded audio. Returns the undo."""
    from whisperkit_tpu_torch.pipelines import whisper as pipeline

    encode = pipeline.encode_window

    def mixed(*args, **kwargs):
        enc, ck, cv = encode(*args, **kwargs)
        roll = (lambda x: {k: v.roll(1, 1) for k, v in x.items()}) if isinstance(ck, dict) else (
            lambda x: x.roll(1, 1))
        return enc, roll(ck), roll(cv)

    pipeline.encode_window = mixed
    return lambda: setattr(pipeline, "encode_window", encode)


FAULTS = {"rows_mixed": rows_mixed}
