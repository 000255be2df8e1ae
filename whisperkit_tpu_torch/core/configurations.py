"""Pipeline and decoding configuration (the port's copy of
whisperkit_tpu/core/configurations.py: the same classes, fields and
defaults).

Field set mirrors the reference's `WhisperKitConfig` / `DecodingOptions`
(reference: Sources/WhisperKit/Core/Configurations.swift:7-247), snake_cased.
The port runs every option here. The mesh fields (`dp_size`, `tp_size`,
`dcn_size`) lay the pipeline's devices out as the JAX package's
dcn x dp x tp mesh (whisperkit_tpu_torch/parallel/); dp_size None infers
dp from the devices, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence


class ChunkingStrategy(str, enum.Enum):
    """How audio longer than one 30 s window is split.

    Reference: Configurations.swift `ChunkingStrategy {none, vad}`.
    """

    NONE = "none"
    VAD = "vad"


class DecodingTask(str, enum.Enum):
    TRANSCRIBE = "transcribe"
    TRANSLATE = "translate"


@dataclasses.dataclass
class DecodingOptions:
    """Per-call decode options (reference: Configurations.swift:155-247).

    Defaults match the reference's defaults.
    """

    verbose: bool = False
    task: DecodingTask = DecodingTask.TRANSCRIBE
    language: Optional[str] = None
    temperature: float = 0.0
    temperature_increment_on_fallback: float = 0.2
    temperature_fallback_count: int = 5
    sample_length: int = 224  # max tokens per 30 s window
    top_k: int = 5
    use_prefill_prompt: bool = True
    use_prefill_cache: bool = True
    detect_language: bool = False
    skip_special_tokens: bool = False
    without_timestamps: bool = False
    word_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0
    max_window_seek: Optional[float] = None
    clip_timestamps: Sequence[float] = ()
    window_clip_time: float = 1.0
    prompt_tokens: Optional[Sequence[int]] = None
    prefix_tokens: Optional[Sequence[int]] = None
    suppress_blank: bool = False
    suppress_tokens: Sequence[int] = ()
    compression_ratio_threshold: Optional[float] = 2.4
    logprob_threshold: Optional[float] = -1.0
    first_token_log_prob_threshold: Optional[float] = -1.5
    no_speech_threshold: Optional[float] = 0.6
    concurrent_worker_count: int = 16
    chunking_strategy: ChunkingStrategy = ChunkingStrategy.NONE
    # additions without a reference counterpart
    beam_size: int = 1
    patience: float = 1.0
    length_penalty: Optional[float] = None
    seed: int = 0
    # serving scheduling class: "throughput" batches the request with
    # concurrent work, "latency" decodes it alone at batch 1
    priority: str = "throughput"

    def __post_init__(self) -> None:
        if isinstance(self.task, str):
            self.task = DecodingTask(self.task)
        if isinstance(self.chunking_strategy, str):
            self.chunking_strategy = ChunkingStrategy(self.chunking_strategy)
        if self.temperature_fallback_count < 0:
            raise ValueError("temperature_fallback_count must be >= 0")
        if self.sample_length <= 0:
            raise ValueError("sample_length must be > 0")
        if self.priority not in ("throughput", "latency"):
            raise ValueError("priority must be 'throughput' or 'latency'")

    @property
    def temperatures(self) -> list[float]:
        """Temperature ladder used by the fallback driver.

        Reference: TranscribeTask.swift:327 — t, t+inc, ..., fallback_count
        increments.
        """
        return [
            self.temperature + self.temperature_increment_on_fallback * i
            for i in range(self.temperature_fallback_count + 1)
        ]


@dataclasses.dataclass
class ComputeOptions:
    """Precision, quantization and placement options."""

    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    logits_dtype: str = "float32"
    # "w8a16": int8 linear weights; "w4a16": group-wise int4 linear
    # weights; "w8a8": the w8a16 weights with int8 activations in the
    # encoder's linears (the decoder stays W8A16)
    quantization: Optional[str] = None
    quantize_cross_kv: bool = False  # int8 decode cross-KV (opt-in serving mode)
    quantize_self_kv: bool = False  # int8 decode self-KV, per-token scales
    # quantized at write time (models/whisper._self_kv_write)
    segmented_decode: bool = False  # resumable ~32-token decode segments
    # with finished-row batch compaction
    int16_audio_transfer: bool = False  # int16 audio upload format
    sync_timings: bool = False  # wait for the device at stage boundaries
    # so the per-stage rows of TranscriptionTimings report execution time,
    # not enqueue time; the totals are right either way
    mesh_axes: tuple[str, ...] = ("dp", "tp")
    dp_size: Optional[int] = None  # None = infer from devices
    tp_size: int = 1
    dcn_size: int = 1

    @classmethod
    def serving(cls, **overrides) -> "ComputeOptions":
        """The high-throughput serving preset: int8 cross-KV decode (the
        per-layer fused project+quantize in encode, models/whisper.
        compute_cross_kv_quantized), which cuts the decode loop's cross-KV
        bytes by half and more. Default construction stays bf16-exact."""
        return cls(**{"quantize_cross_kv": True, **overrides})


@dataclasses.dataclass
class WhisperConfig:
    """Pipeline construction config (reference: WhisperKitConfig, Configurations.swift:7-121)."""

    model: Optional[str] = None  # e.g. "tiny", "large-v3"
    model_repo: Optional[str] = None
    model_folder: Optional[str] = None
    tokenizer_folder: Optional[str] = None
    compute_options: ComputeOptions = dataclasses.field(default_factory=ComputeOptions)
    verbose: bool = False
    log_level: str = "info"
    prewarm: bool = False
    load: bool = True
    download: bool = True
    use_background_download_session: bool = False
