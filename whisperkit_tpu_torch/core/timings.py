"""Wall-clock accounting for the transcription pipeline (the port's copy of
whisperkit_tpu/core/timings.py).

Reference: Sources/WhisperKit/Core/Models.swift:730-844 `TranscriptionTimings`
(30+ counters with derived tokens/sec, RTF, speed factor) and the formatted
report `logTimings` (Models.swift:478-539).
"""

from __future__ import annotations

import dataclasses

from whisperkit_tpu_torch.core.logging import format_time_with_percentage, logging


@dataclasses.dataclass
class TranscriptionTimings:
    # model lifecycle
    model_loading: float = 0.0
    prewarm_load_time: float = 0.0
    encoder_load_time: float = 0.0
    decoder_load_time: float = 0.0
    encoder_specialization_time: float = 0.0
    decoder_specialization_time: float = 0.0
    tokenizer_loading_time: float = 0.0

    # per-stage accumulators
    audio_loading: float = 0.0
    audio_processing: float = 0.0  # resample/pad/trim
    log_mels: float = 0.0
    encoding: float = 0.0
    prefill: float = 0.0
    decoding_init: float = 0.0
    decoding_loop: float = 0.0
    decoding_predictions: float = 0.0
    decoding_filtering: float = 0.0
    decoding_sampling: float = 0.0
    decoding_fallback: float = 0.0
    decoding_windowing: float = 0.0
    decoding_kv_caching: float = 0.0
    decoding_timestamp_alignment: float = 0.0  # word-timestamp DTW
    decoding_non_prediction: float = 0.0
    total_audio_processing_runs: float = 0.0
    total_log_mel_runs: float = 0.0
    total_encoding_runs: float = 0.0
    total_decoding_loops: float = 0.0
    total_decoding_windows: float = 0.0
    total_decoding_fallbacks: float = 0.0
    prefill_cache_hits: float = 0.0  # fallback rungs that reused the prompt pass
    first_token_time: float = 0.0  # absolute perf_counter timestamp
    pipeline_start: float = 0.0  # absolute perf_counter timestamp
    input_audio_seconds: float = 1e-3
    full_pipeline: float = 0.0

    @property
    def tokens_per_second(self) -> float:
        """Reference: Models.swift:766-768."""
        return self.total_decoding_loops / self.full_pipeline if self.full_pipeline > 0 else 0.0

    @property
    def real_time_factor(self) -> float:
        """Reference: Models.swift:770-772 (lower is better)."""
        return self.full_pipeline / self.input_audio_seconds

    @property
    def speed_factor(self) -> float:
        """Reference: Models.swift:774-776 (higher is better)."""
        return self.input_audio_seconds / self.full_pipeline if self.full_pipeline > 0 else 0.0

    @property
    def time_to_first_token(self) -> float:
        """Reference: Models.swift:483."""
        if self.first_token_time and self.pipeline_start:
            return self.first_token_time - self.pipeline_start
        return 0.0

    def log(self) -> None:
        """Formatted timing report (reference: Models.swift:478-539 `logTimings`)."""
        full = self.full_pipeline
        rows = [
            ("Audio Load", self.audio_loading, 1),
            ("Audio Processing", self.audio_processing, self.total_audio_processing_runs),
            ("Mels", self.log_mels, self.total_log_mel_runs),
            ("Encoding", self.encoding, self.total_encoding_runs),
            ("Decoding", self.decoding_loop, self.total_decoding_loops),
            ("- Prefill", self.prefill, 1),
            ("- Predictions", self.decoding_predictions, self.total_decoding_loops),
            ("- Filtering", self.decoding_filtering, self.total_decoding_loops),
            ("- Sampling", self.decoding_sampling, self.total_decoding_loops),
            ("- KV Caching", self.decoding_kv_caching, self.total_decoding_loops),
            ("- Windowing", self.decoding_windowing, self.total_decoding_windows),
            ("- Fallbacks", self.decoding_fallback, self.total_decoding_fallbacks),
            ("- Word Timestamps", self.decoding_timestamp_alignment, self.total_decoding_windows),
        ]
        logging.info("---- Transcription Timings ----")
        for name, t, runs in rows:
            logging.info(f"{name:<20}: {format_time_with_percentage(t, max(runs, 1), full)}")
        logging.info(
            f"Full pipeline: {full * 1000:.2f} ms | RTF {self.real_time_factor:.4f} | "
            f"speed {self.speed_factor:.1f}x | {self.tokens_per_second:.1f} tok/s | "
            f"TTFT {self.time_to_first_token * 1000:.1f} ms"
        )
