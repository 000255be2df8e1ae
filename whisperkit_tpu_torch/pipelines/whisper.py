"""WhisperPipeline — the transcription façade (port of
whisperkit_tpu/pipelines/whisper.py).

Reference: Sources/WhisperKit/Core/WhisperKit.swift and
TranscribeTask.swift. VAD chunks are stacked into a real batch dimension
and decoded together, in length-sorted groups of `concurrent_worker_count`
windows with a power-of-two bucket for the last, partial group; audio of at
most one window takes the seek path.

The port covers the JAX pipeline's decoding choices: greedy and top-k
decoding with the temperature-fallback ladder, beam search
(`beam_size > 1`, `length_penalty`), word timestamps (`word_timestamps`,
with `alignment_heads`), timestamp rules, language detection, segmented
decode with batch compaction (`ComputeOptions.segmented_decode`),
mid-window cancellation (`early_stop_flag`), batch-1 speculative decoding
with a draft model (`draft_dims`/`draft_params`), bf16/f32 weights and
`ComputeOptions`' int8 side: the int8 cross-KV serving mode
(`ComputeOptions.serving()`), the int8 self-KV cache (`quantize_self_kv`),
W8A16/W4A16/W8A8 weights and the int16 audio upload
(`int16_audio_transfer`).

Weights come from a checkpoint folder (`load_models`: the registry
resolves `WhisperConfig.model_folder`/`model`, models/loader.load_whisper
reads and quantizes it, text/tokenizer.load_tokenizer reads its BPE), or
in memory as `dims`/`params` (already quantized by
`ops/quant.quantize_whisper_params` where a scheme is wanted).

More than one device: `device` may be a sequence of devices (a bare
"cuda" is one card, the current one). With `ComputeOptions.dp_size`,
`tp_size` and `dcn_size` (dp inferred from the devices when None, as in
the JAX package) the VAD batch path runs each group over the
dcn x dp x tp mesh (parallel/; one cell on one device): the group is
padded to a multiple of dcn x dp rows and split dcn-major into the cells'
rows; in one thread per device every cell encodes its rows and runs the
fallback ladder on them, over its tp ranks' weight shards
(parallel/sharding.py). The language is detected from every cell's
probabilities together, and a sampled rung's noise is drawn for the whole
group from one generator and split by rows (parallel/mesh.SharedDraws),
so a seed gives the same text on one device and on N. As in the JAX
package the other paths (the seek path, the short batch, streaming) run on
the first device, which under tp > 1 keeps the whole tree besides its
rank's shard; speculative decoding runs where the mesh is one cell.
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from whisperkit_tpu_torch.audio.chunker import VADAudioChunker
from whisperkit_tpu_torch.audio.io import SAMPLE_RATE, load_audio, pad_or_trim
from whisperkit_tpu_torch.core.configurations import (
    ChunkingStrategy,
    DecodingOptions,
    DecodingTask,
    WhisperConfig,
)
from whisperkit_tpu_torch.core.errors import ModelsUnavailable
from whisperkit_tpu_torch.core.logging import logging
from whisperkit_tpu_torch.core.modelstate import ModelState
from whisperkit_tpu_torch.core.results import (
    DecodingFallback,
    TranscriptionProgress,
    TranscriptionResult,
    TranscriptionSegment,
)
from whisperkit_tpu_torch.core.signposts import new_request, signpost
from whisperkit_tpu_torch.core.timings import TranscriptionTimings
from whisperkit_tpu_torch.decoding.beam import beam_decode_loop
from whisperkit_tpu_torch.decoding.filters import non_speech_token_ids, suppress_tokens_bias
from whisperkit_tpu_torch.decoding.loop import (
    DecodeScalars,
    alignment_forward,
    decode_loop,
    decode_loop_segmented,
    detect_language_logits,
    encode_window,
    prefill_window,
)
from whisperkit_tpu_torch.decoding.speculative import speculative_decode_loop
from whisperkit_tpu_torch.models.whisper import WhisperDims, _map
from whisperkit_tpu_torch.ops.mel import log_mel_spectrogram
from whisperkit_tpu_torch.parallel.group import TPRank
from whisperkit_tpu_torch.parallel.mesh import Devices, MeshPlan, SharedDraws, resolve_devices, shard_batch
from whisperkit_tpu_torch.text.languages import LANGUAGES
from whisperkit_tpu_torch.text.segment_seeker import (
    FRAMES_PER_SECOND,
    WINDOW_FRAMES,
    find_seek_point_and_segments,
)
from whisperkit_tpu_torch.text.tokenizer import FakeTokenizer, load_tokenizer
from whisperkit_tpu_torch.text.utils import compression_ratio_text
from whisperkit_tpu_torch.text.word_timestamps import add_word_timestamps

WINDOW_SAMPLES = 480_000  # Constants.windowSamples (Models.swift:1457)
MAX_TOKEN_CONTEXT = 224  # Constants.maxTokenContext (Models.swift:1334)
MEL_BATCH = 32  # windows per mel launch


@dataclasses.dataclass
class _WindowDecode:
    """Per-window decode outcome after the fallback ladder."""

    tokens: list[int]
    logprobs: list[float]
    avg_logprob: float
    compression_ratio: float
    no_speech_prob: float
    temperature: float
    language: str
    alignment: Optional[np.ndarray] = None  # [T, A, 1500] (prompt + sampled rows)
    sample_begin: int = 0


@dataclasses.dataclass
class _Shard:
    """One mesh worker's share of a VAD group: its rank's tree and device,
    its rows of the group, the group's shared noise per sampled rung, its
    tp rank, and timings of its own (only the coordinating thread writes
    the pipeline's)."""

    params: dict
    device: torch.device
    rows: slice
    draws: dict[int, SharedDraws]
    tp: Optional[TPRank]
    timings: TranscriptionTimings = dataclasses.field(default_factory=TranscriptionTimings)


# a worker's stage seconds run beside the other workers' (the group's time
# is the slowest's); its counts add up
_SHARD_SECONDS = ("prefill", "decoding_loop", "decoding_fallback")
_SHARD_COUNTS = ("total_decoding_loops", "total_decoding_fallbacks", "prefill_cache_hits")


class WhisperPipeline:
    """Reference: `WhisperKit` class (WhisperKit.swift)."""

    def __init__(
        self,
        config: Optional[WhisperConfig] = None,
        *,
        dims: Optional[WhisperDims] = None,
        params=None,
        tokenizer=None,
        alignment_heads: Optional[np.ndarray] = None,
        draft_dims: Optional[WhisperDims] = None,
        draft_params=None,
        device: Devices = "cuda",
        **kwargs,
    ):
        self.devices = resolve_devices(device)
        self.device = self.devices[0]
        self.config = config or WhisperConfig(**kwargs)
        self._mesh_plan: Optional[MeshPlan] = None
        self._mesh_trees: Optional[list] = None
        self.model_state = ModelState.UNLOADED
        self.dims = dims
        self.tokenizer = tokenizer
        self.alignment_heads = alignment_heads
        self.timings = TranscriptionTimings()
        self._suppress_cache: dict[tuple, torch.Tensor] = {}
        self._detected_language: Optional[str] = None
        # speculative decoding (batch-1 latency mode): a draft model sharing
        # the vocab makes greedy batch-1 decodes run the lossless
        # draft-verify loop (decoding/speculative.py)
        self.draft_dims = draft_dims
        self.draft_params = (
            None if draft_params is None else _map(lambda _, t: t.to(self.device), draft_params)
        )
        self._draft_kv = None  # (cross_k, cross_v) of the draft for the current window
        # cross-thread cancellation (core/concurrency.EarlyStopFlag, or
        # anything with .should_stop): when set, greedy decodes run in
        # segments and the flag is polled between them
        self.early_stop_flag = None
        self.params = None
        if params is not None and dims is not None:
            self.params = _map(lambda _, t: t.to(self.device), params)
            if self.tokenizer is None:
                self.tokenizer = FakeTokenizer(dims.n_vocab)
            self.model_state = ModelState.LOADED
        elif self.config.load:
            self.load_models()

    # -- lifecycle ----------------------------------------------------------

    def load_models(self) -> None:
        """Resolve + load checkpoint and tokenizer onto the pipeline's device.

        Reference: WhisperKit.swift:358-442 `loadModels`.
        """
        from whisperkit_tpu_torch.core.registry import resolve_model_folder
        from whisperkit_tpu_torch.models.loader import load_whisper

        t0 = time.perf_counter()
        self.model_state = ModelState.LOADING
        model = self.config.model
        if model is None and self.config.model_folder is None:
            # pick the platform's recommended variant (reference:
            # recommendedRemoteModels, WhisperKit.swift:162-217)
            from whisperkit_tpu_torch.core.model_support import current_device_identifier, recommended_model

            model = recommended_model(current_device_identifier(self.device))
            logging.info(f"no model specified; using recommended '{model}'")
        folder = resolve_model_folder(
            model=model,
            model_repo=self.config.model_repo,
            model_folder=self.config.model_folder,
            download=self.config.download,
        )
        # "w8a8" loads the "w8a16" tree; its A8 half is the encoder's
        # int8-activation dispatch (_act8)
        self.dims, self.params, heads = load_whisper(
            folder, quantization=self.config.compute_options.quantization, device=self.device
        )
        self._mesh_plan = self._mesh_trees = None
        if self.alignment_heads is None:
            self.alignment_heads = heads
        try:
            self.tokenizer = load_tokenizer(folder, self.dims.n_vocab, self.config.tokenizer_folder)
        except FileNotFoundError:
            logging.error("tokenizer files missing; using FakeTokenizer")
            self.tokenizer = FakeTokenizer(self.dims.n_vocab)
        self._suppress_cache.clear()
        self.timings.model_loading = time.perf_counter() - t0
        self.model_state = ModelState.LOADED
        if self.config.prewarm:
            self.prewarm()

    def prewarm(self) -> None:
        """Run mel + encoder + a 4-token decode on one silent window, so the
        kernels are built and loaded before the first request (reference:
        prewarm specialization, WhisperKit.swift:392-427)."""
        self.model_state = ModelState.PREWARMING
        t0 = time.perf_counter()
        silent = np.zeros(WINDOW_SAMPLES, np.float32)
        self._transcribe_array(silent, DecodingOptions(sample_length=4))
        self.timings.encoder_specialization_time = time.perf_counter() - t0
        self.model_state = ModelState.LOADED

    def unload_models(self) -> None:
        self.params = None
        self._mesh_plan = self._mesh_trees = None
        self.model_state = ModelState.UNLOADED

    def _mesh(self) -> MeshPlan:
        """The dcn x dp x tp mesh of ComputeOptions over the pipeline's
        devices, dp inferred from them when None (the JAX `_mesh`): one
        cell on one device. Built at first use, with each cell's rank tree
        in `_mesh_trees` (replicated, or Megatron-split when tp > 1; None
        for one cell, which decodes with `self.params`). A mesh that needs
        more devices than the pipeline has raises, where the JAX package,
        with dp inferred as 0, would quietly run on one device."""
        if self._mesh_plan is None:
            from whisperkit_tpu_torch.parallel.mesh import make_mesh
            from whisperkit_tpu_torch.parallel.sharding import shard_whisper_params

            co = self.config.compute_options
            dp = co.dp_size or max(1, len(self.devices) // (co.tp_size * co.dcn_size))
            plan = make_mesh(dp=dp, tp=co.tp_size, dcn=co.dcn_size, devices=self.devices)
            trees = None  # one cell: the pipeline's own tree, read at each use
            if plan.n_cells * plan.tp > 1:
                try:
                    trees = shard_whisper_params(plan, self.params)
                except ValueError as e:
                    raise ModelsUnavailable(f"tensor-parallel sharding failed for this param tree "
                                            f"(tp={co.tp_size}): {e}") from e
            self._mesh_plan, self._mesh_trees = plan, trees
        return self._mesh_plan

    @property
    def is_multilingual(self) -> bool:
        return self.dims.n_vocab != 51864 if self.dims else True

    @property
    def _act8(self) -> bool:
        """W8A8: int8-activation encoder matmuls (quantization="w8a8"; its
        int8 weights are the W8A16 tree's)."""
        return self.config.compute_options.quantization == "w8a8"

    # -- helpers ------------------------------------------------------------

    def _suppress_bias(self, options: DecodingOptions, device: Optional[torch.device] = None) -> torch.Tensor:
        sp = self.tokenizer.special
        ids = list(options.suppress_tokens or ())
        if -1 in ids:
            ids = [t for t in ids if t != -1] + non_speech_token_ids(sp, self.tokenizer)
        key = (tuple(sorted(set(ids))), device or self.device)
        if key not in self._suppress_cache:
            self._suppress_cache[key] = torch.from_numpy(
                suppress_tokens_bias(sp.n_vocab, key[0])
            ).to(key[1])
        return self._suppress_cache[key]

    def _build_prompt(self, options: DecodingOptions, language: str) -> tuple[list[int], int]:
        """Prefill prompt tokens (reference: TextDecoder.swift:163-216).
        Returns (tokens, sot_index)."""
        sp = self.tokenizer.special
        prompt: list[int] = []
        if options.prompt_tokens:
            keep = MAX_TOKEN_CONTEXT // 2 - 1
            prompt = [sp.startofprev] + list(options.prompt_tokens)[-keep:]
        sot_index = len(prompt)
        prompt.append(sp.sot)
        if self.is_multilingual and options.use_prefill_prompt:
            prompt.append(sp.language_token(language))
            prompt.append(
                sp.translate if options.task == DecodingTask.TRANSLATE else sp.transcribe
            )
        if options.without_timestamps:
            prompt.append(sp.notimestamps)
        if options.prefix_tokens:
            keep = MAX_TOKEN_CONTEXT // 2 - 1
            prompt.extend(list(options.prefix_tokens)[-keep:])
        return prompt, sot_index

    def _generator(self, options: DecodingOptions, seed_step: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(options.seed + seed_step)

    def _decode_scalars(
        self, options: DecodingOptions, temperature: float, seed_step: int, draws=None,
    ) -> DecodeScalars:
        """`draws`: a mesh shard's view of the group's draws for this rung,
        used in place of a generator of its own."""
        max_initial = (
            int(round(options.max_initial_timestamp / 0.02))
            if options.max_initial_timestamp is not None
            else 1500
        )
        ft = (
            options.first_token_log_prob_threshold
            if options.first_token_log_prob_threshold is not None and temperature == 0.0
            else float("-inf")
        )
        generator = None
        if temperature > 0.0:
            generator = draws if draws is not None else self._generator(options, seed_step)
        return DecodeScalars(temperature, max_initial, ft, generator)

    def _sync(self, device: Optional[torch.device] = None) -> None:
        """With ComputeOptions.sync_timings, wait for the calling thread's
        stream on the device so the surrounding stage span measures
        execution, not enqueue. Not the whole device: on replicas of one
        card a tp peer's all-reduce may wait there for this rank's next
        launch. The stage spans (core/signposts.py) time host work: without
        this wait a span around a launch ends once the launch is enqueued,
        and the device's side of a stage comes from a trace, where each
        span is a user annotation beside the device's activities."""
        device = device or self.device
        if self.config.compute_options.sync_timings and device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()

    def _mel(self, window: np.ndarray) -> torch.Tensor:
        """[n_mels, 3000] for one ≤30 s window. It uploads through
        `_upload_audio` like every other path here; the JAX pipeline's
        `_mel` uploads float32 even with `int16_audio_transfer` set."""
        audio = self._upload_audio(np.ascontiguousarray(window, np.float32))
        return log_mel_spectrogram(audio, n_mels=self.dims.n_mels)

    def _mel_batch(self, windows: list) -> torch.Tensor:
        """One [N, n_mels, 3000] tensor for N ≤30 s windows, computed in
        launches of ≤ MEL_BATCH windows."""
        parts = []
        for start in range(0, len(windows), MEL_BATCH):
            stacked = np.stack(
                [pad_or_trim(np.asarray(w, np.float32)) for w in windows[start : start + MEL_BATCH]]
            )
            parts.append(log_mel_spectrogram(self._upload_audio(stacked), n_mels=self.dims.n_mels))
        return parts[0] if len(parts) == 1 else torch.cat(parts, 0)

    def _upload_audio(self, padded: np.ndarray) -> torch.Tensor:
        """Upload float32 audio, as int16 when that is lossless: PCM-derived
        audio (16-bit WAV, int16 arrays) lies on the i/32768 grid, so the
        int16 codes rebuilt on the device as float32 (i / 2^15, exact) are
        bit-identical at half the bytes. `ComputeOptions.
        int16_audio_transfer` forces the int16 form for off-grid audio too:
        each sample rounds to the nearest code (np.rint), clipped to
        [-32768, 32767], ≤ 2^-16 error; NaN becomes 0. The JAX pipeline's
        `_upload_audio`, on its NumPy path."""
        flat = padded.ravel()
        # cheap prefix reject: float-valued audio falls off the grid in the
        # first few samples; don't pay a full pass to find that out
        head = flat[:65536] * np.float32(32768.0)
        i_head = np.rint(head)
        forced = self.config.compute_options.int16_audio_transfer
        lossless = bool((i_head >= -32768.0).all() and (i_head <= 32767.0).all() and (head == i_head).all())
        if not (lossless or forced):
            return torch.from_numpy(padded).to(self.device)
        scaled = flat * np.float32(32768.0)
        if lossless and len(scaled) > len(head):
            i_all = np.rint(scaled)
            lossless = bool((i_all >= -32768.0).all() and (i_all <= 32767.0).all() and (scaled == i_all).all())
        if not (lossless or forced):
            return torch.from_numpy(padded).to(self.device)
        codes = np.clip(np.nan_to_num(np.rint(scaled), nan=0.0), -32768, 32767).astype(np.int16)
        i16 = torch.from_numpy(codes.reshape(padded.shape)).to(self.device)
        return i16.to(torch.float32) / 32768.0

    def _encode(self, mel_batch: torch.Tensor, options: DecodingOptions, params=None):
        """encode_window with the serving-mode int8 cross-KV fused in (not
        for beam search, which repeats the raw cross-KV per beam), over
        `params` (a mesh rank's tree; the pipeline's own when None). With a
        draft model, the pipeline's own tree, a batch of 1 and no option
        that keeps the decode off the speculative path, the draft's
        cross-KV of the same window is computed too."""
        co = self.config.compute_options
        params = self.params if params is None else params
        if (
            self.draft_params is not None
            and params is self.params
            and mel_batch.shape[0] == 1
            and options.beam_size <= 1
            and not (options.word_timestamps and self.alignment_heads is not None)
            and self.early_stop_flag is None
            and not co.segmented_decode
        ):
            _, dck, dcv = encode_window(self.draft_params, mel_batch, self.draft_dims)
            self._draft_kv = (dck, dcv)
        else:
            self._draft_kv = None
        return encode_window(
            params, mel_batch, self.dims,
            quantize_kv=co.quantize_cross_kv and options.beam_size <= 1, act8=self._act8,
        )

    # -- language detection -------------------------------------------------

    def detect_language(self, audio: Union[str, Path, np.ndarray]) -> tuple[str, dict[str, float]]:
        """Reference: WhisperKit.swift:534-581 `detectLangauge` [sic]."""
        if isinstance(audio, (str, Path)):
            audio = load_audio(audio)
        mel = self._mel(pad_or_trim(np.asarray(audio, np.float32)))[None]
        _, ck, cv = encode_window(self.params, mel, self.dims, act8=self._act8)
        probs = detect_language_logits(
            self.params, ck, cv, dims=self.dims, special=self.tokenizer.special
        ).cpu().numpy()[0]
        order = np.argsort(probs)[::-1]
        lang_probs = {LANGUAGES[i][0]: float(probs[i]) for i in order[:10]}
        return LANGUAGES[int(order[0])][0], lang_probs

    def _language_probs(self, ck, cv, n_rows=None) -> np.ndarray:
        """Language probabilities of the first `n_rows` rows: one masked
        decode step over the encoded rows, or, where `ck` is already a
        numpy array of them (a mesh group's, gathered from every cell), those."""
        if isinstance(ck, np.ndarray):
            return ck[: (n_rows or None)]
        with signpost("language", rows=(ck["q8"] if isinstance(ck, dict) else ck).shape[1]):
            probs = detect_language_logits(
                self.params, ck, cv, dims=self.dims, special=self.tokenizer.special
            )
            return probs.cpu().numpy()[: (n_rows or None)]

    def _detect_language_from_encoded(self, ck, cv, n_rows=None) -> str:
        """One masked decode step over all rows; languages ranked by mean
        probability over the first `n_rows` real rows."""
        probs = self._language_probs(ck, cv, n_rows).mean(axis=0)
        return LANGUAGES[int(np.argmax(probs))][0]

    def _detect_languages_per_row(self, ck, cv, n_rows=None) -> list[str]:
        """Per-row language detection over an encoded batch (argmax per row)."""
        probs = self._language_probs(ck, cv, n_rows)
        return [LANGUAGES[int(i)][0] for i in np.argmax(probs, axis=-1)]

    def _needs_language_probs(self, options: DecodingOptions) -> bool:
        """Whether `_group_languages` will detect (and so read the probabilities)."""
        if options.language or not self.is_multilingual:
            return False
        return options.detect_language or self._detected_language is None

    def _group_languages(
        self, options: DecodingOptions, ck, cv, n_real: int, *,
        pad_to: Optional[int] = None, per_row: bool = False,
    ) -> list[str]:
        """The language-resolution ladder for a batch of encoded windows:
        explicit language → non-multilingual "en" → per-row argmax → once-
        per-file cached detection. Pad rows repeat the first language."""
        if options.language:
            langs = [options.language] * n_real
        elif not self.is_multilingual:
            langs = ["en"] * n_real
        elif per_row:
            langs = list(self._detect_languages_per_row(ck, cv, n_real))
        else:
            langs = [self._resolve_language(options, ck, cv, n_real)] * n_real
        if pad_to is not None and pad_to > n_real:
            langs = langs + [langs[0]] * (pad_to - n_real)
        return langs

    def _resolve_language(self, options: DecodingOptions, ck, cv, n_rows=None) -> str:
        """`detect_language=True` re-detects for every window/group; an unset
        language is detected once per call and cached."""
        if options.language:
            return options.language
        if not self.is_multilingual:
            return "en"
        if options.detect_language:
            return self._detect_language_from_encoded(ck, cv, n_rows)
        if self._detected_language is None:
            self._detected_language = self._detect_language_from_encoded(ck, cv, n_rows)
        return self._detected_language

    @staticmethod
    def _majority_language(window_langs: list, options: DecodingOptions) -> str:
        """Majority language across a file's decoded windows (ties break to
        the earlier-seen language)."""
        if not window_langs:
            return options.language or "en"
        counts: dict[str, int] = {}
        for lg in window_langs:
            counts[lg] = counts.get(lg, 0) + 1
        return max(counts, key=counts.get)

    # -- decode with fallback -----------------------------------------------

    def _decode_with_fallback(
        self, cross_k, cross_v, options: DecodingOptions, language, window_index: int,
        shard: Optional[_Shard] = None,
    ) -> list[_WindowDecode]:
        """Temperature ladder over a batch of encoded windows (reference:
        TranscribeTask.swift:316-411). Failed rows are re-decoded at the
        next temperature; accepted rows keep their first passing result.
        `language` is one code, or one per row. With `shard`, the batch is
        a mesh worker's rows, decoded with its tree on its device
        (speculatively only where that tree is the pipeline's own: a
        one-cell mesh)."""
        params = self.params if shard is None else shard.params
        dev = self.device if shard is None else shard.device
        timings = self.timings if shard is None else shard.timings
        sp = self.tokenizer.special
        b = (cross_k["q8"] if isinstance(cross_k, dict) else cross_k).shape[1]
        langs = [language] * b if isinstance(language, str) else list(language)
        if len(langs) != b:
            raise ValueError(f"per-row languages: got {len(langs)} for batch of {b}")
        prompts = [self._build_prompt(options, lg) for lg in langs]
        prompt, sot_index = prompts[0]
        prompt_arr = torch.tensor([p for p, _ in prompts], dtype=torch.long, device=dev)
        suppress = self._suppress_bias(options, dev)
        max_new = min(options.sample_length, MAX_TOKEN_CONTEXT - len(prompt))
        capture = options.word_timestamps and self.alignment_heads is not None
        align_heads = tuple(map(tuple, np.asarray(self.alignment_heads).tolist())) if capture else None
        co = self.config.compute_options

        # one prompt pass, reused by every rung of the ladder; made when a
        # rung first needs it (beam search runs its own)
        prefill = None
        # the self-KV cache's form is fixed where the prefill allocates it
        qskv = co.quantize_self_kv

        def get_prefill():
            nonlocal prefill
            if prefill is None:
                with signpost("prefill", rows=b) as span:
                    prefill = prefill_window(
                        params, cross_k, cross_v, prompt_arr,
                        dims=self.dims, special=sp, sample_begin=len(prompt),
                        max_new_tokens=max_new, sot_index=sot_index, alignment_heads=align_heads,
                        quantize_self_kv=qskv,
                    )
                    self._sync(dev)
                timings.prefill += span.seconds
            else:
                timings.prefill_cache_hits += 1
            return prefill

        common = dict(
            dims=self.dims, special=sp, sample_begin=len(prompt), max_new_tokens=max_new,
            sot_index=sot_index, use_timestamp_rules=not options.without_timestamps,
            suppress_blank=options.suppress_blank,
        )
        results: list[Optional[_WindowDecode]] = [None] * b
        for rung, temperature in enumerate(options.temperatures):
            draws = None if shard is None or rung not in shard.draws else shard.draws[rung].rows(shard.rows)
            scalars = self._decode_scalars(options, temperature, window_index * 101 + rung, draws)
            use_beam = options.beam_size > 1 and temperature == 0.0
            flag = self.early_stop_flag
            should_stop = None
            if flag is not None:
                should_stop = lambda: flag.should_stop  # noqa: E731
                if shard is not None and shard.tp is not None:
                    # the tp ranks must stop at the same segment: the first reads the flag
                    should_stop = lambda: shard.tp.agree(lambda: flag.should_stop)  # noqa: E731
            # batch-1 latency mode: lossless draft-verify with prefills of its
            # own, sized for a round's writes past the window's budget
            speculative = not use_beam and (
                params is self.params and self._draft_kv is not None and b == 1 and temperature == 0.0
                and not capture and flag is None and not co.segmented_decode
            )
            pre = None if use_beam or speculative else get_prefill()
            with signpost("decode", rows=b, rung=rung) as loop_span:
                if use_beam:
                    out = beam_decode_loop(
                        params, cross_k, cross_v, prompt_arr, suppress,
                        scalars.max_initial_timestamp_index, beam_size=options.beam_size,
                        length_penalty=options.length_penalty, **common,
                    )
                elif speculative:
                    out = speculative_decode_loop(
                        self.params, self.draft_params, cross_k, cross_v, *self._draft_kv,
                        prompt_arr, suppress, scalars, draft_dims=self.draft_dims, **common,
                    )
                elif flag is not None or co.segmented_decode:
                    out = decode_loop_segmented(
                        params, cross_k, cross_v, prompt_arr, suppress, scalars,
                        top_k=options.top_k, alignment_heads=align_heads, prefill=pre,
                        should_stop=should_stop, compact=co.segmented_decode, **common,
                    )
                else:
                    out = decode_loop(
                        params, cross_k, cross_v, prompt_arr, suppress, scalars,
                        top_k=options.top_k, alignment_heads=align_heads, prefill=pre, **common,
                    )
                loop_span.attrs["positions"] = int(out.length) - len(prompt)
            with signpost("readback") as read_span:
                tokens_np = out.tokens.cpu().numpy()
                lps_np = out.token_logprobs.cpu().numpy()
                nsp_np = out.no_speech_prob.float().cpu().numpy()
                align_np = None
                if capture and use_beam:
                    # beam search does not capture in its loop: one teacher-forced
                    # pass over the winning hypotheses (openai timing.py style)
                    align_np = alignment_forward(
                        params, cross_k, cross_v, out.tokens, dims=self.dims, alignment_heads=align_heads,
                    ).cpu().numpy()
                elif capture:
                    # the rows past the loop's last position are zeros
                    align_np = out.alignment[: min(out.length + 1, out.alignment.shape[0])].cpu().numpy()
            rung_s = loop_span.seconds + read_span.seconds
            timings.decoding_loop += rung_s
            if rung > 0:
                timings.decoding_fallback += rung_s
                timings.total_decoding_fallbacks += b

            any_pending = False
            with signpost("fallback_eval", rows=b):
                for i in range(b):
                    if results[i] is not None:
                        continue
                    row = tokens_np[i, len(prompt):]
                    eots = np.nonzero(row == sp.eot)[0]
                    n = int(eots[0]) if len(eots) else len(row)
                    sampled = row[:n].tolist()
                    lps = lps_np[i, len(prompt) : len(prompt) + n].tolist()
                    eot_lp = float(lps_np[i, len(prompt) + n]) if n < len(row) else 0.0
                    timings.total_decoding_loops += n + (1 if n < len(row) else 0)
                    avg_lp = (sum(lps) + eot_lp) / (n + 1) if n else eot_lp
                    text = self.tokenizer.decode(sampled)
                    cr = compression_ratio_text(text)
                    first_lp = lps[0] if lps else None
                    fallback = DecodingFallback.evaluate(
                        logprob_threshold=options.logprob_threshold,
                        first_token_logprob_threshold=options.first_token_log_prob_threshold,
                        no_speech_threshold=options.no_speech_threshold,
                        compression_ratio_threshold=options.compression_ratio_threshold,
                        compression_ratio=cr,
                        avg_logprob=avg_lp,
                        first_token_logprob=first_lp,
                        no_speech_prob=float(nsp_np[i]),
                    )
                    is_last_rung = rung == len(options.temperatures) - 1
                    if fallback is None or not fallback.need_fallback or is_last_rung:
                        results[i] = _WindowDecode(
                            tokens=sampled, logprobs=lps, avg_logprob=avg_lp,
                            compression_ratio=cr, no_speech_prob=float(nsp_np[i]),
                            temperature=temperature, language=langs[i],
                            alignment=None if align_np is None else align_np[: len(prompt) + n + 1, i],
                            sample_begin=len(prompt),
                        )
                    else:
                        any_pending = True
            if not any_pending:
                break
        return results  # type: ignore[return-value]

    # -- transcribe ---------------------------------------------------------

    def transcribe(
        self,
        audio: Union[str, Path, np.ndarray, Sequence],
        decode_options: Optional[DecodingOptions] = None,
        callback: Optional[Callable[[TranscriptionProgress], Optional[bool]]] = None,
    ) -> Union[TranscriptionResult, list]:
        """Transcribe a path, an array, or a list of either (a list returns
        a list of per-item results, exceptions preserved per item)."""
        options = decode_options or DecodingOptions()
        if isinstance(audio, (list, tuple)):
            return self._transcribe_batch(list(audio), options, callback)
        # the request's root span: every stage span below carries its id
        with signpost("transcribe", request=new_request()) as root:
            timings = TranscriptionTimings(pipeline_start=root.t0)
            self.timings = timings
            self._detected_language = None  # per call; never reused across files
            if isinstance(audio, (str, Path)):
                audio = load_audio(audio)
                timings.audio_loading = time.perf_counter() - root.t0
            audio = np.asarray(audio, np.float32)
            timings.input_audio_seconds = max(len(audio) / SAMPLE_RATE, 1e-3)
            root.attrs["audio_s"] = len(audio) / SAMPLE_RATE

            if self.params is None:
                raise ModelsUnavailable("models not loaded")

            use_vad = (
                options.chunking_strategy == ChunkingStrategy.VAD
                and len(audio) > WINDOW_SAMPLES
            )
            if use_vad:
                result = self._transcribe_vad_chunked(audio, options, callback)
            else:
                result = self._transcribe_array(audio, options, callback)
        timings.full_pipeline = root.seconds
        result.timings = timings
        return result

    def _transcribe_batch(self, items: list, options: DecodingOptions, callback=None) -> list:
        """Short items (≤ one window) are stacked into one batched decode;
        longer ones run through their own paths. Per-item failures are
        preserved in order."""
        loaded: list = [None] * len(items)
        results: list = [None] * len(items)
        for i, item in enumerate(items):
            try:
                loaded[i] = (
                    load_audio(item) if isinstance(item, (str, Path))
                    else np.asarray(item, np.float32)
                )
            except Exception as e:  # per-item failure, returned in its slot
                results[i] = e
        short_idx = [
            i for i, a in enumerate(loaded)
            if results[i] is None and len(a) <= WINDOW_SAMPLES
        ]
        group = max(1, options.concurrent_worker_count)
        for start in range(0, len(short_idx), group):
            batch_ids = short_idx[start : start + group]
            try:
                batch_results = self._transcribe_short_batch(
                    [loaded[i] for i in batch_ids], options
                )
                for i, r in zip(batch_ids, batch_results):
                    results[i] = r
            except Exception as e:  # the batch's failure, returned per item
                for i in batch_ids:
                    results[i] = e
        for i, a in enumerate(loaded):
            if results[i] is None:
                try:
                    results[i] = self.transcribe(a, options, callback)
                except Exception as e:  # per-item failure, returned in its slot
                    results[i] = e
        return results

    def _transcribe_short_batch(self, audios: list, options: DecodingOptions) -> list:
        """Decode N ≤30 s clips as one batch, language resolved per row."""
        t0 = time.perf_counter()
        with signpost("mel", windows=len(audios)):
            mel_batch = self._mel_batch(audios)
        with signpost("encode", rows=len(audios)):
            _, ck, cv = self._encode(mel_batch, options)
        self._detected_language = None
        langs = self._group_languages(options, ck, cv, len(audios), per_row=True)
        decodes = self._decode_with_fallback(ck, cv, options, langs, 0)
        sp = self.tokenizer.special
        out = []
        with signpost("segments") as span:
            for a, wd in zip(audios, decodes):
                window_frames = min(WINDOW_FRAMES, math.ceil(len(a) / 160))
                if self._should_skip_silent(wd, options):
                    segments = []
                else:
                    segments = find_seek_point_and_segments(
                        tokens=wd.tokens, token_logprobs=wd.logprobs, special=sp,
                        time_offset=0.0, window_frames=window_frames, seek=0,
                        decode_fn=self.tokenizer.decode, temperature=wd.temperature,
                        avg_logprob=wd.avg_logprob, compression_ratio=wd.compression_ratio,
                        no_speech_prob=wd.no_speech_prob,
                    ).segments
                    if options.word_timestamps and wd.alignment is not None:
                        segments = self._add_word_timestamps(segments, wd, 0.0, window_frames)
                    for s in segments:
                        s.language = wd.language
                result = TranscriptionResult(
                    text="".join(s.text for s in segments).strip(),
                    segments=segments, language=wd.language,
                )
                result.timings.input_audio_seconds = len(a) / SAMPLE_RATE
                result.timings.full_pipeline = time.perf_counter() - t0
                out.append(result)
            span.attrs["segments"] = sum(len(r.segments) for r in out)
        return out

    def _vad_chunks(self, audio: np.ndarray, options: DecodingOptions) -> list:
        """VAD chunks of each clip region, with absolute sample offsets."""
        chunker = VADAudioChunker()
        chunks = []
        for clip_start_f, clip_end_f in self._prepare_seek_clips(options, len(audio) // 160):
            region = audio[clip_start_f * 160 : clip_end_f * 160]
            for c in chunker.chunk_all(region, max_chunk_length=WINDOW_SAMPLES):
                c.seek_offset_index += clip_start_f * 160
                chunks.append(c)
        return chunks

    def _transcribe_vad_chunked(
        self, audio: np.ndarray, options: DecodingOptions, callback=None
    ) -> TranscriptionResult:
        """VAD-chunk + batched decode in groups of `concurrent_worker_count`
        windows (reference: WhisperKit.swift:867-931)."""
        with signpost("vad") as span:
            chunks = self._vad_chunks(audio, options)
            span.attrs["chunks"] = len(chunks)
        self.timings.audio_processing += span.seconds
        self.timings.total_audio_processing_runs += 1

        plan = self._mesh()
        group = one_group = max(1, options.concurrent_worker_count)
        # clamp to the chunk-count bucket: a group decodes until its slowest
        # row, so pad rows beyond the power-of-two bucket cost a full decode
        if chunks:
            group = one_group = min(group, 1 << max(0, math.ceil(math.log2(len(chunks)))))
        group = plan.pad_batch(group)  # every mesh cell gets equal rows

        def bucket(n_real: int, width: int) -> int:
            # the final partial group decodes at the power-of-two bucket
            # covering its real rows, not at the full group width
            if n_real >= width:
                return width
            return min(1 << max(0, math.ceil(math.log2(n_real))), width)

        def gsize_of(n_real: int) -> int:
            # a dcn x dp multiple
            return min(plan.pad_batch(bucket(n_real, group)), group)

        windows = [
            audio[c.seek_offset_index : c.seek_offset_index + min(len(c.audio_samples), WINDOW_SAMPLES)]
            for c in chunks
        ]
        # a partial last group pads its rows with the mel of a zero window,
        # computed in the same launches as the chunks'
        n_last = len(chunks) % group or group
        pad_rows = bool(chunks) and n_last < gsize_of(n_last)
        if pad_rows:
            windows.append(np.zeros(WINDOW_SAMPLES, np.float32))
        with signpost("mel", windows=len(windows)) as span:
            mels = self._mel_batch(windows) if windows else None
            pad_mel = mels[len(chunks)] if pad_rows else None
            self._sync()
        self.timings.log_mels += span.seconds
        self.timings.total_log_mel_runs += len(chunks)
        metas = [
            (c.seek_offset_index, min(WINDOW_FRAMES, math.ceil(len(c.audio_samples) / 160)))
            for c in chunks
        ]

        # length-sorted groups: similar-length chunks finish together
        order = sorted(range(len(chunks)), key=lambda i: len(chunks[i].audio_samples))
        decodes: list[Optional[_WindowDecode]] = [None] * len(chunks)
        decoded_count = 0
        cancelled = False
        for start in range(0, len(order), group):
            batch_ids = order[start : start + group]
            n_real = len(batch_ids)
            gsize = gsize_of(n_real)
            mel_batch = mels[torch.tensor(batch_ids, device=self.device)]
            if n_real < gsize:
                pad = pad_mel[None].expand(gsize - n_real, *pad_mel.shape)
                mel_batch = torch.cat([mel_batch, pad], 0)
            for i in batch_ids:
                self.window_preprocess(chunks[i].audio_samples, metas[i][0] // 160, metas[i][1])
            # the rows one device would decode this group at: its draws' batch
            batch_decodes = self._decode_group_on_mesh(
                plan, mel_batch, options, n_real, start, bucket(n_real, one_group),
            )
            if self.timings.first_token_time == 0.0:
                self.timings.first_token_time = time.perf_counter()
            for i, wd in zip(batch_ids, batch_decodes):
                decodes[i] = wd
            if callback is not None:
                for i, wd in zip(batch_ids, batch_decodes):
                    decoded_count += 1
                    progress = TranscriptionProgress(
                        timings=self.timings,
                        text=self.tokenizer.decode(wd.tokens),
                        tokens=wd.tokens,
                        temperature=wd.temperature,
                        avg_logprob=wd.avg_logprob,
                        compression_ratio=wd.compression_ratio,
                        window_id=i,
                        windows_decoded=decoded_count,
                    )
                    if callback(progress) is False:
                        cancelled = True
                        break
                if cancelled:
                    break
        self.timings.total_decoding_windows += sum(1 for wd in decodes if wd is not None)

        all_segments: list[TranscriptionSegment] = []
        sp = self.tokenizer.special
        with signpost("segments") as span:
            for (start_sample, window_frames), wd in zip(metas, decodes):
                if wd is None or self._should_skip_silent(wd, options):
                    continue
                segs = find_seek_point_and_segments(
                    tokens=wd.tokens, token_logprobs=wd.logprobs, special=sp,
                    time_offset=start_sample / SAMPLE_RATE, window_frames=window_frames,
                    seek=start_sample // 160, decode_fn=self.tokenizer.decode,
                    temperature=wd.temperature, avg_logprob=wd.avg_logprob,
                    compression_ratio=wd.compression_ratio, no_speech_prob=wd.no_speech_prob,
                    segment_id_start=len(all_segments),
                ).segments
                if options.word_timestamps and wd.alignment is not None:
                    segs = self._add_word_timestamps(segs, wd, start_sample / SAMPLE_RATE, window_frames)
                for s in segs:
                    s.language = wd.language
                all_segments.extend(self.window_post_process(start_sample // 160, window_frames, segs))
            span.attrs["segments"] = len(all_segments)
        self.timings.decoding_windowing += span.seconds
        language = self._majority_language(
            [wd.language for wd in decodes if wd is not None], options
        )
        return TranscriptionResult(
            text="".join(s.text for s in all_segments).strip(),
            segments=all_segments, language=language,
        )

    def _decode_group_on_mesh(
        self, plan: MeshPlan, mel_batch: torch.Tensor, options: DecodingOptions, n_real: int, window_index: int,
        draw_rows: int,
    ) -> list[_WindowDecode]:
        """One VAD group over the mesh (a one-cell mesh on one device): its
        rows (a dcn x dp multiple) split dcn-major into the cells' rows, each cell encoding and decoding its
        rows on its tp ranks, one thread per device. The language is
        resolved here from every cell's probabilities; each sampled rung's
        noise is drawn from the one generator a single device would use,
        for the `draw_rows` rows it would decode this group at, and split
        by rows. → the group's real rows' decodes, in order."""
        gsize = mel_batch.shape[0]
        slices = plan.row_slices(gsize)
        parts = shard_batch(plan, mel_batch)
        trees = self._mesh_trees or [[self.params]]
        need_probs = self._needs_language_probs(options)

        def encode(g: int, r: int):
            dev = plan.cells()[g][r]
            # a rank's own tree; the pipeline's (one cell) is _encode's default
            tree = () if trees[g][r] is self.params else (trees[g][r],)
            _, ck, cv = self._encode(parts[g][r], options, *tree)
            probs = None
            if need_probs:  # every rank runs the step: under tp it holds collectives
                with signpost("language", rows=parts[g][r].shape[0]):
                    probs = detect_language_logits(
                        trees[g][r], ck, cv, dims=self.dims, special=self.tokenizer.special,
                    ).cpu().numpy()
            self._sync(dev)
            return ck, cv, probs

        with signpost("encode", rows=gsize) as span:
            encoded = plan.run(encode)
        self.timings.encoding += span.seconds
        self.timings.total_encoding_runs += n_real
        # the probabilities of every cell's rows stand in for the encoded rows
        probs = np.concatenate([cell[0][2] for cell in encoded]) if need_probs else None
        langs = self._group_languages(options, probs, None, n_real, pad_to=gsize, per_row=options.detect_language)
        draws = {
            rung: SharedDraws(self._generator(options, window_index * 101 + rung), min(draw_rows, gsize))
            for rung, t in enumerate(options.temperatures) if t > 0.0
        }

        def decode(g: int, r: int):
            shard = _Shard(trees[g][r], plan.cells()[g][r], slices[g], draws, plan.rank(g, r))
            ck, cv, _ = encoded[g][r]
            decodes = self._decode_with_fallback(ck, cv, options, langs[slices[g]], window_index, shard)
            if shard.tp is not None:  # the decodes were read on the host: the group's collectives are done
                shard.tp.check()
            return decodes, shard.timings

        decoded = plan.run(decode)
        del encoded
        firsts = [cell[0] for cell in decoded]  # a cell's tp ranks decode alike; its first rank speaks
        for name in _SHARD_SECONDS:
            setattr(self.timings, name, getattr(self.timings, name) + max(getattr(t, name) for _, t in firsts))
        for name in _SHARD_COUNTS:
            setattr(self.timings, name, getattr(self.timings, name) + sum(getattr(t, name) for _, t in firsts))
        return [wd for decodes, _ in firsts for wd in decodes][:n_real]

    def _should_skip_silent(self, wd: _WindowDecode, options: DecodingOptions) -> bool:
        """openai-style no-speech window skip."""
        if options.no_speech_threshold is None:
            return False
        if wd.no_speech_prob <= options.no_speech_threshold:
            return False
        if options.logprob_threshold is not None and wd.avg_logprob >= options.logprob_threshold:
            return False
        return True

    def _transcribe_array(
        self, audio: np.ndarray, options: DecodingOptions, callback=None
    ) -> TranscriptionResult:
        """Sequential seek-window loop (reference: TranscribeTask.swift:57-296).

        Audio longer than one window follows openai/whisper `transcribe()`:
        the log-mel is computed once over the whole audio (zero-padded to a
        30 s boundary plus one window) with the clamp global over the file,
        and each seek window is a slice of it."""
        sp = self.tokenizer.special
        content_frames = len(audio) // 160
        seek_clips = self._prepare_seek_clips(options, content_frames)

        full_mel = None
        if content_frames > WINDOW_FRAMES:
            total_frames = (content_frames // WINDOW_FRAMES + 2) * WINDOW_FRAMES
            padded = np.zeros(total_frames * 160, np.float32)
            padded[: len(audio)] = audio
            with signpost("mel", windows=total_frames // WINDOW_FRAMES) as span:
                full_mel = log_mel_spectrogram(
                    self._upload_audio(padded), n_mels=self.dims.n_mels, n_frames=total_frames,
                )
            self.timings.log_mels += span.seconds
            self.timings.total_log_mel_runs += 1

        all_segments: list[TranscriptionSegment] = []
        window_langs: list[str] = []
        window_index = 0
        for clip_start, clip_end in seek_clips:
            seek = clip_start
            window_padding = max(1, int(options.window_clip_time * FRAMES_PER_SECOND))
            while seek < min(clip_end, content_frames):
                remaining = content_frames - seek
                if seek > clip_start and remaining < window_padding:
                    break  # trailing sliver, reference windowClipTime padding
                window_frames = min(WINDOW_FRAMES, min(remaining, clip_end - seek))
                window = audio[seek * 160 : seek * 160 + WINDOW_SAMPLES]
                self.window_preprocess(window, seek, window_frames)
                if full_mel is not None:
                    mel = full_mel[:, seek : seek + WINDOW_FRAMES][None]
                else:
                    with signpost("mel", windows=1) as span:
                        mel = self._mel(pad_or_trim(window))[None]
                    self.timings.log_mels += span.seconds
                    self.timings.total_log_mel_runs += 1
                with signpost("encode", rows=1) as span:
                    _, ck, cv = self._encode(mel, options)
                self.timings.encoding += span.seconds
                self.timings.total_encoding_runs += 1

                language = self._resolve_language(options, ck, cv)
                wd = self._decode_with_fallback(ck, cv, options, language, window_index)[0]
                window_langs.append(wd.language)
                self.timings.total_decoding_windows += 1
                if self.timings.first_token_time == 0.0:
                    self.timings.first_token_time = time.perf_counter()

                if self._should_skip_silent(wd, options):
                    seek += window_frames
                    window_index += 1
                    continue

                with signpost("segments") as span:
                    res = find_seek_point_and_segments(
                        tokens=wd.tokens, token_logprobs=wd.logprobs, special=sp,
                        time_offset=seek / FRAMES_PER_SECOND, window_frames=window_frames,
                        seek=seek, decode_fn=self.tokenizer.decode,
                        temperature=wd.temperature, avg_logprob=wd.avg_logprob,
                        compression_ratio=wd.compression_ratio,
                        no_speech_prob=wd.no_speech_prob,
                        segment_id_start=len(all_segments),
                    )
                    segs = res.segments
                    if options.word_timestamps and wd.alignment is not None:
                        segs = self._add_word_timestamps(segs, wd, seek / FRAMES_PER_SECOND, window_frames)
                    for s in segs:
                        s.language = wd.language
                    all_segments.extend(self.window_post_process(seek, window_frames, segs))
                    span.attrs["segments"] = len(segs)

                advance = res.seek_advance_frames
                if options.max_window_seek is not None:
                    advance = min(advance, int(options.max_window_seek * FRAMES_PER_SECOND))
                seek += max(advance, 1)
                window_index += 1

                if callback is not None:
                    progress = TranscriptionProgress(
                        timings=self.timings,
                        text=self.tokenizer.decode(wd.tokens),
                        tokens=wd.tokens,
                        temperature=wd.temperature,
                        avg_logprob=wd.avg_logprob,
                        compression_ratio=wd.compression_ratio,
                        window_id=window_index,
                    )
                    if callback(progress) is False:
                        seek = clip_end  # early stop (EarlyStopActor semantics)
                        break

        return TranscriptionResult(
            text="".join(s.text for s in all_segments).strip(),
            segments=all_segments,
            language=self._majority_language(window_langs, options),
        )

    # -- subclass hooks ------------------------------------------------------

    def window_preprocess(self, window_audio: np.ndarray, seek: int, segment_size: int) -> None:
        """Hook invoked before each window is decoded (reference:
        TranscribeTask.swift:42-47 `windowPreprocess`)."""

    def window_post_process(self, seek: int, segment_size: int, segments: list) -> list:
        """Hook invoked after a window's segments are built; may replace
        them (reference: TranscribeTask.swift:49-55 `windowPostProcess`)."""
        return segments

    def _prepare_seek_clips(self, options: DecodingOptions, content_frames: int) -> list[tuple[int, int]]:
        """clip_timestamps (seconds) → [start_frame, end_frame) pairs."""
        ts = list(options.clip_timestamps or ())
        if not ts:
            return [(0, content_frames)]
        frames = [int(t * FRAMES_PER_SECOND) for t in ts]
        if len(frames) % 2 == 1:
            frames.append(content_frames)
        return [(frames[i], frames[i + 1]) for i in range(0, len(frames), 2)]

    def _add_word_timestamps(self, segments, wd: _WindowDecode, time_offset: float, window_frames: int):
        t0 = time.perf_counter()
        try:
            return add_word_timestamps(
                segments=segments, alignment=wd.alignment, sample_begin=wd.sample_begin,
                tokens=wd.tokens, tokenizer=self.tokenizer, language=wd.language,
                time_offset=time_offset, window_frames=window_frames,
            )
        finally:
            self.timings.decoding_timestamp_alignment += time.perf_counter() - t0
