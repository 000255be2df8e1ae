"""TTSPipeline — the text-to-speech façade (port of whisperkit_tpu/pipelines/tts.py).

Reference: Sources/TTSKit/TTSKit.swift (façade, chunked generation with
ordered delivery and a 100 ms equal-power crossfade :760-972, streaming
`play` strategies :994-1063, prompt-cache build/save/load :609-683),
Qwen3Config.swift (variants, speakers), TextChunker.swift, PromptCache.swift.

As in the JAX package, the reference's concurrent batch-of-1 chunk tasks
become one batched generation (sentence chunks stacked, left-padded, with
per-row done masks), and the vocoder decodes every frame of every chunk in
one batched call. The pipeline runs on one device, `device` ("cuda" by
default); the JAX package's data-parallel mesh over several devices is not
ported (ROADMAP A.10).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import re
import sys
import threading
import time
import unicodedata
from pathlib import Path
from typing import Iterator, Optional, Union

import numpy as np
import torch

from whisperkit_tpu_torch.audio.output import PlaybackStrategy, StreamingAudioOutput, crossfade, save_audio
from whisperkit_tpu_torch.audio.output import play as play_audio
from whisperkit_tpu_torch.core.device import DeviceLike, resolve_device
from whisperkit_tpu_torch.core.logging import logging
from whisperkit_tpu_torch.decoding.tts_loop import (
    TTSScalars,
    tts_generate_loop,
    tts_generate_segment,
    tts_prefill,
    tts_prefill_state,
)
from whisperkit_tpu_torch.models.qwen3_tts import (
    C2W_CONTEXT_FRAMES,
    CODEC_BOS,
    CODEC_EOS,
    CODEC_PAD,
    CODEC_THINK,
    CODEC_THINK_BOS,
    CODEC_THINK_EOS,
    DEFAULT_SPEAKER,
    DEFAULT_TTS_LANGUAGE,
    OUTPUT_SAMPLE_RATE,
    SAMPLES_PER_FRAME,
    SPEAKERS,
    TINY_TTS_DIMS,
    TTS_LANGUAGES,
    Qwen3TTSDims,
    code2wav_decode_block,
    init_code2wav_cache,
    init_tts_params,
    params_from_numpy,
    params_to_device,
    speech_decoder_forward,
)
from whisperkit_tpu_torch.text.tokenizer import BPETokenizer


@dataclasses.dataclass
class GenerationOptions:
    """Reference: TTSKit/Models.swift:219-287 `GenerationOptions`."""

    voice: Optional[str] = None
    language: str = "english"
    instruction: Optional[str] = None
    temperature: float = 0.9
    top_k: int = 50
    repetition_penalty: float = 1.05
    max_new_tokens: int = 245
    seed: int = 0
    chunking_strategy: str = "sentence"
    target_chunk_size: int = 200
    min_chunk_size: int = 40
    concurrent_worker_count: int = 4  # becomes the generation batch size
    crossfade_seconds: float = 0.1
    use_prompt_cache: bool = True


@dataclasses.dataclass
class SpeechTimings:
    """Reference: TTSKit/Models.swift `SpeechTimings`. Each stage's seconds
    end where its result reaches the host, so they include the device's
    time."""

    tokenize_seconds: float = 0.0
    prefill_seconds: float = 0.0
    generate_seconds: float = 0.0
    vocode_seconds: float = 0.0
    total_seconds: float = 0.0
    frames: int = 0
    chunks: int = 0
    time_to_first_buffer: float = 0.0

    @property
    def ms_per_step(self) -> float:
        return 1000.0 * self.generate_seconds / max(self.frames, 1)

    @property
    def frames_per_second(self) -> float:
        return self.frames / max(self.generate_seconds, 1e-9)

    @property
    def real_time_ratio(self) -> float:
        audio_seconds = self.frames * SAMPLES_PER_FRAME / OUTPUT_SAMPLE_RATE
        return audio_seconds / max(self.total_seconds, 1e-9)


@dataclasses.dataclass
class SpeechResult:
    """Reference: `SpeechResult` (TTSKit/Models.swift)."""

    audio: np.ndarray
    sample_rate: int = OUTPUT_SAMPLE_RATE
    timings: SpeechTimings = dataclasses.field(default_factory=SpeechTimings)
    text: str = ""

    @property
    def duration_seconds(self) -> float:
        return len(self.audio) / self.sample_rate

    def save(self, path: Union[str, Path]) -> Path:
        return save_audio(self.audio, path, self.sample_rate)


class TextChunker:
    """Sentence-boundary chunking (reference: TextChunker.swift:71)."""

    _SENT = re.compile(r"(?<=[.!?。！？])\s+")

    def chunk(self, text: str, target: int = 200, minimum: int = 40) -> list[str]:
        text = text.strip()
        if len(text) <= target:
            return [text] if text else []
        sentences = self._SENT.split(text)
        chunks: list[str] = []
        cur = ""
        for s in sentences:
            if cur and len(cur) + 1 + len(s) > target:
                chunks.append(cur)
                cur = s
            else:
                cur = f"{cur} {s}".strip()
        if cur:
            if chunks and len(cur) < minimum:
                chunks[-1] = f"{chunks[-1]} {cur}"
            else:
                chunks.append(cur)
        return chunks


# Qwen2's pre-tokenizer split (the `Split` regex of its tokenizer.json)
QWEN2_SPLIT_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+|\s+(?!\S)|\s+"
)
# The same pattern in the stdlib `re`, which has no \p{..}: {L} and {N} stand
# for the code points of unicodedata's categories L* and N*, {W} for Unicode's
# White_Space (the `\s` of `tokenizers`; Python's `\s` adds U+001C-001F).
QWEN2_SPLIT_STDLIB = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n{L}{N}]?[{L}]+|[{N}]| ?[^{W}{L}{N}]+[\r\n]*"
    r"|[{W}]*[\r\n]+|[{W}]+(?![^{W}])|[{W}]+"
)
_WHITE_SPACE = r"\t-\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"


def _category_ranges(major: str) -> str:
    """The code points whose Unicode general category starts with `major`,
    as the ranges of a character class."""
    out, start = [], None
    for cp in range(sys.maxunicode + 2):
        hit = cp <= sys.maxunicode and unicodedata.category(chr(cp))[0] == major
        if hit and start is None:
            start = cp
        elif not hit and start is not None:
            out.append(f"\\U{start:08x}-\\U{cp - 1:08x}")
            start = None
    return "".join(out)


@functools.lru_cache(maxsize=None)
def qwen2_split() -> re.Pattern:
    """Qwen2's split pattern compiled by the stdlib `re` (built once, ~0.3 s)."""
    return re.compile(QWEN2_SPLIT_STDLIB.replace("{L}", _category_ranges("L"))
                      .replace("{N}", _category_ranges("N")).replace("{W}", _WHITE_SPACE))


def qwen2_pieces(text: str) -> list[str]:
    """`text` cut by Qwen2's split with the `Isolated` behaviour of its
    tokenizer.json: the matches and the gaps between them are pieces."""
    pieces: list[str] = []
    pos = 0
    for m in qwen2_split().finditer(text):
        pieces += [p for p in (text[pos:m.start()], m.group()) if p]
        pos = m.end()
    return pieces + ([text[pos:]] if pos < len(text) else [])


def _pre_tokenizer_patterns(node) -> list[str]:
    """The `Split` regexes of a tokenizer.json pre-tokenizer (nested
    `Sequence`s included)."""
    if not isinstance(node, dict):
        return []
    if node.get("type") == "Sequence":
        return [p for sub in node.get("pretokenizers", []) for p in _pre_tokenizer_patterns(sub)]
    if node.get("type") == "Split":
        return [node.get("pattern", {}).get("Regex", "")]
    return []


class HFTTSTokenizer:
    """Qwen's byte-level BPE from a checkpoint's tokenizer.json, on the
    port's own BPETokenizer (the card's machine has no `tokenizers`).

    Reference: TTSTokenizer.swift:10-45 and the vendored Qwen tokenizer.
    As the `tokenizers` library does for this file, the text is split at
    the added tokens (`<|im_start|>`, `<|im_end|>`, ...), each added token
    maps to its id, and every other piece is NFC-normalised (when the file
    names NFC), split with Qwen2's pattern, byte-mapped and merged. Ids at
    or above `vocab_size` are dropped, as in the JAX package."""

    def __init__(self, tokenizer_json: Union[str, Path], vocab_size: int):
        with open(tokenizer_json, encoding="utf-8") as f:
            data = json.load(f)
        model = data["model"]
        if model.get("type", "BPE") != "BPE":
            raise ValueError(f"{tokenizer_json}: model type {model.get('type')!r} is not BPE")
        patterns = _pre_tokenizer_patterns(data.get("pre_tokenizer"))
        if patterns != [QWEN2_SPLIT_PATTERN]:
            raise ValueError(f"{tokenizer_json}: pre-tokenizer split {patterns} is not Qwen2's")
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m) for m in model["merges"]]
        self.bpe = BPETokenizer(model["vocab"], merges)
        self.added = {t["content"]: t["id"] for t in data.get("added_tokens", [])}
        self._added = re.compile("|".join(re.escape(t) for t in sorted(self.added, key=len, reverse=True))) \
            if self.added else None
        normalizer = data.get("normalizer") or {}
        self.nfc = normalizer.get("type") == "NFC"
        if normalizer and not self.nfc:
            raise ValueError(f"{tokenizer_json}: normalizer {normalizer.get('type')!r} is not NFC")
        self.vocab_size = vocab_size

    def _encode_plain(self, text: str) -> list[int]:
        if self.nfc:
            text = unicodedata.normalize("NFC", text)
        return [i for piece in qwen2_pieces(text) for i in self.bpe.encode_chunk(piece)]

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        pos = 0
        for m in self._added.finditer(text) if self._added else ():
            ids += self._encode_plain(text[pos:m.start()])
            ids.append(self.added[m.group()])
            pos = m.end()
        ids += self._encode_plain(text[pos:])
        return [t for t in ids if t < self.vocab_size]


class ByteFallbackTokenizer:
    """Offline text tokenizer: UTF-8 bytes (+reserved control rows).

    Real Qwen BPE loads from a checkpoint's tokenizer.json when present
    (HFTTSTokenizer). Speaker/language control ids are CODEC-track tokens
    resolved by the pipeline, not text tokens."""

    RESERVED = 64  # rows reserved for control tokens

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> list[int]:
        return [self.RESERVED + b for b in text.encode("utf-8") if self.RESERVED + b < self.vocab_size]


class TTSPromptCache:
    """Voice/language/instruction-keyed prefill KV snapshots (reference:
    PromptCache.swift:24-149). `save`/`load` keep the JAX package's npz
    layout (float32 k{i}/v{i} arrays and a pickled `meta` list), so a
    cache written by either package loads in the other; a loaded snapshot
    is bf16, as the JAX package loads it."""

    def __init__(self, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self._cache: dict[tuple, tuple] = {}

    @staticmethod
    def key(voice, language, instruction) -> tuple:
        return (voice or "", language or "", instruction or "")

    def get(self, voice, language, instruction):
        return self._cache.get(self.key(voice, language, instruction))

    def put(self, voice, language, instruction, kv, prompt_len: int) -> None:
        self._cache[self.key(voice, language, instruction)] = (kv, prompt_len)

    def save(self, path: Union[str, Path]) -> None:
        blobs = {}
        meta = []
        for i, (key, (kv, plen)) in enumerate(self._cache.items()):
            blobs[f"k{i}"] = kv[0].float().cpu().numpy()
            blobs[f"v{i}"] = kv[1].float().cpu().numpy()
            meta.append({"key": list(key), "prompt_len": plen})
        np.savez_compressed(Path(path), meta=np.asarray(meta, dtype=object), **blobs)

    def load(self, path: Union[str, Path]) -> None:
        with np.load(path, allow_pickle=True) as data:
            for i, m in enumerate(data["meta"]):
                kv = tuple(torch.from_numpy(data[f"{c}{i}"]).to(self.device, torch.bfloat16) for c in "kv")
                self._cache[tuple(m["key"])] = (kv, int(m["prompt_len"]))


class TTSPipeline:
    """Reference: the `TTSKit` class. Runs on `device` ("cuda" unless the
    caller asks for "cpu"). Random weights (no `params`) are drawn from
    `seed` on the device in bfloat16, as in the JAX package; a float32
    tree comes in through `params`. `quantize` is False, True or "w8a16"
    (W8A16), or "w4a16" (W4A16), applied to the weights it is given."""

    def __init__(
        self,
        dims: Qwen3TTSDims = TINY_TTS_DIMS,
        *,
        params=None,
        tokenizer=None,
        seed: int = 0,
        quantize: Union[bool, str] = False,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.dims = dims
        if params is None:
            g = torch.Generator(device=self.device).manual_seed(seed)
            params = init_tts_params(g, dims, torch.bfloat16, self.device)
        else:
            params = params_to_device(params, self.device)
        if quantize:
            if quantize not in (True, "w8a16", "w4a16"):
                raise ValueError(f"unknown quantization scheme: {quantize!r}")
            from whisperkit_tpu_torch.ops.quant import quantize_tts_params

            params = quantize_tts_params(params, bits=4 if quantize == "w4a16" else 8)
        self.params = params
        self.tokenizer = tokenizer or ByteFallbackTokenizer(dims.text_vocab)
        self.prompt_cache = TTSPromptCache(self.device)
        self.chunker = TextChunker()
        self.timings = SpeechTimings()

    @classmethod
    def from_pretrained(cls, model_folder: Optional[str] = None, **kwargs) -> "TTSPipeline":
        """A Qwen3-TTS HF folder (config.json + *.safetensors, and a
        tokenizer.json when it has one) through models/qwen3_loader.py, or
        a folder with the JAX package's pre-converted `qwen3_tts.npz`
        (models/params_npz.py: numpy leaves only; its dims are the `dims`
        argument, as in the JAX package); without a folder, the random-init
        tiny pipeline, as in the JAX package. A folder with neither raises
        FileNotFoundError, as the port's diarization does (the JAX package
        falls back to random weights)."""
        if model_folder is None:
            return cls(**kwargs)
        folder = Path(model_folder)
        if not ((folder / "config.json").exists() and any(folder.glob("*.safetensors"))):
            if (folder / "qwen3_tts.npz").exists():
                from whisperkit_tpu_torch.models.params_npz import read_params_npz

                tree = read_params_npz(folder / "qwen3_tts.npz")
                return cls(params=params_from_numpy(tree, resolve_device(kwargs.get("device", "cuda"))), **kwargs)
            raise FileNotFoundError(
                f"no TTS checkpoint (config.json + *.safetensors, or qwen3_tts.npz) in {model_folder}")
        from whisperkit_tpu_torch.models.qwen3_loader import load_qwen3_tts

        dims, params = load_qwen3_tts(folder, device=resolve_device(kwargs.get("device", "cuda")))
        tokenizer = None
        if (folder / "tokenizer.json").exists():
            try:
                tokenizer = HFTTSTokenizer(folder / "tokenizer.json", dims.text_vocab)
            except (ValueError, KeyError, OSError) as e:
                logging.error(f"tokenizer.json load failed: {e}")
        return cls(dims, params=params, tokenizer=tokenizer, **kwargs)

    # -- prompt building ----------------------------------------------------
    #
    # The prompt is DUAL-TRACK (Qwen3GenerateTask.swift:683-744
    # `buildCombinedEmbeddings`): every position is a text-track embedding
    # plus a codec-track embedding. Layout per chunk:
    #
    #   [instr tokens]           text: "<|im_start|>user\n{i}<|im_end|>\n"   codec: —
    #   [role tokens]            text: "<|im_start|>assistant\n"             codec: —
    #   [5 control positions]    text: textPAD x5                            codec: think, thinkBos, <lang>, thinkEos, <speaker>
    #   [1 position]             text: textBOS                               codec: codecPAD
    #   [1 variable position]    text: first text token                      codec: codecBOS
    #
    # The remaining text tokens feed ONE PER FRAME during generation
    # (trailing_text). Everything except the variable position is the
    # prompt-cacheable invariant prefix (buildPromptCache :746-790).

    _ROLE_PREFIX = "<|im_start|>assistant\n"

    def _speaker_id(self, voice: Optional[str]) -> int:
        v = (voice or DEFAULT_SPEAKER).lower()
        if v not in SPEAKERS:
            logging.error(f"unknown voice {v!r}; falling back to {DEFAULT_SPEAKER}")
        return SPEAKERS.get(v, SPEAKERS[DEFAULT_SPEAKER])

    def _language_id(self, language: Optional[str]) -> int:
        lang = (language or DEFAULT_TTS_LANGUAGE).lower()
        return TTS_LANGUAGES.get(lang, TTS_LANGUAGES[DEFAULT_TTS_LANGUAGE])

    def _chunk_tracks(self, text: str, options: GenerationOptions) -> tuple[list[int], list[int], list[int], int]:
        """→ (text_track, codec_track with -1 = no codec embed,
        trailing_text, step_cap) for one chunk."""
        d = self.dims
        text_ids = self.tokenizer.encode(text) or [d.text_pad]
        role_ids = self.tokenizer.encode(self._ROLE_PREFIX)
        instr_ids = (
            self.tokenizer.encode(f"<|im_start|>user\n{options.instruction}<|im_end|>\n")
            if options.instruction
            else []
        )
        codec_ids = [
            CODEC_THINK, CODEC_THINK_BOS, self._language_id(options.language),
            CODEC_THINK_EOS, self._speaker_id(options.voice), CODEC_PAD, CODEC_BOS,
        ]
        text_track = instr_ids + role_ids + [d.text_pad] * (len(codec_ids) - 2) + [d.text_bos, text_ids[0]]
        codec_track = [-1] * (len(instr_ids) + len(role_ids)) + codec_ids
        # 8x prompt-size frame budget (Qwen3GenerateTask.swift:358-370)
        step_cap = 8 * (len(role_ids) + len(text_ids))
        return text_track, codec_track, text_ids[1:], step_cap

    def _embed_tracks(self, rows: list[tuple[list[int], list[int]]]) -> tuple[torch.Tensor, torch.Tensor]:
        """Left-pad heterogeneous (text, codec) rows → (embeds [B, P, D],
        pad counts [B]); the loop hides the pads from attention."""
        max_len = max(len(t) for t, _ in rows)
        text = np.full((len(rows), max_len), self.dims.text_pad, np.int64)
        codec = np.full((len(rows), max_len), -1, np.int64)
        pads = np.zeros(len(rows), np.int64)
        for i, (t, c) in enumerate(rows):
            text[i, max_len - len(t):] = t
            codec[i, max_len - len(c):] = c
            pads[i] = max_len - len(t)
        text_t = torch.from_numpy(text).to(self.device)
        codec_t = torch.from_numpy(codec).to(self.device)
        temb = self.params["text_embed"][text_t]
        cemb = torch.where((codec_t >= 0)[:, :, None], self.params["code_embed"][codec_t.clamp_min(0)], 0)
        return temb + cemb, torch.from_numpy(pads).to(self.device)

    def _trailing_array(self, rows: list[list[int]]) -> torch.Tensor:
        """Trailing text tokens padded with textPAD (+1 guaranteed PAD column)."""
        tt = max((len(r) for r in rows), default=0) + 1
        arr = np.full((len(rows), tt), self.dims.text_pad, np.int64)
        for i, r in enumerate(rows):
            arr[i, :len(r)] = r
        return torch.from_numpy(arr).to(self.device)

    def _scalars(self, options: GenerationOptions) -> TTSScalars:
        g = torch.Generator(device=self.device).manual_seed(options.seed)
        return TTSScalars(float(options.temperature), float(options.repetition_penalty), g)

    # -- generation ---------------------------------------------------------

    def generate(self, text: str, options: Optional[GenerationOptions] = None, progress=None) -> SpeechResult:
        """Synthesize `text` → 24 kHz waveform.

        Reference: TTSKit.generate (:760-972) — sentence chunks, ordered
        delivery, equal-power crossfade. The chunks run as ONE batched
        generation (the reference's concurrent tasks become the batch)."""
        options = options or GenerationOptions()
        t_start = time.perf_counter()
        timings = SpeechTimings()
        self.timings = timings

        t0 = time.perf_counter()
        chunks = (
            self.chunker.chunk(text, options.target_chunk_size, options.min_chunk_size)
            if options.chunking_strategy == "sentence"
            else [text]
        )
        if not chunks:
            return SpeechResult(audio=np.zeros(0, np.float32), text=text)

        # prompt-cache hit: the prefix KV is restored instead of re-prefilled
        cached_kv, cached_len = None, 0
        if options.use_prompt_cache:
            hit = self.prompt_cache.get(options.voice, options.language, options.instruction)
            if hit is not None:
                cached_kv, cached_len = hit
        tracks = [self._chunk_tracks(c, options) for c in chunks]
        if cached_len:
            # only the variable position (first text token + codecBOS) prefills
            rows = [(t[-1:], c[-1:]) for t, c, _, _ in tracks]
        else:
            rows = [(t, c) for t, c, _, _ in tracks]
        prompt_embeds, prompt_pad = self._embed_tracks(rows)
        trailing_text = self._trailing_array([tr for _, _, tr, _ in tracks])
        step_cap = torch.tensor([cap for _, _, _, cap in tracks], dtype=torch.int64, device=self.device)
        timings.tokenize_seconds = time.perf_counter() - t0
        timings.chunks = len(chunks)

        t0 = time.perf_counter()
        out = tts_generate_loop(
            self.params, prompt_embeds, self._scalars(options), dims=self.dims,
            max_new_tokens=options.max_new_tokens, top_k=options.top_k,
            cached_kv=cached_kv, cached_len=cached_len, prompt_pad=prompt_pad,
            trailing_text=trailing_text, step_cap=step_cap,
        )
        n_frames = out.n_frames.cpu().numpy()
        timings.generate_seconds = time.perf_counter() - t0
        timings.frames = int(n_frames.sum())
        if progress:
            progress(0.8)

        # vocoder: one batched call over all chunks
        t0 = time.perf_counter()
        waves = speech_decoder_forward(self.params, out.codes, self.dims).float().cpu().numpy()
        timings.vocode_seconds = time.perf_counter() - t0
        # the first audible buffer exists once generation and vocoding end
        timings.time_to_first_buffer = time.perf_counter() - t_start

        # ordered delivery + crossfade (reference :868-941)
        pieces = [waves[i, :int(n_frames[i]) * SAMPLES_PER_FRAME] for i in range(len(chunks))]
        audio = crossfade(pieces, OUTPUT_SAMPLE_RATE, options.crossfade_seconds)
        timings.total_seconds = time.perf_counter() - t_start
        if progress:
            progress(1.0)
        return SpeechResult(audio=audio, timings=timings, text=text)

    # -- prompt cache -------------------------------------------------------

    def build_prompt_cache(self, options: GenerationOptions) -> None:
        """Prefill the invariant prefix (instruction, role and control
        tokens: everything but the variable firstText + codecBOS position)
        once and keep its KV (reference: TTSKit.swift:609-683,
        Qwen3GenerateTask.swift:746-790)."""
        text_track, codec_track, _, _ = self._chunk_tracks("", options)
        embeds, _ = self._embed_tracks([(text_track[:-1], codec_track[:-1])])
        plen = embeds.shape[1]
        kv = tts_prefill(self.params, embeds, dims=self.dims, max_seq=plen)
        self.prompt_cache.put(options.voice, options.language, options.instruction, kv, plen)

    # -- streaming playback -------------------------------------------------

    def play(
        self,
        text: str,
        options: Optional[GenerationOptions] = None,
        strategy: PlaybackStrategy = PlaybackStrategy.AUTO,
        output_path: Optional[Union[str, Path]] = None,
    ) -> SpeechResult:
        """Reference: TTSKit.play (:994-1063). GENERATE_FIRST (and file
        output) synthesize everything up front; the other strategies stream
        through the chunk-scheduled playback engine. Without audio hardware
        the waveform is written to `output_path`."""
        if output_path is not None or strategy == PlaybackStrategy.GENERATE_FIRST:
            result = self.generate(text, options)
            if output_path is not None:
                result.save(output_path)
                return result
            play_audio(result.audio, result.sample_rate)
            return result
        engine, thread = self.play_streaming(text, options, strategy)
        engine.play_blocking()
        thread.join()
        return SpeechResult(
            audio=np.zeros(0, np.float32),  # streamed to the device
            sample_rate=OUTPUT_SAMPLE_RATE,
            text=text,
            timings=self.timings,
        )

    def play_streaming(
        self,
        text: str,
        options: Optional[GenerationOptions] = None,
        strategy: PlaybackStrategy = PlaybackStrategy.AUTO,
        engine=None,
        block_frames: int = 25,
    ):
        """Start streamed synthesis into a StreamingAudioOutput engine in a
        producer thread (reference: AudioOutput.swift:38-700 chunk
        scheduling and TTSKit.swift:994-1063 `.auto` sizing from the first
        measured block). Returns (engine, producer_thread); the caller
        pulls from the engine (a hardware callback or a test sink)."""
        if engine is None:
            engine = StreamingAudioOutput(OUTPUT_SAMPLE_RATE, strategy)

        def produce():
            t0 = time.perf_counter()
            first = True
            try:
                for block in self.stream_blocks(text, options, block_frames):
                    if first:
                        dt = time.perf_counter() - t0
                        n_frames = max(1, len(block) // SAMPLES_PER_FRAME)
                        engine.set_measured_step(dt / n_frames, SAMPLES_PER_FRAME / OUTPUT_SAMPLE_RATE)
                        first = False
                    engine.enqueue(block)
            finally:
                engine.finish()

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        return engine, thread

    def stream_blocks(
        self,
        text: str,
        options: Optional[GenerationOptions] = None,
        block_frames: int = 25,  # 2 s blocks at 12.5 Hz
    ) -> Iterator[np.ndarray]:
        """Block-streaming synthesis: the frame loop runs in resumable
        segments (decoding/tts_loop.tts_generate_segment) and each block is
        vocoded and yielded as soon as its codes exist, so the first buffer
        waits for one prefill and one block, not the utterance (reference:
        the `.stream` PlaybackStrategy, TTSKit.swift:994-1063). The vocoder
        streams through a Code2WavCache, sample for sample the
        whole-utterance decode. The text streams as ONE chunk (batch 1);
        blocks are at least C2W_CONTEXT_FRAMES frames, as in the JAX
        package, where smaller ones would compile a vocoder shape per block."""
        options = options or GenerationOptions()
        block_frames = max(block_frames, C2W_CONTEXT_FRAMES)
        text_track, codec_track, trailing, cap = self._chunk_tracks(text, options)
        embeds, pad = self._embed_tracks([(text_track, codec_track)])
        step_cap = torch.tensor([min(cap, options.max_new_tokens)], dtype=torch.int64, device=self.device)
        # +block_frames headroom: the last segment may overrun max_new_tokens
        max_seq = len(text_track) + options.max_new_tokens + 1 + block_frames
        scalars = self._scalars(options)
        state = tts_prefill_state(
            self.params, embeds, self._trailing_array([trailing]), step_cap, scalars.generator,
            dims=self.dims, max_seq=max_seq, prompt_pad=pad,
        )
        voc_cache = init_code2wav_cache(
            self.dims.c2w, 1, max_frames=options.max_new_tokens + block_frames,
            dtype=self.params["c2w"]["ln_f"].dtype, device=self.device,
        )
        produced = 0
        while produced < options.max_new_tokens:
            n = min(block_frames, options.max_new_tokens - produced)
            codes, state = tts_generate_segment(
                self.params, state, scalars, dims=self.dims, n_frames=block_frames, top_k=options.top_k,
            )
            codes = codes[:, :n]
            valid = int((codes[0, :, 0] != CODEC_EOS).sum())
            if valid == 0:
                break
            wave, voc_cache = code2wav_decode_block(
                self.params["c2w"], codes[:, :valid], voc_cache, self.dims.c2w,
                ctx_frames=min(produced, C2W_CONTEXT_FRAMES),
            )
            yield wave[0].float().cpu().numpy()
            produced += valid
            if bool(state.done.all()) or valid < n:
                break


# Variant presets (reference: Qwen3Config.swift:25-83 — 0.6b on every
# platform, 1.7b with instruction support).
TTS_VARIANTS: dict[str, Qwen3TTSDims] = {
    "0.6b": Qwen3TTSDims(),
    "1.7b": Qwen3TTSDims(d_model=2048, n_layer=28, n_head=16, n_kv_head=8, d_ff=6144),
    "tiny-test": TINY_TTS_DIMS,
}
