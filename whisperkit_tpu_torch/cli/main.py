"""The port's command line: transcribe / diarize / tts / serve (port of
whisperkit_tpu/cli/main.py).

    python -m whisperkit_tpu_torch.cli transcribe --model-folder FOLDER --audio-path a.wav
    python -m whisperkit_tpu_torch.cli transcribe --model-folder FOLDER --audio-path a.wav --diarization
    python -m whisperkit_tpu_torch.cli transcribe --model-folder FOLDER --audio-path a.wav --stream-simulated
    python -m whisperkit_tpu_torch.cli diarize --model-folder PYANNOTE_FOLDER --audio-path a.wav --rttm-path a.rttm
    python -m whisperkit_tpu_torch.cli tts --model-folder QWEN3_TTS_FOLDER --text "Hello." --output-path x.wav
    python -m whisperkit_tpu_torch.cli serve --model-folder FOLDER --port 50060

Reference: Sources/ArgmaxCLI/ArgmaxCLI.swift:9-26 (subcommand root),
TranscribeCLI.swift / DiarizeCLI.swift / TTSCLI.swift / ServeCLI.swift. The parser is the
JAX package's, flag for flag (the reference's argument structs, snake-case
→ --kebab-case, TranscribeCLIArguments.swift:6-111), plus `--device
{cuda,cpu}` (default cuda), which takes the place of JAX_PLATFORMS. With
`--device cuda` a child process first checks that the card initialises
(core/device_probe.py); a failure exits 1 and never falls back to the CPU.

`--stream` needs a capture backend (audio/capture.py: sounddevice); without
one it exits 2, as the JAX CLI does; so does `tts --quantization w8a8`, a
Whisper-encoder recipe, with the JAX CLI's message. `transcribe
--profile-dir D` writes a `torch.profiler` trace of the whole batch, host
and card, under D (core/signposts.py); with `--stream` or
`--stream-simulated` it exits 2, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from whisperkit_tpu_torch.core.errors import DeviceUnavailable


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default=None, help="model name (tiny ... large-v3)")
    p.add_argument("--model-repo", default=None, help="HF repo to resolve the model from")
    p.add_argument("--model-folder", default=None, help="local checkpoint folder")
    p.add_argument("--tokenizer-folder", default=None)
    p.add_argument("--download", action="store_true", default=True)
    p.add_argument("--no-download", dest="download", action="store_false")
    p.add_argument("--prewarm", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument(
        "--draft-model-folder", default=None,
        help="local checkpoint of a vocab-sharing draft model (e.g. turbo "
        "for large-v3): batch-1 greedy decodes run lossless speculative "
        "decoding (decoding/speculative.py)",
    )
    p.add_argument(
        "--quantization", choices=["w8a16", "w8a8", "w4a16"], default=None,
        help="quantize linear weights at load (the reference ships these "
        "as separate compressed model folders, fastlane/Fastfile:26-55; "
        "here any checkpoint quantizes on the fly — w4a16 is the analog "
        "of the 4-bit palettized variants; w8a8 = w8a16 weights plus "
        "int8-activation ENCODER matmuls, transcribe/serve only)",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the model runs: the CUDA card (default) or, when asked "
        "for, the host CPU; there is no silent fallback from one to the other",
    )
    p.add_argument(
        "--device-probe-timeout", type=float, default=90.0,
        help="with --device cuda, fail fast if the card does not initialize "
        "and run one op within this many seconds (0 disables the probe; "
        "core/device_probe.py)",
    )


def _add_decoding_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--task", choices=["transcribe", "translate"], default="transcribe")
    p.add_argument("--language", default=None)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--temperature-increment-on-fallback", type=float, default=0.2)
    p.add_argument("--temperature-fallback-count", type=int, default=5)
    p.add_argument("--best-of", dest="top_k", type=int, default=5)
    p.add_argument("--beam-size", type=int, default=1)
    p.add_argument("--sample-length", type=int, default=224)
    p.add_argument("--skip-special-tokens", action="store_true")
    p.add_argument("--without-timestamps", action="store_true")
    p.add_argument("--word-timestamps", action="store_true")
    p.add_argument("--detect-language", action="store_true")
    p.add_argument("--max-initial-timestamp", type=float, default=1.0)
    p.add_argument("--clip-timestamps", type=float, nargs="*", default=[])
    p.add_argument("--prompt", default=None, help="text prompt to condition on")
    p.add_argument("--prefix", default=None, help="text prefix to force-decode")
    p.add_argument("--suppress-blank", action="store_true")
    p.add_argument("--compression-ratio-threshold", type=float, default=2.4)
    p.add_argument("--logprob-threshold", type=float, default=-1.0)
    p.add_argument("--no-speech-threshold", type=float, default=0.6)
    p.add_argument("--chunking-strategy", choices=["none", "vad"], default="none")
    p.add_argument("--concurrent-worker-count", type=int, default=16)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="whisperkit-tpu-torch", description="speech toolkit (PyTorch/CUDA port)"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    t = sub.add_parser("transcribe", help="speech-to-text")
    _add_model_args(t)
    _add_decoding_args(t)
    t.add_argument("--audio-path", nargs="+", required=False, default=[])
    t.add_argument("--audio-folder", default=None)
    t.add_argument("--stream", action="store_true",
                   help="live microphone transcription (needs PortAudio)")
    t.add_argument("--stream-simulated", action="store_true",
                   help="replay the file as a live stream with eager word confirmation")
    t.add_argument("--report", action="store_true", help="write report files")
    t.add_argument("--report-path", default=".", help="report output dir")
    t.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler trace (host and card) of the whole "
        "run to this directory",
    )
    t.add_argument("--report-format", nargs="*", default=["json"],
                   choices=["json", "srt", "vtt", "txt"])
    t.add_argument("--diarization", action="store_true",
                   help="run speaker diarization and merge speaker labels")

    d = sub.add_parser("diarize", help="speaker diarization")
    _add_model_args(d)
    d.add_argument("--audio-path", required=True)
    d.add_argument("--num-speakers", type=int, default=None)
    d.add_argument("--cluster-distance-threshold", type=float, default=None)
    d.add_argument("--rttm-path", default=None, help="write RTTM to this path")

    s = sub.add_parser("tts", help="text-to-speech")
    _add_model_args(s)
    s.add_argument("--text", required=True)
    s.add_argument("--voice", default=None)
    s.add_argument("--tts-language", default="english")
    s.add_argument("--instruction", default=None)
    s.add_argument("--output-path", default="speech.wav")
    s.add_argument("--temperature", type=float, default=0.9)
    s.add_argument("--top-k", type=int, default=50)
    s.add_argument("--repetition-penalty", type=float, default=1.05)
    s.add_argument("--max-new-tokens", type=int, default=245)
    s.add_argument("--seed", type=int, default=0)

    v = sub.add_parser("serve", help="OpenAI-compatible local server")
    _add_model_args(v)
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=50060)

    return parser


def _decode_options(args, tokenizer=None):
    from whisperkit_tpu_torch.core.configurations import DecodingOptions

    prompt_tokens = None
    prefix_tokens = None
    if tokenizer is not None:
        if args.prompt:
            prompt_tokens = tokenizer.encode(" " + args.prompt.strip())
        if args.prefix:
            prefix_tokens = tokenizer.encode(" " + args.prefix.strip())
    return DecodingOptions(
        task=args.task,
        language=args.language,
        temperature=args.temperature,
        temperature_increment_on_fallback=args.temperature_increment_on_fallback,
        temperature_fallback_count=args.temperature_fallback_count,
        top_k=args.top_k,
        beam_size=args.beam_size,
        sample_length=args.sample_length,
        skip_special_tokens=args.skip_special_tokens,
        without_timestamps=args.without_timestamps,
        word_timestamps=args.word_timestamps or args.stream_simulated,
        detect_language=args.detect_language,
        max_initial_timestamp=args.max_initial_timestamp,
        clip_timestamps=args.clip_timestamps,
        prompt_tokens=prompt_tokens,
        prefix_tokens=prefix_tokens,
        suppress_blank=args.suppress_blank,
        compression_ratio_threshold=args.compression_ratio_threshold,
        logprob_threshold=args.logprob_threshold,
        no_speech_threshold=args.no_speech_threshold,
        chunking_strategy=args.chunking_strategy,
        concurrent_worker_count=args.concurrent_worker_count,
    )


def _probe_device_or_raise(args) -> None:
    """With --device cuda, check in a child process that the card
    initialises and runs one op (core/device_probe.py); raises
    DeviceUnavailable. Skipped for --device cpu and a timeout of 0."""
    timeout = getattr(args, "device_probe_timeout", 0)
    if getattr(args, "device", "cuda") != "cuda" or not timeout or timeout <= 0:
        return
    from whisperkit_tpu_torch.core.device_probe import probe_backend

    probe_backend(timeout)


def _build_pipeline(args):
    from whisperkit_tpu_torch.core.configurations import ComputeOptions, WhisperConfig
    from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline

    _probe_device_or_raise(args)
    device = getattr(args, "device", "cuda")
    config = WhisperConfig(
        model=args.model,
        model_repo=args.model_repo,
        model_folder=args.model_folder,
        tokenizer_folder=args.tokenizer_folder,
        download=args.download,
        prewarm=args.prewarm,
        verbose=args.verbose,
        compute_options=ComputeOptions(quantization=getattr(args, "quantization", None)),
    )
    draft_dims = draft_params = None
    if getattr(args, "draft_model_folder", None):
        from whisperkit_tpu_torch.models.loader import load_whisper

        draft_dims, draft_params, _ = load_whisper(args.draft_model_folder, device=device)
    return WhisperPipeline(config, draft_dims=draft_dims, draft_params=draft_params, device=device)


def cmd_transcribe(args) -> int:
    if args.profile_dir and (args.stream or args.stream_simulated):
        # streaming runs are open-ended; a "trace the whole run" flag would
        # silently produce nothing (the stream paths return early)
        print("--profile-dir is not supported with --stream/--stream-simulated", file=sys.stderr)
        return 2
    paths = [Path(p) for p in args.audio_path]
    if args.audio_folder:
        folder = Path(args.audio_folder)
        paths.extend(
            sorted(
                p for p in folder.iterdir()
                if p.suffix.lower() in {".wav", ".flac", ".mp3", ".m4a", ".ogg"}
            )
        )
    if args.stream:  # live mic needs no file inputs
        from whisperkit_tpu_torch.audio.capture import capture_available

        # checked before the model loads (the JAX CLI loads it first)
        if not capture_available():
            print("no microphone backend (sounddevice) on this host", file=sys.stderr)
            return 2
        pipe = _build_pipeline(args)
        return _stream_live(pipe, _decode_options(args, pipe.tokenizer))
    if not paths:
        print("no audio inputs (use --audio-path / --audio-folder)", file=sys.stderr)
        return 2

    pipe = _build_pipeline(args)
    options = _decode_options(args, pipe.tokenizer)
    if args.stream_simulated:
        return _stream_simulated(pipe, paths[0], options)
    if args.profile_dir:
        # a trace around the whole batch (core/signposts.py); the process
        # ends after it, so the profiler's dearer launches cost nothing
        from whisperkit_tpu_torch.core.signposts import start_trace, stop_trace

        start_trace(args.profile_dir)
        try:
            return _transcribe_paths(pipe, paths, options, args)
        finally:
            print(f"-- profiler trace written to {stop_trace()}", file=sys.stderr)
    return _transcribe_paths(pipe, paths, options, args)


def _transcribe_paths(pipe, paths, options, args) -> int:
    from whisperkit_tpu_torch.text.transcription_utils import format_segments
    from whisperkit_tpu_torch.text.writers import make_writer

    rc = 0
    for path in paths:
        t0 = time.perf_counter()
        try:
            result = pipe.transcribe(path, options)
        except Exception as e:  # one bad file must not abort the batch
            print(f"{path}: ERROR {e}", file=sys.stderr)
            rc = 1
            continue
        if args.diarization:
            result = _run_diarization(path, result, args)
        for line in format_segments(result.segments):
            print(line)
        dt = time.perf_counter() - t0
        print(
            f"-- {path.name}: {result.timings.input_audio_seconds:.1f}s audio in "
            f"{dt:.2f}s (RTF {result.timings.real_time_factor:.3f})",
            file=sys.stderr,
        )
        if args.verbose:
            # full stage-timing report (reference: logTimings,
            # Models.swift:478-539)
            result.timings.log()
        if args.report:
            for fmt in args.report_format:
                out = make_writer(fmt, args.report_path).write(result, path.stem)
                print(f"   wrote {out}", file=sys.stderr)
    return rc


def _run_diarization(path: Path, result, args):
    """Combined transcribe + diarize (reference: TranscribeCLI.runDiarization,
    TranscribeCLI.swift:430): each segment is labelled with the speaker of
    its largest overlap. The speaker models come from `--model-folder` when
    it holds pyannote checkpoints; a Whisper folder holds none, and then the
    random-init conv models run, as in the JAX CLI."""
    from whisperkit_tpu_torch.pipelines.diarize import DiarizePipeline, find_pyannote_checkpoints
    from whisperkit_tpu_torch.speaker.results import SpeakerMergeStrategy

    folder = args.model_folder
    if folder and find_pyannote_checkpoints(folder):
        pipe = DiarizePipeline.from_pretrained(folder, device=args.device)
    else:
        print(f"no pyannote checkpoints in {folder}: diarizing with the random-init conv models", file=sys.stderr)
        pipe = DiarizePipeline(device=args.device)
    merged = pipe.diarize(path).add_speaker_info(result, SpeakerMergeStrategy.SEGMENT)
    for seg in merged.segments:
        if seg.speaker:
            seg.text = f"[{seg.speaker}]{seg.text}"
    return merged


def _stream_live(pipe, options) -> int:
    """Live mic transcription (reference: TranscribeCLI --stream)."""
    from whisperkit_tpu_torch.audio.capture import MicrophoneSource
    from whisperkit_tpu_torch.pipelines.streaming import AudioStreamTranscriber

    source = MicrophoneSource()
    st = AudioStreamTranscriber(pipe, options)
    try:
        for state in st.stream(source):
            confirmed = "".join(s.text for s in state.confirmed_segments)
            pending = "".join(s.text for s in state.unconfirmed_segments)
            print(f"\r{confirmed}\033[90m{pending}\033[0m", end="", flush=True)
    except KeyboardInterrupt:
        source.stop()
    print()
    return 0


def _stream_simulated(pipe, path: Path, options) -> int:
    """Eager streaming replay of a file in 1 s slices (reference:
    TranscribeCLI.swift:322-430); the last line is the confirmed text."""
    from whisperkit_tpu_torch.audio.io import load_audio
    from whisperkit_tpu_torch.pipelines.streaming import AudioStreamTranscriber, simulate_stream

    audio = load_audio(path)
    st = AudioStreamTranscriber(pipe, options, eager=True, use_vad=False)
    for state in st.stream(simulate_stream(audio, chunk_seconds=1.0)):
        confirmed = "".join(w.word for w in state.confirmed_words)
        hypothesis = "".join(w.word for w in state.hypothesis_words)
        print(f"\r{confirmed}\033[90m{hypothesis}\033[0m", end="", flush=True)
    print()
    print(st.confirmed_text or st.state.current_text)
    return 0


def cmd_diarize(args) -> int:
    from whisperkit_tpu_torch.pipelines.diarize import DiarizationOptions, DiarizePipeline

    _probe_device_or_raise(args)
    # --quantization maps onto the pyannote variant matrix (w8a16 is the
    # quantized speaker recipe; the reference matrix has no 4-bit speaker
    # models either, PyannoteConfig.swift:11-41)
    variant = args.quantization or "w32a32"
    if variant not in DiarizePipeline.VARIANTS:
        print(
            f"--quantization {variant} is not available for diarization "
            f"(choices: {', '.join(DiarizePipeline.VARIANTS)})",
            file=sys.stderr,
        )
        return 2
    pipe = DiarizePipeline.from_pretrained(model_folder=args.model_folder, variant=variant, device=args.device)
    result = pipe.diarize(
        args.audio_path,
        DiarizationOptions(
            number_of_speakers=args.num_speakers,
            cluster_distance_threshold=args.cluster_distance_threshold,
        ),
    )
    for seg in result.segments:
        print(f"[{seg.start:8.2f} --> {seg.end:8.2f}] SPEAKER_{seg.speaker_id:02d}")
    if args.rttm_path:
        Path(args.rttm_path).write_text(result.to_rttm(), encoding="utf-8")
        print(f"wrote {args.rttm_path}", file=sys.stderr)
    return 0


def cmd_tts(args) -> int:
    from whisperkit_tpu_torch.pipelines.tts import GenerationOptions, TTSPipeline

    _probe_device_or_raise(args)
    # w8a8's int8 activations are a Whisper-encoder recipe; TTS takes
    # w8a16 and w4a16
    if args.quantization == "w8a8":
        print("--quantization w8a8 is not available for tts (choices: w8a16, w4a16)", file=sys.stderr)
        return 2
    pipe = TTSPipeline.from_pretrained(
        model_folder=args.model_folder, quantize=args.quantization or False, device=args.device,
    )
    result = pipe.generate(
        args.text,
        GenerationOptions(
            voice=args.voice,
            language=args.tts_language,
            instruction=args.instruction,
            temperature=args.temperature,
            top_k=args.top_k,
            repetition_penalty=args.repetition_penalty,
            max_new_tokens=args.max_new_tokens,
            seed=args.seed,
        ),
    )
    result.save(args.output_path)
    print(f"wrote {args.output_path} ({result.duration_seconds:.2f}s audio)", file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    from whisperkit_tpu_torch.server.openai_api import serve

    pipe = _build_pipeline(args)
    serve(pipe, host=args.host, port=args.port)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    handlers = {
        "transcribe": cmd_transcribe,
        "diarize": cmd_diarize,
        "tts": cmd_tts,
        "serve": cmd_serve,
    }
    try:
        return handlers[args.command](args)
    except DeviceUnavailable as e:
        print(f"device probe failed: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
