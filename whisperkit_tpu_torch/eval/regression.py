"""Regression / benchmark harness (port of whisperkit_tpu/eval/regression.py).

Reference: Tests/WhisperKitTests/RegressionTests.swift (:80-296) +
RegressionTestUtils.swift (:84-400): env-driven model matrix, per-file
pipeline runs measuring tokens/sec (live callback window), memory pre/post,
a TPS floor assert (>4 tok/s → "potential CPU fallback"), WER vs reference
transcripts, and a JSON stats attachment.

Dataset layout expected here: a folder of audio files with sibling `.txt`
reference transcripts (same stem) — the offline equivalent of the
reference's HF `whisperkit-test-data` datasets. Fault-injection model names
`crash_test` / `unknown_model` are honored like the reference's debug
matrix (Fastfile:59, RegressionTests.swift:92-94).

`main` runs the port's pipeline on `--device` (default cuda; a host
without a card fails, it never falls back to the CPU).
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional

from whisperkit_tpu_torch.core.configurations import DecodingOptions
from whisperkit_tpu_torch.core.logging import logging
from whisperkit_tpu_torch.eval.wer import evaluate

TPS_FLOOR = 4.0  # RegressionTests.swift:270-274


class CrashTestError(RuntimeError):
    """Raised by the `crash_test` fault-injection model name."""


def _resident_memory_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


@dataclasses.dataclass
class RegressionStats:
    """Per-file stats record (reference: RegressionStats JSON attachment)."""

    file: str
    model: str
    wer: Optional[float]
    tokens_per_second: float
    real_time_factor: float
    speed_factor: float
    time_to_first_token: float
    input_audio_seconds: float
    full_pipeline_seconds: float
    memory_pre_mb: float
    memory_post_mb: float
    windows: int
    fallbacks: int
    passed_tps_floor: bool

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


DATASET_REPO = "argmaxinc/whisperkit-test-data"  # RegressionTests.swift:34
KNOWN_DATASETS = ("librispeech-10mins", "earnings22-10mins")


def resolve_dataset(name_or_dir: str | Path) -> Path:
    """Resolve a dataset argument to a local folder.

    A path that exists is used as-is (the offline folder-of-audio+txt
    layout). Otherwise the argument is treated as one of the reference's
    benchmark dataset names and resolved from the HF dataset repo
    `argmaxinc/whisperkit-test-data` (RegressionTests.swift:460-483) with
    the registry's offline-first discipline: local HF cache first, network
    only if available. Without `huggingface_hub` (the card's machine has
    none) a name that is not a folder raises the same FileNotFoundError.
    """
    p = Path(name_or_dir)
    if p.exists():
        return p
    last_err: Optional[Exception] = None
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        last_err = e
    else:
        for local_only in (True, False):
            try:
                root = snapshot_download(
                    DATASET_REPO,
                    repo_type="dataset",
                    allow_patterns=[f"{name_or_dir}/*"],
                    local_files_only=local_only,
                )
                folder = Path(root) / str(name_or_dir)
                if folder.exists():
                    return folder
            except Exception as e:  # cache miss, then (in this env) no egress
                last_err = e
    raise FileNotFoundError(
        f"dataset '{name_or_dir}' is neither a local folder nor cached from "
        f"{DATASET_REPO} (known names: {KNOWN_DATASETS}); in a zero-egress "
        f"environment, pre-place the folder or the HF cache — see "
        f"docs/WER_RUNBOOK.md"
    ) from last_err


def _metadata_transcripts(dataset_dir: Path) -> dict[str, str]:
    """Reference metadata format: one .json in the dataset folder, a list
    of items mapping an audio filename to its transcript
    (RegressionTests.swift:485-510 `getTranscript`)."""
    out: dict[str, str] = {}
    for meta in sorted(dataset_dir.glob("*.json")):
        try:
            items = json.loads(meta.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(items, list):
            continue
        for item in items:
            if not isinstance(item, dict):
                continue
            name = item.get("audio") or item.get("file") or item.get("filename")
            text = item.get("text") or item.get("transcript")
            if isinstance(name, str) and isinstance(text, str):
                out[Path(name).name] = text
    return out


def run_regression(
    pipeline,
    dataset_dir: Path | str,
    *,
    model_name: str = "",
    options: Optional[DecodingOptions] = None,
    max_files: Optional[int] = None,
    out_path: Optional[Path | str] = None,
) -> list[RegressionStats]:
    """Run the pipeline over a dataset folder, computing WER + perf stats."""
    model_name = model_name or os.environ.get("MODEL_NAME", "unknown")
    if model_name == "crash_test":
        raise CrashTestError("fault injection: crash_test model requested")
    if model_name == "unknown_model":
        raise ValueError("fault injection: unknown_model is not a valid model")

    dataset_dir = resolve_dataset(dataset_dir)
    audio_exts = {".wav", ".flac", ".mp3", ".m4a", ".ogg"}
    files = sorted(p for p in dataset_dir.iterdir() if p.suffix.lower() in audio_exts)
    if max_files:
        files = files[:max_files]
    options = options or DecodingOptions()
    meta_transcripts = _metadata_transcripts(dataset_dir)

    stats: list[RegressionStats] = []
    for path in files:
        mem_pre = _resident_memory_mb()
        result = pipeline.transcribe(path, options)
        mem_post = _resident_memory_mb()
        t = result.timings

        # ground truth: sibling .txt (offline layout) or the reference's
        # metadata-json mapping (HF whisperkit-test-data layout)
        ref_path = path.with_suffix(".txt")
        wer_val = None
        if ref_path.exists():
            wer_val = evaluate(ref_path.read_text(), result.text).wer
        elif path.name in meta_transcripts:
            wer_val = evaluate(meta_transcripts[path.name], result.text).wer

        tps = t.tokens_per_second
        rec = RegressionStats(
            file=path.name,
            model=model_name,
            wer=wer_val,
            tokens_per_second=tps,
            real_time_factor=t.real_time_factor,
            speed_factor=t.speed_factor,
            time_to_first_token=t.time_to_first_token,
            input_audio_seconds=t.input_audio_seconds,
            full_pipeline_seconds=t.full_pipeline,
            memory_pre_mb=mem_pre,
            memory_post_mb=mem_post,
            windows=int(t.total_decoding_windows),
            fallbacks=int(t.total_decoding_fallbacks),
            passed_tps_floor=tps > TPS_FLOOR,
        )
        if not rec.passed_tps_floor:
            logging.error(
                f"{path.name}: {tps:.1f} tok/s <= {TPS_FLOOR} — potential slow-path fallback"
            )
        stats.append(rec)

    if out_path:
        Path(out_path).write_text(
            "\n".join(s.to_json() for s in stats) + "\n", encoding="utf-8"
        )
    return stats


def main(argv=None) -> int:
    """CLI: local checkpoint + local dataset folder → WER/perf stats.

    python -m whisperkit_tpu_torch.eval.regression <model_folder> <dataset>
        [--out stats.jsonl] [--language en] [--max-files N]
        [--chunking none|vad] [--device cuda|cpu]

    <dataset> is either a local folder of audio files (sibling same-stem
    `.txt` transcripts, or a reference-style metadata .json) or one of the
    reference's benchmark dataset names (librispeech-10mins /
    earnings22-10mins), resolved offline-first from the HF dataset repo
    (RegressionTests.swift:33-38). The
    model folder is an HF-format Whisper checkpoint (config.json +
    model.safetensors + tokenizer files) placed locally — the shipped-
    weights story for zero-egress deployments (docs/PARITY.md).
    """
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("model_folder")
    ap.add_argument("dataset_dir")
    ap.add_argument("--out", default=None)
    ap.add_argument("--language", default=None)
    ap.add_argument("--max-files", type=int, default=None)
    ap.add_argument("--chunking", default="vad", choices=["none", "vad"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from whisperkit_tpu_torch.core.configurations import WhisperConfig
    from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline

    pipe = WhisperPipeline(WhisperConfig(model_folder=args.model_folder), device=args.device)
    stats = run_regression(
        pipe,
        args.dataset_dir,
        model_name=Path(args.model_folder).name,
        options=DecodingOptions(
            language=args.language, chunking_strategy=args.chunking
        ),
        max_files=args.max_files,
        out_path=args.out,
    )
    wers = [s.wer for s in stats if s.wer is not None]
    summary = {
        "files": len(stats),
        "avg_wer": sum(wers) / len(wers) if wers else None,
        "avg_tps": sum(s.tokens_per_second for s in stats) / max(len(stats), 1),
        "all_passed_tps_floor": all(s.passed_tps_floor for s in stats),
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
