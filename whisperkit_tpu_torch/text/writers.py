"""Result writers: JSON / SRT / VTT (word-level when available); the port's
copy of whisperkit_tpu/text/writers.py.

Reference: Sources/WhisperKit/Utilities/ResultWriter.swift:40-134
(`WriteJSON`, `WriteSRT`, `WriteVTT`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Union

from whisperkit_tpu_torch.core.results import TranscriptionResult, TranscriptionSegment


def _fmt_timestamp(seconds: float, decimal_marker: str) -> str:
    ms = max(0, int(round(seconds * 1000)))
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{decimal_marker}{ms:03d}"


def _cues(result: TranscriptionResult):
    """Yield (start, end, text) cues — word-level when word timings exist."""
    for segment in result.segments:
        if segment.words:
            for w in segment.words:
                yield w.start, w.end, w.word.strip()
        else:
            yield segment.start, segment.end, segment.text.strip()


class ResultWriter:
    extension = ""

    def __init__(self, output_dir: Union[str, Path] = "."):
        self.output_dir = Path(output_dir)

    def format(self, result: TranscriptionResult) -> str:
        raise NotImplementedError

    def write(self, result: TranscriptionResult, base_name: str) -> Path:
        self.output_dir.mkdir(parents=True, exist_ok=True)
        out = self.output_dir / f"{base_name}.{self.extension}"
        out.write_text(self.format(result), encoding="utf-8")
        return out


class WriteJSON(ResultWriter):
    extension = "json"

    def format(self, result: TranscriptionResult) -> str:
        def seg_dict(s: TranscriptionSegment) -> dict:
            d = {
                "id": s.id,
                "seek": s.seek,
                "start": s.start,
                "end": s.end,
                "text": s.text,
                "tokens": s.tokens,
                "temperature": s.temperature,
                "avgLogprob": s.avg_logprob,
                "compressionRatio": s.compression_ratio,
                "noSpeechProb": s.no_speech_prob,
            }
            if s.language is not None:
                # per-window detected language (varies within one result
                # on code-switched audio with detect_language=True)
                d["language"] = s.language
            if s.words:
                d["words"] = [
                    {
                        "word": w.word,
                        "start": w.start,
                        "end": w.end,
                        "probability": w.probability,
                        "tokens": w.tokens,
                    }
                    for w in s.words
                ]
            return d

        return json.dumps(
            {
                "text": result.text,
                "language": result.language,
                "segments": [seg_dict(s) for s in result.segments],
            },
            ensure_ascii=False,
            indent=2,
        )


class WriteSRT(ResultWriter):
    extension = "srt"

    def format(self, result: TranscriptionResult) -> str:
        lines = []
        for i, (start, end, text) in enumerate(_cues(result), start=1):
            lines.append(str(i))
            lines.append(
                f"{_fmt_timestamp(start, ',')} --> {_fmt_timestamp(end, ',')}"
            )
            lines.append(text)
            lines.append("")
        return "\n".join(lines)


class WriteVTT(ResultWriter):
    extension = "vtt"

    def format(self, result: TranscriptionResult) -> str:
        lines = ["WEBVTT", ""]
        for start, end, text in _cues(result):
            lines.append(
                f"{_fmt_timestamp(start, '.')} --> {_fmt_timestamp(end, '.')}"
            )
            lines.append(text)
            lines.append("")
        return "\n".join(lines)


class WriteTXT(ResultWriter):
    extension = "txt"

    def format(self, result: TranscriptionResult) -> str:
        return result.text + "\n"


WRITERS = {
    "json": WriteJSON,
    "srt": WriteSRT,
    "vtt": WriteVTT,
    "txt": WriteTXT,
}


def make_writer(fmt: str, output_dir: Union[str, Path] = ".") -> ResultWriter:
    try:
        return WRITERS[fmt](output_dir)
    except KeyError:
        raise ValueError(f"unknown report format {fmt!r} (choose from {sorted(WRITERS)})")
