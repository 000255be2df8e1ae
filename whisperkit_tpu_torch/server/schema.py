"""OpenAI Audio API schema models (the port's counterpart of
whisperkit_tpu/server/schema.py, on dataclasses instead of pydantic).

Reference: the reference generates Swift types from
scripts/specs/localserver_openapi.yaml via swift-openapi-generator
(Makefile:204-219, Server/GeneratedSources ~1,864 LoC). The same models,
fields and defaults as the JAX package's; each has `validate(payload)`,
which builds the model from a decoded JSON object and raises SchemaError
on a missing field, a mistyped field or a value outside its literal set.
Used to validate server responses and importable by clients.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Literal, Optional


class SchemaError(ValueError):
    """A payload does not match its model."""


def _check(value, tp, where: str):
    """`value` (decoded JSON) as the annotation `tp`, or SchemaError."""
    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if origin is typing.Union:  # Optional[X]
        if value is None and type(None) in args:
            return None
        (inner,) = [a for a in args if a is not type(None)]
        return _check(value, inner, where)
    if origin is Literal:
        if value not in args:
            raise SchemaError(f"{where}: {value!r} is not one of {list(args)}")
        return value
    if origin is list:
        if not isinstance(value, list):
            raise SchemaError(f"{where}: expected a list, got {type(value).__name__}")
        return [_check(v, args[0], f"{where}[{i}]") for i, v in enumerate(value)]
    if dataclasses.is_dataclass(tp):
        return tp.validate(value)
    if tp is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SchemaError(f"{where}: expected a number, got {value!r}")
        return float(value)
    if tp is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise SchemaError(f"{where}: expected an integer, got {value!r}")
        return value
    if tp in (str, bool):
        if not isinstance(value, tp):
            raise SchemaError(f"{where}: expected {tp.__name__}, got {value!r}")
        return value
    raise TypeError(f"{where}: no check for annotation {tp!r}")


class _Model:
    @classmethod
    def validate(cls, payload: dict):
        """Build the model from `payload`; SchemaError if it does not fit."""
        if not isinstance(payload, dict):
            raise SchemaError(f"{cls.__name__}: expected an object, got {type(payload).__name__}")
        hints = typing.get_type_hints(cls)
        values = {}
        for f in dataclasses.fields(cls):
            where = f"{cls.__name__}.{f.name}"
            if f.name in payload:
                values[f.name] = _check(payload[f.name], hints[f.name], where)
            elif f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
                raise SchemaError(f"{where}: missing")
        return cls(**values)


@dataclasses.dataclass
class TranscriptionRequestFields(_Model):
    """Multipart form fields of POST /v1/audio/transcriptions."""

    model: Optional[str] = None
    language: Optional[str] = None
    prompt: Optional[str] = None
    temperature: float = 0.0
    response_format: Literal["json", "text", "srt", "vtt", "verbose_json"] = "json"
    stream: bool = False
    timestamp_granularities: list[Literal["word", "segment"]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TranscriptionSegmentModel(_Model):
    id: int
    seek: int
    start: float
    end: float
    text: str
    tokens: list[int]
    temperature: float
    avg_logprob: float
    compression_ratio: float
    no_speech_prob: float


@dataclasses.dataclass
class TranscriptionWordModel(_Model):
    word: str
    start: float
    end: float


@dataclasses.dataclass
class TranscriptionResponse(_Model):
    """response_format=json."""

    text: str


@dataclasses.dataclass
class VerboseTranscriptionResponse(_Model):
    """response_format=verbose_json."""

    task: str
    language: str
    duration: float
    text: str
    segments: list[TranscriptionSegmentModel]
    words: Optional[list[TranscriptionWordModel]] = None


@dataclasses.dataclass
class StreamDeltaEvent(_Model):
    type: Literal["transcript.text.delta"]
    delta: str


@dataclasses.dataclass
class StreamDoneEvent(_Model):
    type: Literal["transcript.text.done"]
    text: str


@dataclasses.dataclass
class ErrorBody(_Model):
    message: str


@dataclasses.dataclass
class ErrorResponse(_Model):
    error: ErrorBody


@dataclasses.dataclass
class HealthResponse(_Model):
    status: str
    model_state: str
    batches_run: Optional[int] = None
    jobs_run: Optional[int] = None
