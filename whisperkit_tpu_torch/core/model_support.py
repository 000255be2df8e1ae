"""Device → model support matrix with remote-config merge (the port's copy
of whisperkit_tpu/core/model_support.py).

Reference: Sources/WhisperKit/Core/Models.swift:156-260
(`ModelSupportConfig` / `DeviceSupport`, merged with a remote `config.json`
fetched from the model repo, hardcoded fallback matrix :1465-1662). The
reference keys on Apple device identifiers; the JAX package's keys are
TPU/host platforms, and the remote config is any local/downloaded
`config.json` with the same schema. The matrix is the JAX package's, row
for row; a card's identifier (its lower-cased, dash-joined CUDA device
name) matches no row and takes the first, as any unknown identifier does.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional


@dataclasses.dataclass
class ModelSupport:
    default: str
    supported: list[str]
    disabled: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DeviceSupport:
    identifiers: list[str]  # platform identifiers this row applies to
    models: ModelSupport


_ALL_VARIANTS = [
    "tiny", "tiny.en", "base", "base.en", "small", "small.en",
    "medium", "medium.en", "large", "large-v2", "large-v3",
    "large-v3-turbo", "distil-large-v3",
]

# Fallback matrix (reference: Models.swift:1465-1662) re-keyed for this
# framework's target platforms.
_FALLBACK = [
    DeviceSupport(
        identifiers=["tpu", "tpu-v5e", "tpu-v5p", "tpu-v6e"],
        models=ModelSupport(default="large-v3-turbo", supported=list(_ALL_VARIANTS)),
    ),
    DeviceSupport(
        identifiers=["cpu"],
        models=ModelSupport(
            default="tiny",
            supported=["tiny", "tiny.en", "base", "base.en", "small", "small.en"],
        ),
    ),
]


@dataclasses.dataclass
class ModelSupportConfig:
    device_supports: list[DeviceSupport]

    @classmethod
    def fallback(cls) -> "ModelSupportConfig":
        return cls(device_supports=list(_FALLBACK))

    @classmethod
    def from_json(cls, path: Path | str) -> "ModelSupportConfig":
        """Parse a repo `config.json` and merge over the fallback matrix
        (reference: fetchModelSupportConfig, WhisperKit.swift:181-217).
        Accepts both the published `device_support` key (config-v02..v04
        fixtures, Tests/WhisperKitTests/Resources/) and `deviceSupports`."""
        with open(path) as f:
            data = json.load(f)
        rows = []
        for row in data.get("deviceSupports", data.get("device_support", [])):
            ms = row.get("models", {})
            rows.append(
                DeviceSupport(
                    identifiers=row.get("identifiers", []),
                    models=ModelSupport(
                        default=ms.get("default", "tiny"),
                        supported=ms.get("supported", []),
                        disabled=ms.get("disabled", []),
                    ),
                )
            )
        merged = cls.fallback()
        known = {tuple(d.identifiers): i for i, d in enumerate(merged.device_supports)}
        for row in rows:
            key = tuple(row.identifiers)
            if key in known:
                merged.device_supports[known[key]] = row
            else:
                merged.device_supports.append(row)
        return merged

    def model_support(self, identifier: Optional[str] = None) -> ModelSupport:
        """Reference: ModelUtilities.modelSupport(for:from:)."""
        identifier = identifier or current_device_identifier()
        best: Optional[ModelSupport] = None
        best_len = -1
        for row in self.device_supports:
            for i in row.identifiers:
                # ties go to later rows: remote-merged entries are appended
                # after the fallback matrix and should win
                if identifier.startswith(i) and len(i) >= best_len:
                    best, best_len = row.models, len(i)
        if best is not None:
            return best
        return self.device_supports[0].models if self.device_supports else ModelSupport(
            default="tiny", supported=["tiny"]
        )


def current_device_identifier(device=None) -> str:
    """"cpu" for the CPU; for a CUDA device, its name lower-cased with
    spaces as dashes (e.g. "nvidia-h100-80gb-hbm3"). `device` None means
    the card when one is visible, else the CPU."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device).lower().replace(" ", "-")


def recommended_model(identifier: Optional[str] = None) -> str:
    return ModelSupportConfig.fallback().model_support(identifier).default
