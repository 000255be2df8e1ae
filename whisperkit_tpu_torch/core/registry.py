"""Model resolution + download with offline-cache-first semantics (the
port's copy of whisperkit_tpu/core/registry.py).

Reference: Sources/ArgmaxCore/ModelDownloader.swift — `resolveModel`'s 3-step
fallback (explicit folder → local cache → network download, :118-162) and
`ModelInfo` naming (:290-339); plus Sources/WhisperKit/Utilities/
ModelUtilities.swift variant detection (:128-173).

Network access is optional: everything resolves from local folders first.
`huggingface_hub` is imported only inside the download step; without it,
or without a network, an uncached model raises `ModelsUnavailable`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional

from whisperkit_tpu_torch.core.errors import ModelsUnavailable
from whisperkit_tpu_torch.core.logging import logging

DEFAULT_MODEL_REPO = "openai/whisper-{variant}"
DEFAULT_CACHE_DIR = os.path.expanduser("~/.cache/whisperkit_tpu")
# seconds huggingface_hub waits for a server's first answer before it
# gives up on a file (its own default is 10)
DOWNLOAD_TIMEOUT_S = 10.0

# Whisper model variants (reference: Models.swift:39-88 `ModelVariant`).
WHISPER_VARIANTS = (
    "tiny", "tiny.en",
    "base", "base.en",
    "small", "small.en",
    "medium", "medium.en",
    "large-v1", "large-v2", "large-v3", "large-v3-turbo",
    "distil-large-v3",
)


@dataclasses.dataclass
class ModelInfo:
    """Reference: ModelDownloader.swift:290-339."""

    name: str
    version: str = ""
    variant: str = ""

    @property
    def download_pattern(self) -> str:
        return f"*{self.name}*"


def is_model_multilingual(logits_dim: int) -> bool:
    """Reference: ModelUtilities.swift:124-126 — vocab 51864 is English-only."""
    return logits_dim >= 51865


def detect_variant(
    logits_dim: int, encoder_dim: int, decoder_layers: Optional[int] = None
) -> str:
    """Sniff the Whisper variant from checkpoint dims.

    Reference: ModelUtilities.swift:128-173 `detectVariant` — maps
    (vocab, d_model) to a variant name; decoder depth disambiguates
    turbo (4 layers) and distil (2 layers) from full large-v3.
    """
    multilingual = is_model_multilingual(logits_dim)
    by_width = {384: "tiny", 512: "base", 768: "small", 1024: "medium", 1280: "large"}
    base = by_width.get(encoder_dim)
    if base is None:
        raise ModelsUnavailable(f"unknown encoder width {encoder_dim}")
    if base == "large":
        # v3 grew the vocab to 51866 (adds <|yue|>)
        if logits_dim != 51866:
            return "large-v2"
        if decoder_layers == 4:
            return "large-v3-turbo"
        if decoder_layers == 2:
            return "distil-large-v3"
        return "large-v3"
    return base if multilingual else f"{base}.en"


def resolve_model_folder(
    model: Optional[str] = None,
    model_repo: Optional[str] = None,
    model_folder: Optional[str] = None,
    cache_dir: Optional[str] = None,
    download: bool = True,
) -> Path:
    """3-step resolution: explicit folder → local cache (`cache_dir`,
    DEFAULT_CACHE_DIR when None) → hub download.

    Reference: ModelDownloader.swift:118-162 `resolveModel`.
    """
    if model_folder:
        p = Path(model_folder)
        if not p.exists():
            raise ModelsUnavailable(f"model folder does not exist: {p}")
        return p

    if model is None:
        raise ModelsUnavailable("either model or model_folder must be given")

    repo = model_repo or DEFAULT_MODEL_REPO.format(variant=model)
    cached = Path(cache_dir or DEFAULT_CACHE_DIR) / repo.replace("/", "--")
    if _patterns_exist_locally(cached):
        logging.debug(f"using cached model at {cached}")
        return cached

    if not download:
        raise ModelsUnavailable(
            f"model '{model}' not found locally at {cached} and download disabled"
        )
    return _download_snapshot(repo, cached)


def _patterns_exist_locally(folder: Path) -> bool:
    """Reference: ModelDownloader.swift:245-257 `patternsExistLocally`."""
    if not folder.is_dir():
        return False
    has_weights = any(folder.glob("*.safetensors")) or any(folder.glob("*.npz"))
    has_config = (folder / "config.json").exists()
    return has_weights and has_config


def _download_snapshot(repo: str, dest: Path) -> Path:
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise ModelsUnavailable(
            f"huggingface_hub unavailable and model not cached for repo {repo}"
        ) from e
    logging.info(f"downloading {repo} → {dest}")
    try:
        path = snapshot_download(
            repo,
            allow_patterns=["*.safetensors", "*.json", "*.txt", "*.npz"],
            local_dir=str(dest),
            etag_timeout=DOWNLOAD_TIMEOUT_S,
        )
    except Exception as e:  # no network: surface an actionable message
        raise ModelsUnavailable(
            f"failed to download {repo}: {e}. Place weights (model.safetensors + "
            f"config.json + tokenizer files) at {dest} manually."
        ) from e
    return Path(path)


def read_model_config(folder: Path) -> dict:
    cfg_path = Path(folder) / "config.json"
    if not cfg_path.exists():
        raise ModelsUnavailable(f"missing config.json in {folder}")
    with open(cfg_path) as f:
        return json.load(f)
