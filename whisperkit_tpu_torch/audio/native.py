"""ctypes binding for the native FFmpeg audio decoder (native/audio_decoder.cpp
at the repo root), whole-file decode only.

The library is built at first use with the sources' Makefile flags into
`build/whisperkit_tpu_torch/native/` beside the package, named by a hash
of the sources, and loaded from there. Where it cannot be built (no
compiler or FFmpeg headers), `available()` is False and `load_audio`
reads PCM WAV with its NumPy parser.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from whisperkit_tpu_torch.core.errors import LoadAudioFailed
from whisperkit_tpu_torch.core.logging import logging

_REPO = Path(__file__).resolve().parent.parent.parent
_SOURCE_DIR = _REPO / "native"
_SOURCES = ("audio_decoder.cpp", "Makefile")
BUILD_DIR = _REPO / "build" / "whisperkit_tpu_torch" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_attempted = False


def _library_path() -> Optional[Path]:
    if not all((_SOURCE_DIR / s).exists() for s in _SOURCES):
        return None
    h = hashlib.sha256()
    for s in _SOURCES:
        h.update((_SOURCE_DIR / s).read_bytes())
    return BUILD_DIR / h.hexdigest()[:12] / "libwhisperkit_audio.so"


def _build(path: Path) -> bool:
    """`make` in a copy of the sources next to `path`."""
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        for s in _SOURCES:
            shutil.copy2(_SOURCE_DIR / s, path.parent / s)
        subprocess.run(["make", "-C", str(path.parent)], check=True, capture_output=True, timeout=300)
        return path.exists()
    except Exception as e:  # noqa: BLE001 — no toolchain: WAV-only
        logging.debug(f"native audio decoder build failed: {e}")
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_attempted
    with _lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        if path is None:
            return None
        if not path.exists():
            if _build_attempted:
                return None
            _build_attempted = True
            if not _build(path):
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            logging.debug(f"failed to load native audio decoder: {e}")
            return None
        lib.wk_decode_audio.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.wk_decode_audio.restype = ctypes.c_int
        lib.wk_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.wk_free.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode(path: str) -> Tuple[np.ndarray, int, int]:
    """Decode any audio file. Returns (interleaved float32, sample_rate, channels)."""
    lib = _load()
    if lib is None:
        raise LoadAudioFailed("native audio decoder unavailable")
    buf = ctypes.POINTER(ctypes.c_float)()
    frames = ctypes.c_int64()
    channels = ctypes.c_int32()
    rate = ctypes.c_int32()
    ret = lib.wk_decode_audio(
        os.fsencode(path), ctypes.byref(buf), ctypes.byref(frames),
        ctypes.byref(channels), ctypes.byref(rate),
    )
    if ret != 0 or not buf:
        raise LoadAudioFailed(f"native decode failed for {path} (code {ret})")
    try:
        n = frames.value * channels.value
        samples = np.ctypeslib.as_array(buf, shape=(n,)).astype(np.float32, copy=True)
    finally:
        lib.wk_free(buf)
    return samples, rate.value, channels.value
