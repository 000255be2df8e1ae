"""Text utilities (the port's copy of whisperkit_tpu/text/utils.py).

Reference: Sources/WhisperKit/Utilities/TextUtilities.swift:14-53
(`compressionRatio` — zlib-based repetition detector used by the
temperature-fallback rules).
"""

from __future__ import annotations

import zlib


def compression_ratio_text(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))

