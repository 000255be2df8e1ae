"""Text utilities (the port's copy of whisperkit_tpu/text/utils.py).

Reference: Sources/WhisperKit/Utilities/TextUtilities.swift:14-53
(`compressionRatio` — zlib-based repetition detector used by the
temperature-fallback rules).
"""

from __future__ import annotations

import zlib
from typing import Sequence


def compression_ratio_text(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def compression_ratio_tokens(tokens: Sequence[int]) -> float:
    if not tokens:
        return 0.0
    import numpy as np

    data = np.asarray(tokens, np.int32).tobytes()
    return len(data) / len(zlib.compress(data))
