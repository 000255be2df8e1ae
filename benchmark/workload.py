"""Speech-like audio and the decode options of the benchmark's traffic.

A copy of the port's `tools/workload.py` (itself the recipe of the JAX
package's `bench.py`), kept here so that a change to the program cannot
change the benchmark's inputs.
"""

from __future__ import annotations

import numpy as np


def synth_speechlike_audio(seconds: float, seed: int = 0) -> np.ndarray:
    """Speech-shaped test signal: 2-8 s modulated noise bursts separated by
    0.2-0.8 s of near-silence, so an energy VAD finds real chunk boundaries."""
    rng = np.random.default_rng(seed)
    sr = 16_000
    total = int(seconds * sr)
    out = np.zeros(total, np.float32)
    t = 0
    while t < total:
        burst = int(rng.uniform(2.0, 8.0) * sr)
        gap = int(rng.uniform(0.2, 0.8) * sr)
        n = min(burst, total - t)
        if n > 0:
            x = rng.standard_normal(n).astype(np.float32)
            # crude spectral shaping + syllabic amplitude modulation
            env = 0.25 * (0.6 + 0.4 * np.sin(2 * np.pi * 4.0 * np.arange(n) / sr))
            out[t : t + n] = np.cumsum(x) / 50.0 * env  # brownish noise
        t += n + gap
    peak = np.abs(out).max() or 1.0
    out = (out / peak * 0.5).astype(np.float32)
    # on the 16-bit PCM grid, like audio decoded from WAV or by FFmpeg
    return (np.rint(out * 32768.0).clip(-32768, 32767) / np.float32(32768.0)).astype(np.float32)


def pipeline_options(group: int) -> dict:
    """The decode options, as keywords of the port's `DecodingOptions`: VAD
    chunking, timestamp rules on, the full 224-token budget, groups of
    `group` windows, greedy. The fallback ladder and the quality thresholds
    are off: random-weight text trips them on every window, which real
    speech does not, and the first-token floor would end every window at
    once."""
    return dict(
        language="en",
        chunking_strategy="vad",
        sample_length=224,
        without_timestamps=False,
        temperature_fallback_count=0,
        logprob_threshold=None,
        compression_ratio_threshold=None,
        no_speech_threshold=None,
        first_token_log_prob_threshold=None,
        concurrent_worker_count=group,
    )
