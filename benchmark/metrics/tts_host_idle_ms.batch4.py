"""Device-idle milliseconds of the TTS pipeline's host stages, per
paragraph: inside the traced paragraph's `tts` span (the port's span ring,
`core/signposts.py`) and outside its `tts.prefill`, `tts.frames` and
`tts.vocode` spans: the tokenizing and the prompt's embedding, the reads of
the frames and the audio, the crossfade. Device-idle: the slice's stretches
with no device activity."""

from benchmark.program_spans import found, idle_s

DEVICE_STAGES = ("tts.prefill", "tts.frames", "tts.vocode")


def read(run):
    sl = run.window.trace
    spans = found(sl)
    if not spans:
        return None
    roots = [s for s in spans if s.name == "tts" and sl.t0 <= s.t0 and s.t1 <= sl.t1]
    if not roots:
        return None
    root = roots[-1]
    device = [s for s in spans if s.request == root.request and s.name in DEVICE_STAGES]
    return 1e3 * idle_s(sl, [root], device)
