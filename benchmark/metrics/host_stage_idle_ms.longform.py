"""Device-idle milliseconds of the pipeline's host stages, per real window:
inside the traced file's `transcribe` span (the port's span ring,
`core/signposts.py`) and outside its `encode`, `prefill` and `decode`
spans, over the file's real windows (the port's
`TranscriptionTimings.total_decoding_windows`). Device-idle: the slice's
stretches with no device activity."""

from benchmark.program_spans import found, idle_s

DEVICE_STAGES = ("encode", "prefill", "decode")


def read(run):
    sl, result = run.window.trace, run.window.trace_result
    spans = found(sl)
    if not spans or result is None or not result.timings.total_decoding_windows:
        return None
    roots = [s for s in spans if s.name == "transcribe" and sl.t0 <= s.t0 and s.t1 <= sl.t1]
    if not roots:
        return None
    root = roots[-1]
    device = [s for s in spans if s.request == root.request and s.name in DEVICE_STAGES]
    return 1e3 * idle_s(sl, [root], device) / result.timings.total_decoding_windows
