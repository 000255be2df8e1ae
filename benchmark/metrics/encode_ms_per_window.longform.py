"""Device milliseconds of encoding a real window: the device busy launched
inside the benchmark's encode-call spans of the traced file (the encoder
and the cross-KV projection, pad rows included), over the file's real
windows (the port's `TranscriptionTimings.total_decoding_windows`)."""

from benchmark.trace import union_us


def read(run):
    sl = run.window.trace
    calls = run.slice_calls("encode")
    result = run.window.trace_result
    if sl is None or not calls or result is None or not result.timings.total_decoding_windows:
        return None
    kernels = sl.launched_in([(c.t0, c.t1) for c in calls])
    return union_us((s, e) for _, s, e, _ in kernels) / 1e3 / result.timings.total_decoding_windows
