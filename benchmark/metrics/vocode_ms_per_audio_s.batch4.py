"""Device milliseconds of the vocoder per second of audio it made: the
device busy launched inside the benchmark's vocoder-call spans of the
traced paragraph (Code2Wav over every row's whole frame buffer), over the
seconds those calls' frames hold (rows x frames x samples a frame at
24 kHz)."""

from benchmark.trace import union_us

SAMPLE_RATE = 24_000


def read(run):
    sl = run.window.trace
    calls = run.slice_calls("vocode") if sl is not None else []
    audio_s = sum(c.rows * c.steps for c in calls) * run.dims.samples_per_frame / SAMPLE_RATE
    if not audio_s:
        return None
    kernels = sl.launched_in([(c.t0, c.t1) for c in calls])
    return union_us((s, e) for _, s, e, _ in kernels) / 1e3 / audio_s
