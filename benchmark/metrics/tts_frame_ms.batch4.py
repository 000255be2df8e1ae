"""Device milliseconds a TTS frame: the device busy launched inside the
benchmark's frame-loop spans of the traced paragraph (the loop's prefill of
the prompt's uncached positions, then every frame: the talker's position,
the code predictor's 15 passes and its heads, the eager first frame and the
graph replays alike), over the frames those calls stepped (the port's
`TTSLoopOutput.steps`; None where the port counts none)."""

from benchmark.trace import union_us


def read(run):
    sl = run.window.trace
    calls = run.slice_calls("frames") if sl is not None else []
    steps = sum(c.steps for c in calls)
    if not steps:
        return None
    kernels = sl.launched_in([(c.t0, c.t1) for c in calls])
    return union_us((s, e) for _, s, e, _ in kernels) / 1e3 / steps
