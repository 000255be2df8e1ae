"""Device milliseconds a decode step: the device busy launched inside the
benchmark's decode-call spans of the traced file, over the positions those
calls decoded (graph replays and eager steps alike)."""

from benchmark.trace import union_us


def read(run):
    sl = run.window.trace
    calls = run.slice_calls("decode")
    steps = sum(c.steps for c in calls)
    if sl is None or not steps:
        return None
    kernels = sl.launched_in([(c.t0, c.t1) for c in calls])
    return union_us((s, e) for _, s, e, _ in kernels) / 1e3 / steps
