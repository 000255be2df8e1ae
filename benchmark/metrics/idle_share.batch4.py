"""The device's idle share over the window, in %, as the window ran
untraced: 1 minus the device busy the window's paragraphs took over its
wall. Each paragraph's busy is the traced paragraph's, scaled to the frames
it stepped: the busy launched inside the benchmark's frame-loop calls a
frame stepped (`TTSLoopOutput.steps`) times its frames, plus the rest of
the traced slice's busy (the vocoder, the uploads) once a paragraph.

The traced slice's own idle share would mostly read the profiler, which
about doubles a paragraph's wall on the host and leaves the device's busy
as it is. None where the port counts no frames."""

from benchmark.trace import union_us


def read(run):
    sl, w = run.window.trace, run.window
    calls = run.slice_calls("frames") if sl is not None else []
    steps = sum(c.steps for c in calls)
    window_steps = sum(i.answer.steps for i in w.items)
    if not steps or not window_steps:
        return None
    loop_s = union_us((s, e) for _, s, e, _ in sl.launched_in([(c.t0, c.t1) for c in calls])) / 1e6
    busy = loop_s / steps * window_steps + (sl.busy_s() - loop_s) * len(w.items)
    return 100.0 * (1.0 - busy / w.wall_s)
