"""Device-idle milliseconds a frame inside the TTS frame loop, as the loop
runs untraced: over the window's paragraphs, the host wall of the port's
`tts.frames` spans (`core/signposts.py`) less their `graph.warmup` and
`graph.capture` spans (the eager first frame and the capture: set-up of
each paragraph's graph, which `graph_capture_ms.batch4` reads), over the
frames they replayed; less the device busy a replayed frame takes, read
from the traced paragraph's `tts.frames` spans less the same set-up spans.

The wall is the untraced one because a profiler session makes each graph
replay dearer on the host (about doubling the traced paragraph's wall): an
idle share read inside the traced slice alone would mostly read the
profiler. The device's busy a frame is the same with and without it. None
where the port keeps no such spans or counts no frames."""

from benchmark.program_spans import found, idle_s, minus, on_trace

SETUP = ("graph.warmup", "graph.capture")


def frame_loops(spans):
    """The `tts.frames` spans, each with its set-up children, and the frames
    each replayed (its frames less the eager first one)."""
    out = []
    for f in spans:
        if f.name == "tts.frames" and f.attrs.get("frames"):
            setup = [s for s in spans if s.parent == f.id and s.name in SETUP]
            out.append((f, setup, f.attrs["frames"] - (1 if setup else 0)))
    return out


def read(run):
    sl, items = run.window.trace, run.window.items
    if sl is None or not items:
        return None
    window = frame_loops(found(sl, items[0].answer.t0, items[-1].answer.t1) or [])
    traced = frame_loops([s for s in found(sl) or [] if sl.t0 <= s.t0 and s.t1 <= sl.t1])
    frames, traced_frames = sum(n for *_, n in window), sum(n for *_, n in traced)
    if not frames or not traced_frames:
        return None
    wall = sum(f.seconds - sum(s.seconds for s in setup) for f, setup, _ in window)
    inside = [f for f, _, _ in traced]
    setup = [s for _, st, _ in traced for s in st]
    region_s = sum(e - s for s, e in minus(on_trace(sl, inside), on_trace(sl, setup))) / 1e6
    busy = region_s - idle_s(sl, inside, setup)
    return 1e3 * (wall / frames - busy / traced_frames)
