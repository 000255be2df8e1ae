"""Device-idle milliseconds inside a decode call, per call: the device-idle
time inside the traced file's `decode` spans (the port's span ring,
`core/signposts.py`: one span per rung's loop call, its eager first step,
graph capture and host stop checks inside), over those spans."""

from benchmark.program_spans import found, idle_s


def read(run):
    sl = run.window.trace
    spans = found(sl)
    if not spans:
        return None
    roots = [s for s in spans if s.name == "transcribe" and sl.t0 <= s.t0 and s.t1 <= sl.t1]
    if not roots:
        return None
    calls = [s for s in spans if s.request == roots[-1].request and s.name == "decode"]
    return 1e3 * idle_s(sl, calls) / len(calls) if calls else None
