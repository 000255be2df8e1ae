"""Device-idle milliseconds of the batcher's host stages, per batch: inside
the slice's `batch` spans (the port's span ring, `core/signposts.py`) and
outside their `encode`, `prefill` and `decode` spans, plus the idle inside
`vad` spans (a long request's chunking, while the batcher gathers), over
the batches whose `encode` span lies in the slice. The rest of the
gather's wait (`batch.gather`) is not counted."""

from benchmark.program_spans import found, idle_s

DEVICE_STAGES = ("encode", "prefill", "decode")


def read(run):
    sl = run.window.trace
    spans = found(sl)
    if not spans:
        return None
    batches = {s.id: s for s in spans if s.name == "batch"}
    device = [s for s in spans if s.parent in batches and s.name in DEVICE_STAGES]
    n = sum(1 for s in device if s.name == "encode" and sl.t0 <= s.t0 and s.t1 <= sl.t1)
    if not n:
        return None
    vad = [s for s in spans if s.name == "vad"]
    return 1e3 * (idle_s(sl, batches.values(), device) + idle_s(sl, vad)) / n
