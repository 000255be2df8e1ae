"""The batcher's queue wait, in ms a window: from each window's submit
(`BatchScheduler.submit`) to the start of the `batch` span that runs it,
averaged over the windows of the same batches that `batch_fill.requests`
reads (the window's batches before the traced slice: the last
`len(run.window.batches)` `batch` spans that ended before the slice
opened). Each `batch` span (the port's span ring, `core/signposts.py`)
carries its windows and the sum of their waits."""

from benchmark.program_spans import found


def read(run):
    sl, n = run.window.trace, len(run.window.batches)
    spans = found(sl, 0.0, sl.t0) if sl is not None and n else None
    if not spans:
        return None
    batches = [s for s in spans if s.name == "batch" and s.t1 < sl.t0][-n:]
    windows = sum(s.attrs["windows"] for s in batches)
    return 1e3 * sum(s.attrs["wait_sum_s"] for s in batches) / windows if windows else None
