"""The batcher's fill: real windows per batch over `max_batch`, in % (the
port's `BatchScheduler.stats()["windows_per_batch"]`), over the batches
the window ran before its traced slice."""


def read(run):
    b = run.window.batches
    return 100.0 * sum(b) / (len(b) * run.max_batch) if b else None
