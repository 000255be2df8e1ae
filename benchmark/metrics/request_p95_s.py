"""The 95th percentile, over every request due in the window, of the
seconds from when it was due to its answer; a request with no answer by
the end of the drain counts with the drain's end."""

from benchmark.loadgen import percentile


def read(run):
    lat = run.window.latencies
    return percentile(lat, 95) if lat else None
