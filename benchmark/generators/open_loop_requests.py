"""Requests arrive on a fixed schedule, whatever the system does:
round(`rate_rps` x seconds) of them, Poisson, due inside the window
(`loadgen.schedule`), submitted to the scheduler the system starts
(`scheduler`: `max_batch`, `max_wait_ms`; for Whisper the port's
`BatchScheduler`) through `submit`, the call its HTTP handler makes.
`clips` gives the mixture of clip lengths. The schedule is `shape_seed`'s
whatever the run's seed; each clip is cut at a seeded offset from one
seeded recording of `pool_seconds`. After the window, the requests still
out get `drain_seconds` to finish (in a traced run, from when the trace has
been read). Warm-up sends a burst of each size in `warmup_batches` and one
request of `warmup_long_s` seconds. A traced run traces `trace_seconds` of
whole batches on the batcher's thread, from the window's last
`trace_seconds` but one (the system's spans open and close the slice at
its "encode" calls, one a batch). `sample_requests` is how many finished
requests the reference judges (the longest among them)."""

from __future__ import annotations

import time

import numpy as np

from benchmark import loadgen
from benchmark.generator import SAMPLE_RATE, Served, Window, pick
from benchmark.workload import synth_speechlike_audio


class Runner:
    def __init__(self, traffic: dict, system, seed: int, seconds: float, scheduler=None):
        """`scheduler`: a running scheduler to reuse (the rate sweep's)."""
        self.traffic, self.system = traffic, system
        self.options = system.options(traffic["scheduler"]["max_batch"])
        self.due, lengths = loadgen.schedule(traffic["rate_rps"], seconds, traffic["clips"], traffic["shape_seed"])
        pool = synth_speechlike_audio(traffic["pool_seconds"], seed=seed * 7)
        rng = np.random.default_rng([seed, 2])
        sizes = np.round(lengths * SAMPLE_RATE).astype(int)
        starts = rng.integers(0, len(pool) - sizes + 1)
        self.clips = [pool[s:s + n] for s, n in zip(starts, sizes)]
        self.pool = pool
        self.scheduler = scheduler or system.start_scheduler(traffic["scheduler"]["max_batch"],
                                                             traffic["scheduler"]["max_wait_ms"])

    def warmup(self) -> None:
        for b in self.traffic["warmup_batches"]:
            burst = [self.scheduler.submit(self.pool[i * SAMPLE_RATE:(i + 10) * SAMPLE_RATE], self.options)
                     for i in range(b)]
            for f in burst:
                f.result()
        n = int(self.traffic["warmup_long_s"] * SAMPLE_RATE)
        self.scheduler.submit(self.pool[:n], self.options).result()

    def window(self, seconds: float, trace: bool, spans=None) -> Window:
        n = len(self.due)
        done: dict[int, float] = {}
        futures, late = [], []
        batches0 = len(self.system.batch_counts())
        t0 = time.perf_counter()
        if trace:  # the batcher's thread opens and closes the slice (spans.Spans.trace_from)
            spans.trace_from(t0 + seconds - 1.0 - self.traffic["trace_seconds"], self.traffic["trace_seconds"])
        for i in range(n):
            due = t0 + self.due[i]
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            f = self.scheduler.submit(self.clips[i], self.options)
            late.append(time.perf_counter() - due)
            f.add_done_callback(lambda _f, i=i: done.setdefault(i, time.perf_counter()))
            futures.append(f)
        drain_from = t0 + seconds
        if trace:  # the drain starts once the batcher's thread has read the trace (its stall is the harness's)
            while spans.slice_done_at is None and time.perf_counter() < drain_from + self.traffic["drain_seconds"]:
                time.sleep(0.05)
            drain_from = max(drain_from, spans.slice_done_at or drain_from)
        drain_end = drain_from + self.traffic["drain_seconds"]
        for f in futures:
            try:
                f.result(timeout=max(0.0, drain_end - time.perf_counter()))
            except Exception:  # raised, or none by the drain's end: counted below
                pass
        deadline = time.perf_counter() + 5.0  # result() can return before its done-callback has run
        while len(done) < sum(f.done() for f in futures) and time.perf_counter() < deadline:
            time.sleep(0.001)
        answered = {i: t - t0 for i, t in done.items() if futures[i].done() and futures[i].exception() is None}
        lat, missing = loadgen.latencies(self.due, answered, drain_end - t0)
        items = [Served(self.clips[i], futures[i].result()) for i in sorted(answered)]
        sl = spans.slice if trace else None
        if trace and (sl is None or not sl.kernels):
            raise RuntimeError(f"the traced slice did not close inside the window's load ({spans.slice_error!r})")
        batches = self.system.batch_counts()[batches0:]
        if sl is not None:  # the batches run before the slice opened
            batches = batches[:sum(1 for c in spans.calls if c.kind == "encode" and t0 <= c.t0 < sl.t0)]
        return Window(max(answered.values(), default=seconds), n, missing, items,
                      sum(len(i.request) for i in items) / SAMPLE_RATE, latencies=lat, late_s=late,
                      batches=batches, trace=sl)

    def cases(self, items: list, cases_per_item: list, seed: int) -> list:
        """Every served window of `sample_requests` finished requests, the
        longest among them."""
        picked = pick([len(item.request) for item in items], self.traffic["sample_requests"], seed)
        return [c for i in picked for c in cases_per_item[i]]
