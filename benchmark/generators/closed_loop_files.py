"""One caller transcribes whole recordings back to back through the
system's `transcribe`. `file_minutes` lists the recordings' lengths in the
order they repeat; the seed makes their audio, never their lengths or
order. All of it is made in set-up, and the window cycles through it. The
file in flight when the window's time is up runs to its end, and its audio
and its time both count. Warm-up transcribes the files listed by
`warmup_files`, which between them run every group shape of the cycle; a
traced run then transcribes `trace_file` under the profiler, after the
window. `group` is the pipeline's windows per group; `sample_windows` is
how many served windows the reference judges."""

from __future__ import annotations

import sys
import time

from benchmark.generator import SAMPLE_RATE, Served, Window, pick
from benchmark.workload import synth_speechlike_audio


class Runner:
    def __init__(self, traffic: dict, system, seed: int, seconds: float):
        self.traffic, self.system = traffic, system
        self.options = system.options(traffic["group"])
        self.files = [synth_speechlike_audio(60 * m, seed=seed * 7 + i)
                      for i, m in enumerate(traffic["file_minutes"])]

    def warmup(self) -> None:
        for i in self.traffic["warmup_files"]:
            self.system.transcribe(self.files[i], self.options)

    def window(self, seconds: float, trace: bool, spans=None) -> Window:
        items, attempted, failed = [], 0, 0
        t0 = time.perf_counter()
        t_end = t0
        while t_end - t0 < seconds:
            audio = self.files[attempted % len(self.files)]
            attempted += 1
            try:
                result = self.system.transcribe(audio, self.options)
            except Exception as e:  # a file with no answer counts as failed
                print(f"a file of {len(audio) / SAMPLE_RATE:.0f} s raised: {e!r}", file=sys.stderr)
                failed += 1
            else:
                items.append(Served(audio, result))
            t_end = time.perf_counter()
        win = Window(t_end - t0, attempted, failed, items, sum(len(i.request) for i in items) / SAMPLE_RATE)
        if trace:
            from benchmark.trace import Slice

            with Slice() as sl:
                win.trace_result = self.system.transcribe(self.files[self.traffic["trace_file"]], self.options)
            win.trace = sl
        return win

    def cases(self, items: list, cases_per_item: list, seed: int) -> list:
        """The served windows the reference judges: `sample_windows` of them
        over all finished files, the longest among them."""
        flat = [c for per in cases_per_item for c in per]
        return [flat[i] for i in pick([c.size for c in flat], self.traffic["sample_windows"], seed)]
