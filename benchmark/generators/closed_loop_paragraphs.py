"""One caller synthesizes paragraphs back to back through the system's
`synthesize` (for Qwen3-TTS, the port's `TTSPipeline.generate`). Each
paragraph is `sentences` English sentences of `min_chars` to `max_chars`
characters, words drawn from WORDS by the seed and the paragraph's index,
so that TTSKit's sentence chunker (`options.target_chunk_size`,
`options.min_chunk_size`) makes one chunk of each sentence: one batch of
`sentences` rows. Each paragraph is synthesized with its own sampling seed,
drawn from the seed and its index. The paragraph in flight when the
window's time is up runs to its end, and its audio and its time both
count. Warm-up builds the prompt cache (where `options.prompt_cache` is
on) and synthesizes `warmup_paragraphs` paragraphs, which run every shape
of the window (every paragraph has the same rows, prompt positions and
frame budget); a traced run then synthesizes one more paragraph under the
profiler, after the window. `sample_rows` is how many served rows the
reference judges, the one with the most frames among them."""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np

from benchmark.generator import Served, Window, pick

SAMPLE_RATE = 24_000
WORDS = (
    "the a of and to in is was for on that with as by at from his her they their it this an be are had have "
    "not but one all when there been were which we she he what up out so some into time would could other "
    "more about then them these two like over only its first new after also people years way may day water "
    "light night morning evening river mountain garden window letter house village harbor story "
    "winter summer autumn spring forest meadow road bridge station market library kitchen table chair "
    "lantern candle ship captain sailor keeper stairs tower beacon horizon storm wind rain snow sun moon "
    "star cloud field farmer baker teacher student doctor traveler stranger neighbor friend family child "
    "walked carried watched wrote read listened waited opened closed remembered noticed answered followed "
    "quietly slowly carefully gently suddenly often always never again together alone early late far near "
    "old young small large quiet bright dark warm cold long short narrow wide green blue golden silver"
).split()


@dataclasses.dataclass
class Paragraph:
    """What was sent: the sentences, their text, and the sampling seed."""

    sentences: list
    seed: int
    options: dict  # the traffic's options

    @property
    def text(self) -> str:
        return " ".join(self.sentences)


def sentences(seed: int, stream: int, index: int, n: int, min_chars: int, max_chars: int) -> list[str]:
    """`n` sentences of min_chars..max_chars characters (the closing period
    included), each ending in its only period. `stream` keeps the window's,
    the warm-up's and the trace's paragraphs apart."""
    rng = np.random.default_rng([seed, stream, index])
    longest = max(len(w) for w in WORDS)
    out = []
    for _ in range(n):
        # words are added while they fit, so a sentence ends within one word of its target
        target = int(rng.integers(min_chars + longest + 1, max_chars + 1))
        words: list[str] = []
        while True:
            w = WORDS[int(rng.integers(len(WORDS)))]
            if len(" ".join(words + [w])) + 1 > target:
                break
            words.append(w)
        s = " ".join(words) + "."
        out.append(s[0].upper() + s[1:])
    return out


def paragraph_seed(seed: int, stream: int, index: int) -> int:
    """The sampling seed of a paragraph: 63 bits from the run's seed."""
    return int(np.random.default_rng([seed, stream, index, 1]).integers(0, 2 ** 63 - 1))


class Runner:
    WINDOW, WARMUP, TRACE = 0, 1, 2  # streams of paragraphs

    def __init__(self, traffic: dict, system, seed: int, seconds: float):
        self.traffic, self.system, self.seed = traffic, system, seed

    def paragraph(self, stream: int, index: int) -> Paragraph:
        t = self.traffic
        return Paragraph(sentences(self.seed, stream, index, t["sentences"], t["min_chars"], t["max_chars"]),
                         paragraph_seed(self.seed, stream, index), t["options"])

    def synthesize(self, p: Paragraph):
        return self.system.synthesize(p.text, self.system.options(self.traffic, p.seed))

    def warmup(self) -> None:
        if self.traffic["options"]["prompt_cache"]:
            self.system.build_prompt_cache(self.system.options(self.traffic))
        for i in range(self.traffic["warmup_paragraphs"]):
            self.synthesize(self.paragraph(self.WARMUP, i))

    def window(self, seconds: float, trace: bool, spans=None) -> Window:
        items, attempted, failed = [], 0, 0
        t0 = time.perf_counter()
        t_end = t0
        while t_end - t0 < seconds:
            p = self.paragraph(self.WINDOW, attempted)
            attempted += 1
            try:
                answer = self.synthesize(p)
            except Exception as e:  # a paragraph with no answer counts as failed
                print(f"a paragraph of {len(p.text)} characters raised: {e!r}", file=sys.stderr)
                failed += 1
            else:
                items.append(Served(p, answer))
            t_end = time.perf_counter()
        win = Window(t_end - t0, attempted, failed, items,
                     sum(len(i.answer.audio) for i in items) / SAMPLE_RATE)
        if trace:
            from benchmark.trace import Slice

            with Slice() as sl:
                win.trace_result = self.synthesize(self.paragraph(self.TRACE, 0))
            win.trace = sl
        return win

    def cases(self, items: list, cases_per_item: list, seed: int) -> list:
        """The served rows the reference judges: `sample_rows` of them over
        all finished paragraphs, the one with the most frames among them."""
        flat = [c for per in cases_per_item for c in per]
        return [flat[i] for i in pick([c.size for c in flat], self.traffic["sample_rows"], seed)]
