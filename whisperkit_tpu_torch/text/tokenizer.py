"""Whisper special-token layout and the test tokenizer (the port's copy of
whisperkit_tpu/text/tokenizer.py, trimmed to `SpecialTokens`,
`special_tokens_for_vocab` and `FakeTokenizer`; a BPE tokenizer is passed
in by the caller).

Reference: Sources/WhisperKit/Core/Models.swift:1111-1180 (`SpecialTokens`),
with the layout derived from the vocab size the way the reference sniffs
variants from logits dims (ModelUtilities.swift:128-173).

Token-id layout (derived, not hardcoded per model):
  n_vocab 51864 (.en):   eot=50256 sot=50257 99 langs
  n_vocab 51865 (v1/v2): eot=50257 sot=50258 99 langs
  n_vocab 51866 (v3):    eot=50257 sot=50258 100 langs
then translate, transcribe, startoflm, startofprev, nospeech, notimestamps,
and 1501 timestamp tokens (<|0.00|> .. <|30.00|>, 0.02 s steps).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from whisperkit_tpu_torch.text.languages import CODE_TO_INDEX, LANGUAGES, resolve_language_code


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    """Reference: Models.swift:1111-1180 `SpecialTokens`."""

    eot: int
    sot: int
    n_languages: int
    translate: int
    transcribe: int
    startoflm: int
    startofprev: int
    nospeech: int
    notimestamps: int
    timestamp_begin: int
    n_vocab: int
    whitespace: int  # id of " " (suppress-blank filter)

    @property
    def language_begin(self) -> int:
        return self.sot + 1

    def language_token(self, code: str) -> int:
        idx = CODE_TO_INDEX[resolve_language_code(code)]
        if idx >= self.n_languages:
            raise ValueError(f"language {code!r} not in this model's vocab")
        return self.language_begin + idx

    def language_code(self, token: int) -> str:
        idx = token - self.language_begin
        if not 0 <= idx < self.n_languages:
            raise ValueError(f"token {token} is not a language token")
        return LANGUAGES[idx][0]

    def is_timestamp(self, token: int) -> bool:
        return token >= self.timestamp_begin

    def timestamp_seconds(self, token: int) -> float:
        return (token - self.timestamp_begin) * 0.02

    def timestamp_token(self, seconds: float) -> int:
        return self.timestamp_begin + int(round(seconds / 0.02))


def special_tokens_for_vocab(n_vocab: int, whitespace_id: int = -1) -> SpecialTokens:
    if n_vocab == 51864:  # English-only
        eot, sot, n_langs = 50256, 50257, 99
    elif n_vocab == 51865:  # multilingual v1/v2
        eot, sot, n_langs = 50257, 50258, 99
    elif n_vocab == 51866:  # multilingual v3
        eot, sot, n_langs = 50257, 50258, 100
    else:
        # Synthetic/test vocabs: place specials at the end, 2 fake languages.
        n_langs = 2
        base = n_vocab - (2 + n_langs + 6 + 8)  # 8 timestamp tokens
        if base < 1:
            raise ValueError(f"vocab too small for special-token layout: {n_vocab}")
        eot, sot = base, base + 1
    translate = sot + 1 + n_langs
    return SpecialTokens(
        eot=eot,
        sot=sot,
        n_languages=n_langs,
        translate=translate,
        transcribe=translate + 1,
        startoflm=translate + 2,
        startofprev=translate + 3,
        nospeech=translate + 4,
        notimestamps=translate + 5,
        timestamp_begin=translate + 6,
        n_vocab=n_vocab,
        whitespace=whitespace_id,
    )


class FakeTokenizer:
    """Deterministic tokenizer for tests without checkpoint files.

    Token i decodes to ' t{i}'; encode maps whitespace-split 't{i}' words
    back. Special tokens follow the synthetic layout of
    `special_tokens_for_vocab`.
    """

    def __init__(self, n_vocab: int):
        self.special = special_tokens_for_vocab(n_vocab, whitespace_id=0)

    def encode(self, text: str) -> list[int]:
        ids = []
        for w in text.split():
            if w.startswith("t") and w[1:].isdigit():
                ids.append(int(w[1:]))
        return ids

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        return "".join(f" t{i}" for i in ids if i < self.special.eot)

    def decode_with_timestamps(self, ids: Sequence[int]) -> str:
        sp = self.special
        out = []
        for i in ids:
            if i >= sp.timestamp_begin:
                out.append(f"<|{sp.timestamp_seconds(i):.2f}|>")
            elif i >= sp.eot:
                out.append(f"<|{i}|>")
            else:
                out.append(f" t{i}")
        return "".join(out)

    def split_to_word_tokens(self, tokens, language="en"):
        words = [f" t{t}" for t in tokens]
        return words, [[t] for t in tokens]
