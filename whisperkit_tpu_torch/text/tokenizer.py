"""Whisper tokenizer: GPT-2 byte-level BPE + Whisper special-token layout
(the port's copy of whisperkit_tpu/text/tokenizer.py, the whole module).

Reference: Sources/ArgmaxCore/External/Tokenizers/ (vendored swift BPE stack)
and Sources/WhisperKit/Core/Models.swift:1111-1322 (`SpecialTokens`,
`WhisperTokenizer`, `splitToWordTokens`). The BPE is plain Python: it reads
`vocab.json`/`merges.txt` from the model folder, or `tokenizer.json`, with
the special-token layout derived from the vocab size the way the reference
sniffs variants from logits dims (ModelUtilities.swift:128-173).

Token-id layout (derived, not hardcoded per model):
  n_vocab 51864 (.en):   eot=50256 sot=50257 99 langs
  n_vocab 51865 (v1/v2): eot=50257 sot=50258 99 langs
  n_vocab 51866 (v3):    eot=50257 sot=50258 100 langs
then translate, transcribe, startoflm, startofprev, nospeech, notimestamps,
and 1501 timestamp tokens (<|0.00|> .. <|30.00|>, 0.02 s steps).

The optional `regex` package gives the exact GPT-2 split pattern; without
it a stdlib approximation splits non-ASCII letters otherwise.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import re
from pathlib import Path
from typing import Optional, Sequence, Union

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


# ---------------------------------------------------------------------------
# GPT-2 byte-level BPE
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte→unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


try:  # `regex` supports \p{L}/\p{N} (the exact GPT-2 pattern)
    import regex as _rx

    _GPT2_SPLIT = _rx.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
    )
except ImportError:  # stdlib approximation (letters ≈ [^\W\d_])
    _GPT2_SPLIT = re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+"""
    )


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


class BPETokenizer:
    """Byte-level BPE encode/decode from vocab.json + merges.txt."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: dict[str, list[str]] = {}

    @classmethod
    def from_folder(cls, folder: Union[str, Path]) -> "BPETokenizer":
        folder = Path(folder)
        tok_json = folder / "tokenizer.json"
        if (folder / "vocab.json").exists() and (folder / "merges.txt").exists():
            with open(folder / "vocab.json", encoding="utf-8") as f:
                vocab = json.load(f)
            merges = []
            with open(folder / "merges.txt", encoding="utf-8") as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line or line.startswith("#version"):
                        continue
                    a, _, b = line.partition(" ")
                    merges.append((a, b))
            return cls(vocab, merges)
        if tok_json.exists():
            with open(tok_json, encoding="utf-8") as f:
                data = json.load(f)
            model = data["model"]
            merges = [
                tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                for m in model["merges"]
            ]
            return cls(model["vocab"], merges)
        raise FileNotFoundError(f"no tokenizer files (vocab.json/merges.txt or tokenizer.json) in {folder}")

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for chunk in _GPT2_SPLIT.findall(text):
            ids += self.encode_chunk(chunk)
        return ids

    def encode_chunk(self, chunk: str) -> list[int]:
        """One pre-tokenized piece → its ids (byte-mapped, then merged); a
        tokenizer with another split pattern calls it per piece."""
        mapped = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
        return [tid for piece in self._bpe(mapped) if (tid := self.encoder.get(piece)) is not None]

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(i, "") for i in ids)
        raw = bytearray(self.byte_decoder.get(c, ord("?") & 0xFF) for c in text)
        return raw.decode("utf-8", errors="replace")

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        text = "".join(self.decoder.get(i, "") for i in ids)
        return bytes(self.byte_decoder.get(c, ord("?") & 0xFF) for c in text)


class WhisperTokenizer:
    """Tokenizer + special-token helpers for one Whisper vocab.

    Reference: Models.swift `WhisperTokenizerWrapper` (:1205-1322).
    """

    # Languages written without inter-word spaces: word splitting must use
    # unicode boundaries instead (reference: splitToWordTokens, and
    # openai/whisper timing.py).
    _NO_SPACE_LANGS = {"zh", "ja", "th", "lo", "my", "yue"}

    def __init__(self, bpe: BPETokenizer, n_vocab: int):
        self.bpe = bpe
        space_ids = bpe.encode(" ")
        whitespace_id = space_ids[0] if space_ids else -1
        self.special = special_tokens_for_vocab(n_vocab, whitespace_id)

    @classmethod
    def from_folder(cls, folder: Union[str, Path], n_vocab: int) -> "WhisperTokenizer":
        return cls(BPETokenizer.from_folder(folder), n_vocab)

    # -- encode/decode ------------------------------------------------------

    def encode(self, text: str) -> list[int]:
        return self.bpe.encode(text)

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        sp = self.special
        if skip_special:
            ids = [i for i in ids if i < sp.eot]
            return self.bpe.decode(ids)
        out: list[str] = []
        run: list[int] = []
        for i in ids:
            if i >= sp.eot:
                if run:
                    out.append(self.bpe.decode(run))
                    run = []
                out.append(self.special_token_string(i))
            else:
                run.append(i)
        if run:
            out.append(self.bpe.decode(run))
        return "".join(out)

    def decode_with_timestamps(self, ids: Sequence[int]) -> str:
        return self.decode(ids, skip_special=False)

    def special_token_string(self, token: int) -> str:
        sp = self.special
        if token == sp.eot:
            return "<|endoftext|>"
        if token == sp.sot:
            return "<|startoftranscript|>"
        if sp.language_begin <= token < sp.language_begin + sp.n_languages:
            return f"<|{sp.language_code(token)}|>"
        if token == sp.translate:
            return "<|translate|>"
        if token == sp.transcribe:
            return "<|transcribe|>"
        if token == sp.startoflm:
            return "<|startoflm|>"
        if token == sp.startofprev:
            return "<|startofprev|>"
        if token == sp.nospeech:
            return "<|nospeech|>"
        if token == sp.notimestamps:
            return "<|notimestamps|>"
        if token >= sp.timestamp_begin:
            return f"<|{sp.timestamp_seconds(token):.2f}|>"
        return f"<|{token}|>"

    # -- word splitting (for word-level timestamps) -------------------------

    def split_to_word_tokens(
        self, tokens: Sequence[int], language: str = "en"
    ) -> tuple[list[str], list[list[int]]]:
        """Group tokens into word units.

        Reference: Models.swift `splitToWordTokens` — unicode split for
        space-less scripts, space split otherwise.
        """
        if resolve_language_code(language) in self._NO_SPACE_LANGS:
            return self._split_on_unicode(tokens)
        return self._split_on_spaces(tokens)

    def _split_on_unicode(self, tokens: Sequence[int]) -> tuple[list[str], list[list[int]]]:
        decoded_full = self.decode_with_timestamps(tokens)
        replacement = "�"
        words: list[str] = []
        word_tokens: list[list[int]] = []
        current: list[int] = []
        unicode_offset = 0
        for token in tokens:
            current.append(token)
            decoded = self.decode_with_timestamps(current)
            # flush when the partial decode is valid utf-8 (no dangling bytes)
            if replacement not in decoded or (
                unicode_offset + decoded.index(replacement) < len(decoded_full)
                and decoded_full[unicode_offset + decoded.index(replacement)] == replacement
            ):
                words.append(decoded)
                word_tokens.append(current)
                current = []
                unicode_offset += len(decoded)
        if current:
            words.append(self.decode_with_timestamps(current))
            word_tokens.append(current)
        return words, word_tokens

    def _split_on_spaces(self, tokens: Sequence[int]) -> tuple[list[str], list[list[int]]]:
        subwords, subword_tokens = self._split_on_unicode(tokens)
        words: list[str] = []
        word_tokens: list[list[int]] = []
        import string

        for sub, toks in zip(subwords, subword_tokens):
            special = toks and toks[0] >= self.special.eot
            with_space = sub.startswith(" ")
            punct = sub.strip() in string.punctuation
            if special or with_space or punct or not words:
                words.append(sub)
                word_tokens.append(list(toks))
            else:
                words[-1] += sub
                word_tokens[-1].extend(toks)
        return words, word_tokens


# ---------------------------------------------------------------------------
# Test/offline fallback tokenizer
# ---------------------------------------------------------------------------


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


def load_tokenizer(
    model_folder: Union[str, Path],
    n_vocab: int,
    tokenizer_folder: Optional[Union[str, Path]] = None,
) -> WhisperTokenizer:
    """Search-path tokenizer load (reference: ModelUtilities.swift:17-77
    `loadTokenizer` — explicit folder first, then model folder)."""
    for cand in filter(None, [tokenizer_folder, model_folder]):
        try:
            return WhisperTokenizer.from_folder(cand, n_vocab)
        except FileNotFoundError:
            continue
    raise FileNotFoundError(
        f"no tokenizer files found under {tokenizer_folder or model_folder}"
    )
