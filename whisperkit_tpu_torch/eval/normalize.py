"""Text normalization for WER evaluation (the port's copy of
whisperkit_tpu/eval/normalize.py).

Reference: Tests/WhisperKitTests/Evaluate/NormalizeEn.swift (892 LoC) +
SpellingMapping.swift (1,746 LoC) — themselves ports of openai/whisper's
published `BasicTextNormalizer` / `EnglishTextNormalizer`
(whisper/normalizers/english.py). This is a complete implementation of that
published behavior:

  * BasicTextNormalizer: strip bracketed asides, lowercase, drop
    punctuation/symbols, collapse whitespace
  * EnglishNumberNormalizer: the full spelled-number → digit state machine
    (ordinals, plurals, currency prefixes, "per cent", double/triple,
    decimal "point", "and a half", cents combination)
  * EnglishTextNormalizer: filler-word removal, contraction/title
    expansion, number standardization, and the full 1,740-entry
    British→American spelling table (eval/spelling_en.py)
"""

from __future__ import annotations

import re
import unicodedata
from fractions import Fraction
from typing import Iterator, Optional, Union

from whisperkit_tpu_torch.eval.spelling_en import SPELLING_MAPPING

# Non-ASCII letters that NFKD does not decompose (NormalizeEn.swift
# ADDITIONAL_DIACRITICS; same table in openai/whisper).
_ADDITIONAL_DIACRITICS = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    out = []
    for c in unicodedata.normalize("NFKD", s):
        if c in keep:
            out.append(c)
        elif c in _ADDITIONAL_DIACRITICS:
            out.append(_ADDITIONAL_DIACRITICS[c])
        elif unicodedata.category(c) == "Mn":
            continue
        elif unicodedata.category(c)[0] in "MSP":
            out.append(" ")
        else:
            out.append(c)
    return "".join(out)


def remove_symbols(s: str) -> str:
    return "".join(
        " " if unicodedata.category(c)[0] in "MSP" else c
        for c in unicodedata.normalize("NFKC", s)
    )


class BasicTextNormalizer:
    def __init__(self, remove_diacritics: bool = False, split_letters: bool = False):
        self.clean = (
            remove_symbols_and_diacritics if remove_diacritics else remove_symbols
        )
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # bracketed annotations
        s = re.sub(r"\(([^)]+?)\)", "", s)  # parenthesized asides
        s = self.clean(s).lower()
        if self.split_letters:
            s = " ".join(re.findall(r"\X", s, re.U))
        s = re.sub(r"\s+", " ", s)
        return s.strip()


# -- English number normalization -------------------------------------------


class EnglishNumberNormalizer:
    """Convert spelled-out numbers to Arabic numerals, keeping suffixes and
    prefixes: "one point five" → "1.5", "minus twenty percent" → "-20%",
    "a hundred and first" → "101st", "three euros and five cents" → "€3.05".

    Reference: NormalizeEn.swift `EnglishNumberNormalizer` (:83-627), the
    Swift port of openai/whisper's published state machine.
    """

    def __init__(self):
        self.zeros = {"o", "oh", "zero"}
        self.ones = {
            name: i
            for i, name in enumerate(
                "one two three four five six seven eight nine ten eleven "
                "twelve thirteen fourteen fifteen sixteen seventeen eighteen "
                "nineteen".split(),
                start=1,
            )
        }
        self.ones_plural = {
            "sixes" if name == "six" else name + "s": (value, "s")
            for name, value in self.ones.items()
        }
        self.ones_ordinal = {
            "zeroth": (0, "th"),
            "first": (1, "st"),
            "second": (2, "nd"),
            "third": (3, "rd"),
            "fifth": (5, "th"),
            "twelfth": (12, "th"),
            **{
                name + ("h" if name.endswith("t") else "th"): (value, "th")
                for name, value in self.ones.items()
                if value > 3 and value != 5 and value != 12
            },
        }
        self.ones_suffixed = {**self.ones_plural, **self.ones_ordinal}

        self.tens = {
            name: 10 * (i + 2)
            for i, name in enumerate(
                "twenty thirty forty fifty sixty seventy eighty ninety".split()
            )
        }
        self.tens_plural = {
            name.replace("y", "ies"): (value, "s")
            for name, value in self.tens.items()
        }
        self.tens_ordinal = {
            name.replace("y", "ieth"): (value, "th")
            for name, value in self.tens.items()
        }
        self.tens_suffixed = {**self.tens_plural, **self.tens_ordinal}

        self.multipliers = {
            "hundred": 100,
            "thousand": 1_000,
            "million": 1_000_000,
            "billion": 1_000_000_000,
            "trillion": 1_000_000_000_000,
            "quadrillion": 10**15,
            "quintillion": 10**18,
            "sextillion": 10**21,
            "septillion": 10**24,
            "octillion": 10**27,
            "nonillion": 10**30,
            "decillion": 10**33,
        }
        self.multipliers_plural = {
            name + "s": (value, "s") for name, value in self.multipliers.items()
        }
        self.multipliers_ordinal = {
            name + "th": (value, "th") for name, value in self.multipliers.items()
        }
        self.multipliers_suffixed = {
            **self.multipliers_plural,
            **self.multipliers_ordinal,
        }

        self.decimals = {*self.ones, *self.tens, *self.zeros}
        self.preceding_prefixers = {
            "minus": "-", "negative": "-", "plus": "+", "positive": "+",
        }
        self.following_prefixers = {
            "pound": "£", "pounds": "£", "euro": "€", "euros": "€",
            "dollar": "$", "dollars": "$", "cent": "¢", "cents": "¢",
        }
        self.prefixes = set(self.preceding_prefixers.values()) | set(
            self.following_prefixers.values()
        )
        self.suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.specials = {"and", "double", "triple", "point"}

        self.words = {
            *self.zeros, *self.ones, *self.ones_suffixed, *self.tens,
            *self.tens_suffixed, *self.multipliers,
            *self.multipliers_suffixed, *self.preceding_prefixers,
            *self.following_prefixers, *self.suffixers, *self.specials,
        }
        self.literal_words = {"one", "ones"}

    def process_words(self, words: list[str]) -> Iterator[str]:
        prefix: Optional[str] = None
        value: Optional[Union[str, int]] = None
        skip = False

        def to_fraction(s: str) -> Optional[Fraction]:
            try:
                return Fraction(s)
            except ValueError:
                return None

        def output(result: Union[str, int]) -> str:
            nonlocal prefix, value
            result = str(result)
            if prefix is not None:
                result = prefix + result
            value = None
            prefix = None
            return result

        if len(words) == 0:
            return

        for i, current in enumerate(words):
            prev = words[i - 1] if i > 0 else None
            next_ = words[i + 1] if i + 1 < len(words) else None
            if skip:
                skip = False
                continue

            next_is_numeric = next_ is not None and re.match(
                r"^\d+(\.\d+)?$", next_
            )
            has_prefix = current[0] in self.prefixes
            current_without_prefix = current[1:] if has_prefix else current

            if re.match(r"^\d+(\.\d+)?$", current_without_prefix):
                # arabic numbers (potentially with signs or decimals)
                f = to_fraction(current_without_prefix)
                if f is None:
                    raise ValueError("converting the fraction failed")
                if value is not None:
                    if isinstance(value, str) and value.endswith("."):
                        # concatenate decimals / ip address components
                        value = str(value) + str(current)
                        continue
                    else:
                        yield output(value)
                prefix = current[0] if has_prefix else prefix
                if f.denominator == 1:
                    value = f.numerator  # int if possible
                else:
                    value = current_without_prefix
            elif current not in self.words:
                # non-numeric words
                if value is not None:
                    yield output(value)
                yield output(current)
            elif current in self.zeros:
                value = str(value or "") + "0"
            elif current in self.ones:
                ones = self.ones[current]
                if value is None:
                    value = ones
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:
                        # replace the last zero with the digit
                        value = str(value)[:-1] + str(ones)
                    else:
                        value = str(value) + str(ones)
                elif ones < 10:
                    if value % 10 == 0:
                        value += ones
                    else:
                        value = str(value) + str(ones)
                else:  # eleven to nineteen
                    if value % 100 == 0:
                        value += ones
                    else:
                        value = str(value) + str(ones)
            elif current in self.ones_suffixed:
                # ordinal or cardinal; yield the number right away
                ones, suffix = self.ones_suffixed[current]
                if value is None:
                    yield output(str(ones) + suffix)
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:
                        yield output(str(value)[:-1] + str(ones) + suffix)
                    else:
                        yield output(str(value) + str(ones) + suffix)
                elif ones < 10:
                    if value % 10 == 0:
                        yield output(str(value + ones) + suffix)
                    else:
                        yield output(str(value) + str(ones) + suffix)
                else:  # eleven to nineteen
                    if value % 100 == 0:
                        yield output(str(value + ones) + suffix)
                    else:
                        yield output(str(value) + str(ones) + suffix)
                value = None
            elif current in self.tens:
                tens = self.tens[current]
                if value is None:
                    value = tens
                elif isinstance(value, str):
                    value = str(value) + str(tens)
                else:
                    if value % 100 == 0:
                        value += tens
                    else:
                        value = str(value) + str(tens)
            elif current in self.tens_suffixed:
                # ordinal or cardinal; yield the number right away
                tens, suffix = self.tens_suffixed[current]
                if value is None:
                    yield output(str(tens) + suffix)
                elif isinstance(value, str):
                    yield output(str(value) + str(tens) + suffix)
                else:
                    if value % 100 == 0:
                        yield output(str(value + tens) + suffix)
                    else:
                        yield output(str(value) + str(tens) + suffix)
            elif current in self.multipliers:
                multiplier = self.multipliers[current]
                if value is None:
                    value = multiplier
                elif isinstance(value, str) or value == 0:
                    f = to_fraction(str(value))
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        value = p.numerator
                    else:
                        yield output(value)
                        value = multiplier
                else:
                    before = value // 1000 * 1000
                    residual = value % 1000
                    value = before + residual * multiplier
            elif current in self.multipliers_suffixed:
                multiplier, suffix = self.multipliers_suffixed[current]
                if value is None:
                    yield output(str(multiplier) + suffix)
                elif isinstance(value, str):
                    f = to_fraction(str(value))
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        yield output(str(p.numerator) + suffix)
                    else:
                        yield output(value)
                        yield output(str(multiplier) + suffix)
                else:  # int
                    before = value // 1000 * 1000
                    residual = value % 1000
                    value = before + residual * multiplier
                    yield output(str(value) + suffix)
                value = None
            elif current in self.preceding_prefixers:
                # apply prefix (positive, minus, etc.) if next is numeric
                if value is not None:
                    yield output(value)
                if next_ in self.words or next_is_numeric:
                    prefix = self.preceding_prefixers[current]
                else:
                    yield output(current)
            elif current in self.following_prefixers:
                # apply prefix (dollars, cents, etc.) only after a number
                if value is not None:
                    prefix = self.following_prefixers[current]
                    yield output(value)
                else:
                    yield output(current)
            elif current in self.suffixers:
                # apply suffix symbols (percent -> '%')
                if value is not None:
                    suffixer = self.suffixers[current]
                    if isinstance(suffixer, dict):
                        if next_ in suffixer:
                            yield output(str(value) + suffixer[next_])
                            skip = True
                        else:
                            yield output(value)
                            yield output(current)
                    else:
                        yield output(str(value) + suffixer)
                else:
                    yield output(current)
            elif current in self.specials:
                if next_ not in self.words and not next_is_numeric:
                    # apply special handling only if the next word can be numeric
                    if value is not None:
                        yield output(value)
                    yield output(current)
                elif current == "and":
                    # ignore "and" after hundreds, thousands, etc.
                    if prev not in self.multipliers:
                        if value is not None:
                            yield output(value)
                        yield output(current)
                elif current in ("double", "triple"):
                    if next_ in self.ones or next_ in self.zeros:
                        repeats = 2 if current == "double" else 3
                        ones = self.ones.get(next_, 0)
                        value = str(value or "") + str(ones) * repeats
                        skip = True
                    else:
                        if value is not None:
                            yield output(value)
                        yield output(current)
                elif current == "point":
                    if next_ in self.decimals or next_is_numeric:
                        value = str(value or "") + "."
                else:  # pragma: no cover - all specials covered above
                    raise ValueError(f"unexpected token: {current}")
            else:  # pragma: no cover - all word classes covered above
                raise ValueError(f"unexpected token: {current}")

        if value is not None:
            yield output(value)

    def preprocess(self, s: str) -> str:
        # replace "<number> and a half" with "<number> point five"
        results = []
        segments = re.split(r"\band\s+a\s+half\b", s)
        for i, segment in enumerate(segments):
            if len(segment.strip()) == 0:
                continue
            if i == len(segments) - 1:
                results.append(segment)
            else:
                results.append(segment)
                last_word = segment.rsplit(maxsplit=2)[-1]
                if last_word in self.decimals or last_word in self.multipliers:
                    results.append("point five")
                else:
                    results.append("and a half")
        s = " ".join(results)
        # put a space at number/letter boundaries
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        # but remove spaces which could be a suffix
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)
        return s

    def postprocess(self, s: str) -> str:
        def combine_cents(m: re.Match) -> str:
            try:
                currency = m.group(1)
                integer = m.group(2)
                cents = int(m.group(3))
                return f"{currency}{integer}.{cents:02d}"
            except ValueError:
                return m.string

        def extract_cents(m: re.Match) -> str:
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:
                return m.string

        # apply currency postprocessing: "$2 and ¢7" → "$2.07"
        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b", combine_cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", extract_cents, s)
        # write "one(s)" instead of "1(s)", just for readability
        s = re.sub(r"\b1(s?)\b", r"one\1", s)
        return s

    def __call__(self, s: str) -> str:
        s = self.preprocess(s)
        s = " ".join(w for w in self.process_words(s.split()) if w is not None)
        s = self.postprocess(s)
        return s


class EnglishSpellingNormalizer:
    """British→American spelling via the full published mapping
    (NormalizeEn.swift:629-644; table in eval/spelling_en.py)."""

    def __init__(self, extra: Optional[dict[str, str]] = None):
        self.mapping = dict(SPELLING_MAPPING)
        if extra:
            self.mapping.update(extra)

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(word, word) for word in s.split())


class EnglishTextNormalizer:
    """Reference: NormalizeEn.swift:646-768; openai EnglishTextNormalizer."""

    IGNORE_PATTERNS = r"\b(hmm|mm|mhm|mmm|uh|um)\b"
    # ordered: specific contractions, title expansions, perfect tenses,
    # then generic clitic expansion
    REPLACERS = [
        (r"\bwon't\b", "will not"),
        (r"\bcan't\b", "can not"),
        (r"\blet's\b", "let us"),
        (r"\bain't\b", "aint"),
        (r"\by'all\b", "you all"),
        (r"\bwanna\b", "want to"),
        (r"\bgotta\b", "got to"),
        (r"\bgonna\b", "going to"),
        (r"\bi'ma\b", "i am going to"),
        (r"\bimma\b", "i am going to"),
        (r"\bwoulda\b", "would have"),
        (r"\bcoulda\b", "could have"),
        (r"\bshoulda\b", "should have"),
        (r"\bma'am\b", "madam"),
        # contractions in titles/prefixes
        (r"\bmr\b", "mister "),
        (r"\bmrs\b", "missus "),
        (r"\bst\b", "saint "),
        (r"\bdr\b", "doctor "),
        (r"\bprof\b", "professor "),
        (r"\bcapt\b", "captain "),
        (r"\bgov\b", "governor "),
        (r"\bald\b", "alderman "),
        (r"\bgen\b", "general "),
        (r"\bsen\b", "senator "),
        (r"\brep\b", "representative "),
        (r"\bpres\b", "president "),
        (r"\brev\b", "reverend "),
        (r"\bhon\b", "honorable "),
        (r"\basst\b", "assistant "),
        (r"\bassoc\b", "associate "),
        (r"\blt\b", "lieutenant "),
        (r"\bcol\b", "colonel "),
        (r"\bjr\b", "junior "),
        (r"\bsr\b", "senior "),
        (r"\besq\b", "esquire "),
        # perfect tenses (ideally any past participle, but that's harder)
        (r"'d been\b", " had been"),
        (r"'s been\b", " has been"),
        (r"'d gone\b", " had gone"),
        (r"'s gone\b", " has gone"),
        (r"'d done\b", " had done"),  # "'s done" is ambiguous
        (r"'s got\b", " has got"),
        # general contractions
        (r"n't\b", " not"),
        (r"'re\b", " are"),
        (r"'s\b", " is"),
        (r"'d\b", " would"),
        (r"'ll\b", " will"),
        (r"'t\b", " not"),
        (r"'ve\b", " have"),
        (r"'m\b", " am"),
    ]

    def __init__(self, extra_spellings: Optional[dict[str, str]] = None):
        self.number_normalizer = EnglishNumberNormalizer()
        self.spelling_normalizer = EnglishSpellingNormalizer(extra_spellings)

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # words between brackets
        s = re.sub(r"\(([^)]+?)\)", "", s)  # words between parentheses
        s = re.sub(self.IGNORE_PATTERNS, "", s)
        s = re.sub(r"\s+'", "'", s)  # space before apostrophe
        for pattern, replacement in self.REPLACERS:
            s = re.sub(pattern, replacement, s)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)  # commas between digits
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)  # periods not followed by digits
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")
        s = self.number_normalizer(s)
        s = self.spelling_normalizer(s)
        # remove prefix/suffix symbols not adjacent to numbers
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)
        s = re.sub(r"\s+", " ", s)
        return s.strip()
