"""The port's tokenizer (text/tokenizer.py, the whole JAX module) against
the JAX package's, on the CPU.

The cases of tests/test_tokenizer.py run against both packages
(parametrised), then both packages' BPE and Whisper tokenizers are held
equal on the same vocabularies: encode, decode, `decode_with_timestamps`,
`special_token_string` and `split_to_word_tokens` on the unicode and the
space paths, with the GPT-2 split pattern of `regex` and with the stdlib
approximation that a host without `regex` takes.
"""

import json
import re

import pytest

from whisperkit_tpu.text import languages as jlanguages
from whisperkit_tpu.text import tokenizer as jtok
from whisperkit_tpu_torch.text import languages
from whisperkit_tpu_torch.text import tokenizer as tok
from whisperkit_tpu_torch.tools.checkpoint import write_synthetic_tokenizer
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

PACKAGES = {"jax": (jtok, jlanguages), "torch": (tok, languages)}
# the stdlib approximation of the GPT-2 pattern (letters ≈ [^\W\d_])
STDLIB_SPLIT = re.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+""")
TEXTS = [
    " hello world", "Hello, World! It's 2024.", "¿dónde está el baño?", "naïve café résumé",
    "日本語のテキストです", "你好，世界", "Привет, мир", "ก ข ค", " multiple   spaces\tand\ttabs ",
    "emoji 🙂 and ümlaut", "x²+y²=z² ½ ٣",
]


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture(scope="module")
def vocab_folder(tmp_path_factory):
    """A byte-level vocab of 51866 ids: 256 byte symbols and 50001 merges."""
    folder = tmp_path_factory.mktemp("bpe")
    write_synthetic_tokenizer(folder, 51866)
    return folder


# -- the cases of tests/test_tokenizer.py, on both packages ---------------------


def test_language_inventory(pkg):
    t, langs = pkg
    assert len(langs.LANGUAGES) == 100
    assert langs.LANGUAGES[0] == ("en", "english")
    assert langs.LANGUAGES[-1] == ("yue", "cantonese")
    assert langs.resolve_language_code("English") == "en"
    assert langs.resolve_language_code("burmese") == "my"
    with pytest.raises(ValueError):
        langs.resolve_language_code("klingon")


def test_special_layouts(pkg):
    t, _ = pkg
    sp = t.special_tokens_for_vocab(51864)
    assert (sp.eot, sp.sot, sp.n_languages, sp.transcribe, sp.timestamp_begin) == (50256, 50257, 99, 50358, 50363)
    assert sp.timestamp_begin + 1501 == 51864
    sp = t.special_tokens_for_vocab(51865)
    assert (sp.eot, sp.sot, sp.transcribe, sp.nospeech, sp.notimestamps, sp.timestamp_begin) == (
        50257, 50258, 50359, 50362, 50363, 50364)
    assert sp.language_token("en") == 50259 and sp.language_code(50259 + 6) == "fr"
    sp = t.special_tokens_for_vocab(51866)
    assert (sp.n_languages, sp.transcribe, sp.timestamp_begin) == (100, 50360, 50365)
    assert sp.language_token("yue") == 50258 + 1 + 99
    assert sp.timestamp_seconds(sp.timestamp_token(12.34)) == pytest.approx(12.34)


def _tiny_bpe(t):
    b2u = t.bytes_to_unicode()
    vocab = {}
    for ch in "abcdefghijklmnopqrstuvwxyz .!":
        vocab[b2u[ord(ch)]] = len(vocab)
    vocab["he"] = len(vocab)
    vocab["hel"] = len(vocab)
    vocab["lo"] = len(vocab)
    return t.BPETokenizer(vocab, [("h", "e"), ("he", "l"), ("l", "o")])


def _unicode_bpe(t):
    b2u = t.bytes_to_unicode()
    return t.BPETokenizer({ch: i for i, ch in enumerate(b2u.values())}, [])


def test_bpe_round_trip_and_spaces(pkg):
    t, _ = pkg
    bpe = _tiny_bpe(t)
    ids = bpe.encode("hello")
    assert bpe.decode(ids) == "hello" and len(ids) == 2  # hel + lo
    assert bpe.decode(bpe.encode("hello o")) == "hello o"


def test_fake_tokenizer_round_trip(pkg):
    t, _ = pkg
    fake = t.FakeTokenizer(207)
    assert fake.encode(fake.decode([1, 2, 3])) == [1, 2, 3]
    sp = fake.special
    assert sp.timestamp_begin < 207
    assert fake.decode_with_timestamps([sp.timestamp_begin, 1]).startswith("<|0.00|>")


def test_bpe_unicode_round_trip(pkg):
    t, _ = pkg
    bpe = _unicode_bpe(t)
    for text in ("héllo wörld", "こんにちは世界", "¿dónde está?"):
        assert bpe.decode(bpe.encode(text)) == text


def test_split_to_word_tokens_spaces_and_unicode(pkg):
    t, _ = pkg
    bpe = _unicode_bpe(t)
    wt = t.WhisperTokenizer(bpe, 51865)
    ids = bpe.encode(" hola mundo feliz")
    words, word_tokens = wt.split_to_word_tokens(ids, language="es")
    assert words == [" hola", " mundo", " feliz"]
    assert sum(len(x) for x in word_tokens) == len(ids)
    ids = bpe.encode("日本語です")
    words, word_tokens = wt.split_to_word_tokens(ids, language="ja")
    assert "".join(words) == "日本語です" and len(words) >= 2
    assert sum(len(x) for x in word_tokens) == len(ids)


def test_decode_with_timestamps_renders_specials(pkg):
    t, _ = pkg
    bpe = _unicode_bpe(t)
    wt = t.WhisperTokenizer(bpe, 51865)
    sp = wt.special
    ids = [sp.sot, sp.language_token("en"), sp.transcribe, sp.timestamp_begin]
    ids += bpe.encode(" hi") + [sp.timestamp_begin + 50, sp.eot]
    assert wt.decode_with_timestamps(ids) == (
        "<|startoftranscript|><|en|><|transcribe|><|0.00|> hi<|1.00|><|endoftext|>")
    assert wt.decode(ids) == " hi"


# -- the two packages against each other -----------------------------------------


@pytest.mark.parametrize("split", ["regex", "stdlib"])
def test_encode_decode_equal_on_a_full_vocab(vocab_folder, monkeypatch, split):
    if split == "stdlib":
        monkeypatch.setattr(tok, "_GPT2_SPLIT", STDLIB_SPLIT)
        monkeypatch.setattr(jtok, "_GPT2_SPLIT", STDLIB_SPLIT)
    ours = tok.WhisperTokenizer.from_folder(vocab_folder, 51866)
    ref = jtok.WhisperTokenizer.from_folder(vocab_folder, 51866)
    assert ours.special == tok.special_tokens_for_vocab(51866, ref.special.whitespace)
    for text in TEXTS:
        ids = ours.encode(text)
        assert ids == ref.encode(text), text
        assert ours.decode(ids) == ref.decode(ids) == text
        assert ours.bpe.decode_bytes(ids) == ref.bpe.decode_bytes(ids)
    sp = ours.special
    specials = [sp.eot, sp.sot, sp.language_token("yue"), sp.translate, sp.transcribe, sp.startoflm,
                sp.startofprev, sp.nospeech, sp.notimestamps, sp.timestamp_begin, sp.timestamp_begin + 1500]
    assert [ours.special_token_string(i) for i in specials] == [ref.special_token_string(i) for i in specials]


def test_split_patterns_differ_only_off_ascii():
    """Why both branches are held: the stdlib pattern splits non-ASCII
    letters and digits otherwise than the GPT-2 one."""
    if not hasattr(tok, "_rx"):
        pytest.skip("regex is not installed: only the stdlib pattern exists here")
    for text in (" hello world", "It's 2024, ok?"):
        assert STDLIB_SPLIT.findall(text) == tok._GPT2_SPLIT.findall(text)
    assert STDLIB_SPLIT.findall("x²+y² ½") != tok._GPT2_SPLIT.findall("x²+y² ½")


@pytest.mark.parametrize("split", ["regex", "stdlib"])
@pytest.mark.parametrize("language", ["en", "es", "ja", "zh", "th"])
def test_split_to_word_tokens_equal(vocab_folder, monkeypatch, split, language):
    """Both paths (unicode for ja/zh/th, spaces otherwise) give the same
    words and token groups, special and timestamp tokens included."""
    if split == "stdlib":
        monkeypatch.setattr(tok, "_GPT2_SPLIT", STDLIB_SPLIT)
        monkeypatch.setattr(jtok, "_GPT2_SPLIT", STDLIB_SPLIT)
    ours = tok.WhisperTokenizer.from_folder(vocab_folder, 51866)
    ref = jtok.WhisperTokenizer.from_folder(vocab_folder, 51866)
    sp = ours.special
    for text in TEXTS:
        ids = [sp.timestamp_begin] + ours.encode(text) + [sp.timestamp_begin + 25, sp.eot]
        words, groups = ours.split_to_word_tokens(ids, language=language)
        assert (words, groups) == ref.split_to_word_tokens(ids, language=language), text
        assert sum(groups, []) == ids
    # a token list cut inside a multi-byte character
    ids = ours.encode("日本")
    cut = ids[:-1] if len(ids) > 1 else ids
    assert ours.split_to_word_tokens(cut, language) == ref.split_to_word_tokens(cut, language)


def test_tokenizer_json_and_search_path(vocab_folder, tmp_path):
    """tokenizer.json (HF `tokenizers` layout, merges as strings or pairs)
    reads as vocab.json + merges.txt do; load_tokenizer looks in the
    tokenizer folder first, then the model folder, and raises when
    neither holds tokenizer files."""
    vocab = json.loads((vocab_folder / "vocab.json").read_text(encoding="utf-8"))
    merges = [line.rstrip("\n") for line in (vocab_folder / "merges.txt").read_text(encoding="utf-8").splitlines()
              if line and not line.startswith("#version")]
    for form, ms in (("strings", merges), ("pairs", [m.split(" ") for m in merges])):
        folder = tmp_path / form
        folder.mkdir()
        (folder / "tokenizer.json").write_text(json.dumps({"model": {"vocab": vocab, "merges": ms}}),
                                               encoding="utf-8")
        ours = tok.load_tokenizer(tmp_path / "nowhere", 51866, tokenizer_folder=folder)
        ref = jtok.load_tokenizer(tmp_path / "nowhere", 51866, tokenizer_folder=folder)
        for text in TEXTS:
            assert ours.encode(text) == ref.encode(text) == tok.load_tokenizer(vocab_folder, 51866).encode(text)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tok.load_tokenizer(empty, 51866)
    assert tok.load_tokenizer(empty, 51866, tokenizer_folder=vocab_folder).special.n_vocab == 51866


def test_module_matches_the_jax_module():
    """The copy has the JAX module's functions, classes and constants."""
    import inspect

    names = sorted(n for n, v in vars(jtok).items() if not n.startswith("__") and (
        inspect.isfunction(v) or inspect.isclass(v)) and getattr(v, "__module__", "") == jtok.__name__)
    assert names == sorted(n for n, v in vars(tok).items() if not n.startswith("__") and (
        inspect.isfunction(v) or inspect.isclass(v)) and getattr(v, "__module__", "") == tok.__name__)
    assert tok._GPT2_SPLIT.pattern == jtok._GPT2_SPLIT.pattern
    assert tok.WhisperTokenizer._NO_SPACE_LANGS == jtok.WhisperTokenizer._NO_SPACE_LANGS
    assert tok.bytes_to_unicode() == jtok.bytes_to_unicode()
