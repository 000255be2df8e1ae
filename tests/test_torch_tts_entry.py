"""The port's TTS entry points against the JAX package's on the CPU: one
Qwen3-TTS folder written by tools/checkpoint.write_qwen3_tts_checkpoint
loads into equal trees through both loaders, a folder missing a component
raises in both, the port's Qwen tokenizer (its own BPE) encodes as the
`tokenizers` library does, and `python -m whisperkit_tpu_torch.cli tts`
writes the pipeline's WAV.
"""

import dataclasses
import json
import wave

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

from whisperkit_tpu.core.errors import ModelsUnavailable as JModelsUnavailable  # noqa: E402
from whisperkit_tpu.models import qwen3_loader as jloader  # noqa: E402
from whisperkit_tpu.ops import quant as jquant  # noqa: E402
from whisperkit_tpu.pipelines import tts as jtts  # noqa: E402
from whisperkit_tpu_torch.cli import main as cli  # noqa: E402
from whisperkit_tpu_torch.core.errors import ModelsUnavailable  # noqa: E402
from whisperkit_tpu_torch.models import qwen3_loader as tloader  # noqa: E402
from whisperkit_tpu_torch.models import qwen3_tts as tm  # noqa: E402
from whisperkit_tpu_torch.ops import quant as tquant  # noqa: E402
from whisperkit_tpu_torch.pipelines import tts as ttts  # noqa: E402
from whisperkit_tpu_torch.tools.checkpoint import (  # noqa: E402
    qwen3_tts_state_dict,
    write_qwen3_tts_checkpoint,
    write_safetensors,
)

# TINY_TTS_DIMS with the text track's published pad and BOS ids, which a
# folder's config cannot carry, inside its text vocabulary
DIMS = dataclasses.replace(tm.TINY_TTS_DIMS, text_vocab=tm.TEXT_BOS + 8, text_pad=tm.TEXT_PAD, text_bos=tm.TEXT_BOS)
CPU = "cpu"
MIXED = "Hello, world! Ünïcödé café — 日本語のテキスト, 한국어, Ελληνικά; 12345 it's x² ½.\n\n  tabs\tand  spaces "


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    path = tmp_path_factory.mktemp("qwen3-tts")
    write_qwen3_tts_checkpoint(path, DIMS, seed=0)
    return path


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x).astype(np.float32) if x.dtype == jnp.bfloat16 else np.asarray(x),
                        tree)


def _torch_np(tree):
    return tm.map_tree(lambda _, t: t.float().numpy() if t.is_floating_point() else t.numpy(), tree)


def _assert_trees_equal(ours, ref):
    flat, ref_flat = jax.tree.leaves_with_path(ours), jax.tree.leaves_with_path(ref)
    assert [p for p, _ in flat] == [p for p, _ in ref_flat]
    for (path, a), (_, b) in zip(flat, ref_flat):
        assert a.shape == b.shape and np.array_equal(_torch_np(a) if isinstance(a, torch.Tensor) else a, b), path


def test_written_folder_loads_equal_in_both(folder):
    """Dims and every leaf equal, unquantized (bf16, Code2Wav in float32)
    and after W8A16 and W4A16."""
    jdims, jparams = jloader.load_qwen3_tts(folder)
    dims, params = tloader.load_qwen3_tts(folder, device=CPU)
    assert dataclasses.asdict(dims) == dataclasses.asdict(jdims) == dataclasses.asdict(DIMS)
    assert params["blocks"]["wq"].dtype == torch.bfloat16 and params["c2w"]["blocks"]["wq"].dtype == torch.float32
    _assert_trees_equal(params, _np(jparams))
    for bits in (8, 4):
        _assert_trees_equal(tquant.quantize_tts_params(params, bits=bits),
                            _np(jquant.quantize_tts_params(jparams, bits=bits)))
    # the pipeline reads the folder (and its tokenizer) the same way
    pipe = ttts.TTSPipeline.from_pretrained(str(folder), device=CPU, quantize="w4a16")
    assert isinstance(pipe.tokenizer, ttts.HFTTSTokenizer) and "w_q4" in pipe.params["code0_head"]
    assert pipe.dims == dims


@pytest.mark.parametrize("cut", ["component", "tensor"])
def test_folder_missing_a_component_raises_in_both(folder, tmp_path, cut):
    """A component wholly absent raises in both loaders (unless
    allow_partial, which random-initialises it); one named in part raises
    even then."""
    from whisperkit_tpu_torch.models.loader import _read_safetensors_file

    tensors = dict(_read_safetensors_file(folder / "model.safetensors"))
    if cut == "component":
        tensors = {k: v for k, v in tensors.items() if not k.startswith("code2wav.")}
    else:
        del tensors["talker.code_predictor.lm_head.7.weight"]
    (tmp_path / "config.json").write_text((folder / "config.json").read_text())
    write_safetensors(tmp_path / "model.safetensors", tensors)
    match = "speech decoder" if cut == "component" else "code-predictor checkpoint incomplete"
    with pytest.raises(ModelsUnavailable, match=match):
        tloader.load_qwen3_tts(tmp_path, device=CPU)
    with pytest.raises(JModelsUnavailable, match=match):
        jloader.load_qwen3_tts(tmp_path)
    if cut == "component":
        dims, params = tloader.load_qwen3_tts(tmp_path, device=CPU, allow_partial=True)
        assert params["c2w"]["blocks"]["wq"].shape[0] == dims.c2w.n_layer
    else:
        with pytest.raises(ModelsUnavailable):
            tloader.load_qwen3_tts(tmp_path, device=CPU, allow_partial=True)


def test_state_dict_names_are_the_hf_ones(folder):
    """The writer's names are the ones the loaders probe: a bare backbone
    prefix and lm_head-named code0 head load too."""
    dims, params = tloader.load_qwen3_tts(folder, device=CPU)
    sd = qwen3_tts_state_dict(params, dims)
    renamed = {(k.replace("talker.model.layers.", "model.layers.").replace("talker.codec_head.", "lm_head.")
                .replace("talker.model.norm.", "model.norm.")): v for k, v in sd.items()}
    again = tloader.convert_backbone_state_dict(renamed, dims, torch.bfloat16, tloader.BACKBONE_PREFIXES, CPU)
    _assert_trees_equal(again["blocks"], _torch_np(params["blocks"]))


def _train_tokenizer(path):
    """A small byte-level BPE trained by `tokenizers` itself, with Qwen2's
    NFC normaliser, split and byte-level pre-tokenizer, and the chat
    template's added tokens."""
    from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(ttts.QWEN2_SPLIT_PATTERN), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    corpus = [MIXED, "<|im_start|>assistant\n", "the quick brown fox jumps over the lazy dog " * 3,
              "Speak slowly and clearly, please. ", "日本語 テキスト 한국어 café naïve"] * 20
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=400, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False))
    tok.add_special_tokens(["<|endoftext|>", "<|im_start|>", "<|im_end|>"])
    tok.save(str(path))


@pytest.mark.parametrize("source", ["trained", "written"])
def test_qwen_tokenizer_matches_tokenizers(folder, tmp_path, source):
    """HFTTSTokenizer on the port's BPE gives the `tokenizers` library's ids
    (through the JAX package's HFTTSTokenizer) on the chat-template strings
    of _chunk_tracks and on mixed-script text, for a tokenizer.json that
    `tokenizers` trained and for the writer's."""
    path = folder / "tokenizer.json"
    if source == "trained":
        path = tmp_path / "tokenizer.json"
        _train_tokenizer(path)
    ours, ref = ttts.HFTTSTokenizer(path, 10**6), jtts.HFTTSTokenizer(path, 10**6)
    texts = [ttts.TTSPipeline._ROLE_PREFIX, "<|im_start|>user\nSpeak slowly, please.<|im_end|>\n",
             "<|im_start|>user\n日本語で<|im_end|>\n<|im_start|>assistant\n", MIXED, "", "  \n", "the end.",
             "e\u0301 snake_case x\u00b2 \u0915\u093f\u0924\u093e\u092c \u0645\u0631\u062d\u0628\u0627 \U0001F600"]
    for text in texts:
        assert ours.encode(text) == ref.encode(text), text
    special = json.loads(path.read_text())["added_tokens"]
    im_start = next(t["id"] for t in special if t["content"] == "<|im_start|>")
    assert ours.encode("<|im_start|>assistant\n")[0] == im_start
    # ids at or above the model's text vocabulary are dropped, as in JAX
    small = ttts.HFTTSTokenizer(path, im_start)
    assert small.encode("<|im_start|>x") == jtts.HFTTSTokenizer(path, im_start).encode("<|im_start|>x")


def test_qwen2_split_matches_tokenizers():
    """qwen2_pieces (Qwen2's pattern in the stdlib `re`) cuts text where the
    `tokenizers` library's Split with that pattern does: on mixed-script
    text with super- and subscript digits, combining marks, '_', contractions
    and Unicode and control whitespace, and on every 251st code point that
    Python's Unicode database assigns, each in five contexts."""
    import sys
    import unicodedata

    from tokenizers import Regex, pre_tokenizers

    split = pre_tokenizers.Split(Regex(ttts.QWEN2_SPLIT_PATTERN), behavior="isolated")
    texts = [MIXED, "e\u0301 snake_case __init__ x\u00b2+y\u2083 \u2460 \u0915\u093f\u0924\u093e\u092c "
             "\u0645\u0631\u062d\u0628\u0627 \U0001F600\U0001F44D", "a\u00a0b\u3000c\u2028d\x1c e\x1f\u0085f  \t\r\n\n g",
             "I'M HERE, we'LL see 's 'S' it\u2019s"]
    for cp in range(0, sys.maxunicode + 1, 251):
        c = chr(cp)
        if not 0xD800 <= cp < 0xE000 and unicodedata.category(c) != "Cn":
            texts += [f"a{c}b", f" {c}1", f"'{c}", f"{c}{c} x", f"x {c}\n"]
    for text in texts:
        assert ttts.qwen2_pieces(text) == [piece for piece, _ in split.pre_tokenize_str(text)], repr(text)


def test_from_pretrained_refuses_a_folder_without_a_checkpoint(folder, tmp_path):
    """A folder without config.json and *.safetensors raises rather than
    run on random weights, as the port's diarization does; so does `tts`
    on it."""
    with pytest.raises(FileNotFoundError, match="no TTS checkpoint"):
        ttts.TTSPipeline.from_pretrained(str(tmp_path), device=CPU)
    (tmp_path / "config.json").write_text((folder / "config.json").read_text())
    with pytest.raises(FileNotFoundError, match="no TTS checkpoint"):
        ttts.TTSPipeline.from_pretrained(str(tmp_path), device=CPU)
    with pytest.raises(FileNotFoundError, match="no TTS checkpoint"):
        cli.main(["tts", "--device", "cpu", "--model-folder", str(tmp_path), "--text", "hi",
                  "--output-path", str(tmp_path / "x.wav")])
    assert not (tmp_path / "x.wav").exists()


def test_cli_tts_writes_the_pipelines_wav(folder, tmp_path, capsys):
    """`tts --device cpu` on the folder: exit 0, a 24 kHz mono WAV of
    frames × 1920 samples, the in-process pipeline's audio."""
    out = tmp_path / "speech.wav"
    argv = ["tts", "--device", "cpu", "--model-folder", str(folder), "--text", "Hello there, the end.",
            "--output-path", str(out), "--max-new-tokens", "6", "--temperature", "0", "--voice", "serena"]
    assert cli.main(argv) == 0
    assert f"wrote {out}" in capsys.readouterr().err
    with wave.open(str(out)) as w:
        assert (w.getframerate(), w.getnchannels(), w.getsampwidth()) == (tm.OUTPUT_SAMPLE_RATE, 1, 2)
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    assert len(pcm) == 6 * tm.SAMPLES_PER_FRAME
    pipe = ttts.TTSPipeline.from_pretrained(str(folder), device=CPU)
    ref = pipe.generate("Hello there, the end.", ttts.GenerationOptions(
        voice="serena", max_new_tokens=6, temperature=0.0))
    np.testing.assert_array_equal(pcm, (np.clip(ref.audio, -1, 1) * 32767).astype(np.int16))


def test_cli_tts_defaults_to_the_card(folder, capsys):
    """`tts` without --device on a host without a card exits 1 through the
    probe, and with the probe off the pipeline refuses the missing card:
    it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: this checks a host without one")
    assert cli.main(["tts", "--model-folder", str(folder), "--text", "hi"]) == 1
    assert "device probe failed" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["tts", "--model-folder", str(folder), "--text", "hi", "--device-probe-timeout", "0"])
