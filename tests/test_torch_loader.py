"""The port's checkpoint loader, checkpoint writer, registry and model
support matrix against the JAX package's, on the CPU.

A random-init HF `WhisperForConditionalGeneration` saved by `transformers`
(float32 safetensors) is loaded by both packages' `load_whisper` and must
give the same tensors and alignment heads for every quantization setting.
At width 128 and 2 layers the MLP stacks pass the quantizers' size
threshold and the attention stacks do not, so both branches are held.
"""

import json
import shutil
import sys
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from whisperkit_tpu.core import model_support as jmodel_support
from whisperkit_tpu.core import registry as jregistry
from whisperkit_tpu.models import loader as jloader
from whisperkit_tpu_torch.core import model_support, registry
from whisperkit_tpu_torch.core.configurations import ComputeOptions, WhisperConfig
from whisperkit_tpu_torch.core.errors import ModelsUnavailable
from whisperkit_tpu_torch.models import loader
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
from whisperkit_tpu_torch.text.tokenizer import FakeTokenizer, WhisperTokenizer
from whisperkit_tpu_torch.tools import checkpoint
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

HF_CFG = dict(
    vocab_size=207, num_mel_bins=80, d_model=128, encoder_layers=2, encoder_attention_heads=4,
    decoder_layers=2, decoder_attention_heads=4, encoder_ffn_dim=512, decoder_ffn_dim=512,
    max_source_positions=150, max_target_positions=64, pad_token_id=0, bos_token_id=1,
    eos_token_id=2, decoder_start_token_id=3, suppress_tokens=[], begin_suppress_tokens=[],
)
HEADS = [[1, 3], [0, 2], [1, 0]]
DIMS = model.WhisperDims(80, 207, 1500, 64, 4, 2, 448, 64, 4, 2)


@pytest.fixture(scope="module")
def hf_folder(tmp_path_factory):
    from transformers import WhisperConfig as HFWhisperConfig
    from transformers import WhisperForConditionalGeneration

    torch.manual_seed(0)
    folder = tmp_path_factory.mktemp("hf_whisper")
    WhisperForConditionalGeneration(HFWhisperConfig(**HF_CFG)).save_pretrained(folder, safe_serialization=True)
    gen = json.loads((folder / "generation_config.json").read_text())
    gen["alignment_heads"] = HEADS
    (folder / "generation_config.json").write_text(json.dumps(gen))
    return folder


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


def _flat(tree):
    """{path: float32/int numpy array} of a JAX-layout numpy tree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, x in leaves:
        x = np.asarray(x)
        out[jax.tree_util.keystr(path)] = x.astype(np.float32) if x.dtype.kind == "V" or "bfloat16" in str(
            x.dtype) else x
    return out


def _assert_same_tree(ours: dict, ref: dict) -> None:
    a, b = _flat(model.params_to_numpy(ours)), _flat(jax.tree.map(np.asarray, ref))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_read_safetensors_matches_safe_open(hf_folder, tmp_path):
    """Every tensor of a transformers folder, of a sharded folder, and of a
    BF16/F16/integer file reads as `safetensors.safe_open` reads it."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    def check(folder):
        ours = loader._read_safetensors(folder)
        n = 0
        for f in sorted(folder.glob("*.safetensors")):
            with safe_open(str(f), framework="pt") as sf:
                for key in sf.keys():
                    ref = sf.get_tensor(key)
                    assert ours[key].dtype == ref.dtype and torch.equal(ours[key], ref), key
                    n += 1
        assert n == len(ours) > 0

    check(hf_folder)
    rng = np.random.default_rng(0)
    tensors = {
        "a.bf16": torch.from_numpy(rng.standard_normal((3, 5), np.float32)).bfloat16(),
        "b.f16": torch.from_numpy(rng.standard_normal((7,), np.float32)).half(),
        "c.i8": torch.from_numpy(rng.integers(-128, 127, (4, 4), np.int8)),
        "d.u8": torch.from_numpy(rng.integers(0, 255, (2, 3, 2), np.uint8)),
        "e.i64": torch.arange(5),
        "f.scalar": torch.tensor(2.5),
        "g.empty": torch.zeros((0, 3)),
    }
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    save_file({k: tensors[k] for k in list(tensors)[:4]}, str(sharded / "model-00001-of-00002.safetensors"))
    save_file({k: tensors[k] for k in list(tensors)[4:]}, str(sharded / "model-00002-of-00002.safetensors"))
    check(sharded)
    # the port's writer is read back by safe_open too
    checkpoint.write_safetensors(tmp_path / "ours.safetensors", tensors)
    with safe_open(str(tmp_path / "ours.safetensors"), framework="pt") as sf:
        assert sorted(sf.keys()) == sorted(tensors)
        for k in tensors:
            assert torch.equal(sf.get_tensor(k), tensors[k]), k


@pytest.mark.parametrize("quantization", [None, "w8a16", "w4a16", "w8a8"])
def test_pipeline_load_matches_jax_load_whisper(hf_folder, tmp_path, quantization):
    """`WhisperPipeline(WhisperConfig(model_folder=...))` (the port's
    load_models → load_whisper) holds JAX's load_whisper tree, bit for bit,
    and its alignment heads; w8a8 loads the w8a16 tree and sets the int8
    encoder activations. With no tokenizer files, FakeTokenizer."""
    folder = _copy(hf_folder, tmp_path / "ckpt")
    jdims, jparams, jheads = jloader.load_whisper(folder, quantization=quantization)
    pipe = WhisperPipeline(
        WhisperConfig(model_folder=str(folder), compute_options=ComputeOptions(quantization=quantization)),
        device="cpu",
    )
    assert pipe.dims == model.WhisperDims(*[getattr(jdims, f) for f in model.WhisperDims.__dataclass_fields__])
    _assert_same_tree(pipe.params, jparams)
    np.testing.assert_array_equal(pipe.alignment_heads, jheads)
    assert pipe.alignment_heads.dtype == jheads.dtype == np.int32
    assert pipe._act8 == (quantization == "w8a8")
    assert isinstance(pipe.tokenizer, FakeTokenizer)
    assert str(pipe.model_state) == "loaded" and pipe.timings.model_loading > 0
    if quantization is not None:
        fc1 = pipe.params["encoder"]["blocks"][0]["fc1"]
        assert ("w_q4" if quantization == "w4a16" else "w_q") in fc1  # 2·128·512 ≥ 2^16
        assert "w" in pipe.params["encoder"]["blocks"][0]["attn"]["q"]  # 2·128·128 < 2^16


def test_load_whisper_float32_matches_jax(hf_folder):
    dims, params, heads = loader.load_whisper(hf_folder, dtype=torch.float32, device="cpu")
    jdims, jparams, jheads = jloader.load_whisper(hf_folder, dtype=jax.numpy.float32)
    _assert_same_tree(params, jparams)
    np.testing.assert_array_equal(heads, jheads)
    assert params["decoder"]["token_embed_f32"] is params["decoder"]["token_embed"]


def test_loading_ignores_the_jax_caches(hf_folder, tmp_path):
    """A folder where the JAX loader left its converted and quantized caches
    (beside the port's own) loads the same tensors in the port, which
    touches none of JAX's files: the JAX caches are made unreadable and the
    port's own caches deleted first, so the port must parse the
    safetensors, and it writes only its own `torch_*` caches."""
    folder = _copy(hf_folder, tmp_path / "cached")
    clean = loader.load_whisper(folder, quantization="w8a16", device="cpu")
    jloader.load_whisper(folder)
    jloader.load_whisper(folder, quantization="w8a16")
    caches = sorted(p.name for p in folder.iterdir() if "orbax" in p.name or p.name.endswith("_dims.json"))
    assert {"converted.orbax", "converted_dims.json", "quantized_w8a16.orbax"} <= set(caches)
    for name in caches:
        if name.endswith(".json"):
            (folder / name).write_text("{not json")
    for p in folder.glob("torch_*"):
        p.unlink()
    before = {str(p): p.stat().st_mtime_ns for p in folder.rglob("*")}
    again = loader.load_whisper(folder, quantization="w8a16", device="cpu")
    after = {str(p): p.stat().st_mtime_ns for p in folder.rglob("*")}
    assert {k: v for k, v in after.items() if not Path(k).name.startswith("torch_")} == before
    assert sorted(Path(k).name for k in set(after) - set(before)) == [
        "torch_converted.json", "torch_converted.pt", "torch_quantized_w8a16.json", "torch_quantized_w8a16.pt"]
    assert again[0] == clean[0]
    a, b = _flat(model.params_to_numpy(again[1])), _flat(model.params_to_numpy(clean[1]))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_write_hf_checkpoint_round_trips(tmp_path, dtype):
    """write_hf_checkpoint is the inverse of convert_hf_state_dict: the
    folder loads back bit for bit with its heads, the file holds the tree's
    dtype, and transformers loads it with no missing or unexpected keys."""
    from transformers import WhisperForConditionalGeneration

    params = model.init_params(3, DIMS, dtype, "cpu")
    n = checkpoint.write_hf_checkpoint(tmp_path, DIMS, params, alignment_heads=HEADS)
    assert n == (tmp_path / "model.safetensors").stat().st_size
    header = json.loads((tmp_path / "model.safetensors").read_bytes()[8:][: int.from_bytes(
        (tmp_path / "model.safetensors").read_bytes()[:8], "little")])
    assert {v["dtype"] for k, v in header.items() if k != "__metadata__"} == {
        "F32" if dtype == torch.float32 else "BF16"}
    dims, loaded, heads = loader.load_whisper(tmp_path, dtype=dtype, device="cpu")
    assert dims == DIMS and heads.tolist() == HEADS
    ours, ref = _flat(model.params_to_numpy(loaded)), _flat(model.params_to_numpy(params))
    assert sorted(ours) == sorted(ref)
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    hf, info = WhisperForConditionalGeneration.from_pretrained(tmp_path, output_loading_info=True)
    assert info["missing_keys"] == [] and info["unexpected_keys"] == []
    assert torch.equal(hf.proj_out.weight, hf.model.decoder.embed_tokens.weight)
    assert torch.equal(hf.model.encoder.layers[1].fc1.weight.to(dtype), params["encoder"]["blocks"][1]["fc1"]["w"].T)


def test_written_checkpoint_matches_jax_load(tmp_path):
    """The port's writer gives a folder that the JAX loader reads to the
    same tree as the port's."""
    params = model.init_params(4, DIMS, torch.float32, "cpu")
    checkpoint.write_hf_checkpoint(tmp_path, DIMS, params)
    _, jparams, jheads = jloader.load_whisper(tmp_path, dtype=jax.numpy.float32)
    _assert_same_tree(params, jparams)
    assert jheads is None


def test_synthetic_tokenizer_fills_the_regular_ids(tmp_path):
    checkpoint.write_synthetic_tokenizer(tmp_path, 51866)
    vocab = json.loads((tmp_path / "vocab.json").read_text(encoding="utf-8"))
    assert sorted(vocab.values()) == list(range(50257))  # every id below EOT
    tok = WhisperTokenizer.from_folder(tmp_path, 51866)
    assert tok.special.whitespace == 220  # GPT-2's id of " "
    for text in (" hello world", "¿dónde está? 日本語", " t1 t2"):
        ids = tok.encode(text)
        assert max(ids) < tok.special.eot and tok.decode(ids) == text
    small = tmp_path / "small"
    checkpoint.write_synthetic_tokenizer(small, 207)
    assert len(json.loads((small / "vocab.json").read_text(encoding="utf-8"))) == 189


def test_load_errors(hf_folder, tmp_path):
    with pytest.raises(ValueError, match="quantization"):
        loader.load_whisper(hf_folder, quantization="w2a16", device="cpu")
    empty = tmp_path / "empty"
    empty.mkdir()
    shutil.copy(hf_folder / "config.json", empty)
    with pytest.raises(ModelsUnavailable, match="no .safetensors"):
        loader.load_whisper(empty, device="cpu")
    partial = tmp_path / "partial"
    partial.mkdir()
    shutil.copy(hf_folder / "config.json", partial)
    tensors = loader._read_safetensors(hf_folder)
    checkpoint.write_safetensors(partial / "model.safetensors", {
        k: v for k, v in tensors.items() if "fc2" not in k})
    with pytest.raises(ModelsUnavailable, match="missing tensor .*fc2"):
        loader.load_whisper(partial, device="cpu")
    bad = tmp_path / "bad.safetensors"
    raw = json.dumps({"x": {"dtype": "F8_E4M3", "shape": [1], "data_offsets": [0, 1]}}).encode()
    bad.write_bytes(len(raw).to_bytes(8, "little") + raw + b"\0")
    with pytest.raises(ModelsUnavailable, match="unsupported dtype"):
        loader._read_safetensors_file(bad)


# -- registry and model support ------------------------------------------------


def test_registry_resolves_like_jax(hf_folder, tmp_path):
    assert registry.resolve_model_folder(model_folder=str(hf_folder)) == jregistry.resolve_model_folder(
        model_folder=str(hf_folder))
    cached = tmp_path / "openai--whisper-tiny"
    cached.mkdir()
    for f in ("config.json", "model.safetensors"):
        shutil.copy(hf_folder / f, cached)
    for reg in (registry, jregistry):
        assert reg.resolve_model_folder(model="tiny", cache_dir=str(tmp_path), download=False) == cached
        with pytest.raises(Exception, match="download disabled") as e:
            reg.resolve_model_folder(model="base", cache_dir=str(tmp_path), download=False)
        assert type(e.value).__name__ == "ModelsUnavailable"
        with pytest.raises(Exception, match="does not exist"):
            reg.resolve_model_folder(model_folder=str(tmp_path / "nope"))
    for args in ((51866, 1280, 32), (51866, 1280, 4), (51866, 1280, 2), (51865, 1280, 32), (51864, 384, 4),
                 (51865, 768, 12)):
        assert registry.detect_variant(*args) == jregistry.detect_variant(*args)
    assert registry.read_model_config(hf_folder) == jregistry.read_model_config(hf_folder)
    assert registry.WHISPER_VARIANTS == jregistry.WHISPER_VARIANTS


@pytest.mark.parametrize("hub", ["missing", "offline"])
def test_registry_download_offline_raises_promptly(tmp_path, monkeypatch, hub):
    """download=True on an uncached model raises ModelsUnavailable within
    seconds: without huggingface_hub, and when its download fails for want
    of a network. The hub is a stand-in here, so nothing leaves the host."""
    calls = []
    if hub == "missing":
        monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    else:
        def snapshot_download(repo, **kw):
            calls.append((repo, kw))
            raise OSError("network is unreachable")

        monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(snapshot_download=snapshot_download))
    t0 = time.perf_counter()
    with pytest.raises(ModelsUnavailable):
        registry.resolve_model_folder(model="large-v3", cache_dir=str(tmp_path), download=True)
    assert time.perf_counter() - t0 < 5.0
    if hub == "offline":
        (repo, kw), = calls
        assert repo == "openai/whisper-large-v3" and kw["etag_timeout"] == registry.DOWNLOAD_TIMEOUT_S
        assert kw["local_dir"] == str(tmp_path / "openai--whisper-large-v3")
    # the pipeline surfaces it the same way (a model name and no folder)
    monkeypatch.setattr(registry, "DEFAULT_CACHE_DIR", str(tmp_path))
    with pytest.raises(ModelsUnavailable):
        WhisperPipeline(WhisperConfig(model="large-v3"), device="cpu")
    assert len(calls) == (2 if hub == "offline" else 0)


@pytest.mark.parametrize("identifier", [None, "cpu", "tpu-v5e", "tpu", "nvidia-h100-80gb-hbm3", "something"])
def test_model_support_matches_jax(identifier):
    """The matrix is the JAX package's: the same row for every identifier
    (an unknown one, a card's included, takes the first row)."""
    ours = model_support.ModelSupportConfig.fallback().model_support(identifier or "cpu")
    ref = jmodel_support.ModelSupportConfig.fallback().model_support(identifier or "cpu")
    assert (ours.default, ours.supported, ours.disabled) == (ref.default, ref.supported, ref.disabled)
    assert model_support.recommended_model(identifier or "cpu") == jmodel_support.recommended_model(identifier or "cpu")
    assert model_support.current_device_identifier("cpu") == "cpu"


def test_model_support_remote_config_merge(tmp_path):
    cfg = {"device_support": [{"identifiers": ["cpu"], "models": {"default": "base", "supported": ["base"]}},
                              {"identifiers": ["nvidia-h100"], "models": {"default": "large-v3"}}]}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    ours, ref = model_support.ModelSupportConfig.from_json(path), jmodel_support.ModelSupportConfig.from_json(path)
    for ident in ("cpu", "nvidia-h100-80gb-hbm3", "tpu-v5e"):
        assert ours.model_support(ident).default == ref.model_support(ident).default
