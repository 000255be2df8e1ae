"""The port's operational modules on the CPU: the loader's on-disk caches,
stage signposts and `--profile-dir` traces, the model manager and its
concurrency helpers, and the JAX package's pre-converted npz folders.

The caches must give the tree the safetensors give, bit for bit, and must
be rebuilt when a source's size or mtime or a scheme's packed format
changes; other dtypes never touch them, and a folder that cannot be written
still loads. The model manager and `CoalescingLoader` are held against the
JAX package's on the same load and prewarm functions. The npz folders are
written from the JAX converters' trees (speaker models) and from numpy
trees (TTS) and must load to the arrays they hold; a pickled `jax.Array`
leaf is refused without importing JAX.
"""

import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys
import threading
import time
import wave
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from whisperkit_tpu.cli import main as jcli
from whisperkit_tpu.core import model_manager as jmodel_manager
from whisperkit_tpu.models import pyannet as jpn
from whisperkit_tpu_torch.cli import main as cli
from whisperkit_tpu_torch.core import concurrency, model_manager, signposts
from whisperkit_tpu_torch.core.configurations import ComputeOptions, WhisperConfig
from whisperkit_tpu_torch.core.modelstate import ModelState
from whisperkit_tpu_torch.models import loader
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.models.params_npz import read_params_npz
from whisperkit_tpu_torch.models.qwen3_tts import TINY_TTS_DIMS, init_tts_params, map_tree
from whisperkit_tpu_torch.ops import quant
from whisperkit_tpu_torch.pipelines import diarize as td
from whisperkit_tpu_torch.pipelines.tts import TTSPipeline
from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
from whisperkit_tpu_torch.tools.checkpoint import write_hf_checkpoint, write_pyannote_checkpoint

REPO = Path(__file__).resolve().parent.parent
# width 128, 2 layers: the MLP stacks pass the quantizers' size threshold
DIMS = model.WhisperDims(80, 207, 1500, 128, 4, 2, 64, 128, 4, 2)
SMALL_BLOCKS = {"layer1": 2, "layer2": 2, "layer3": 2, "layer4": 2}


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    folder = tmp_path_factory.mktemp("whisper")
    write_hf_checkpoint(folder, DIMS, model.init_params(0, DIMS, torch.float32, "cpu"))
    return folder


@pytest.fixture
def folder(source, tmp_path):
    return Path(shutil.copytree(source, tmp_path / "ckpt"))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{path}/{i}").items()}
    if isinstance(tree, torch.nn.Module):
        return {f"{path}.{k}": v for k, v in tree.state_dict().items()}
    return {path: tree}


def _assert_bit_equal(ours, ref):
    a, b = _flat(ours), _flat(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


class _Spy:
    """Counts calls of a module function, or makes them fail."""

    def __init__(self, monkeypatch, mod, name, fail=False):
        self.calls, self.fn, self.fail = 0, getattr(mod, name), fail
        monkeypatch.setattr(mod, name, self)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.fail:
            raise AssertionError("called")
        return self.fn(*args, **kwargs)


def _cache_files(folder):
    return sorted(p.name for p in folder.iterdir() if p.name.startswith("torch_"))


# ---------------------------------------------------------------------------
# the loader's caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantization", [None, "w8a16", "w4a16", "w8a8"])
def test_cache_hit_is_bit_equal(folder, monkeypatch, quantization):
    """The first bf16 load writes the converted cache (and the scheme's
    quantized cache); the second reads it without parsing the safetensors
    or quantizing, and gives the first load's tree bit for bit; w8a8 shares
    w8a16's cache."""
    first = loader.load_whisper(folder, quantization=quantization, device="cpu")
    scheme = {"w8a8": "w8a16"}.get(quantization, quantization)
    written = ["torch_converted.json", "torch_converted.pt"]
    if scheme:
        written += [f"torch_quantized_{scheme}.json", f"torch_quantized_{scheme}.pt"]
    assert _cache_files(folder) == sorted(written)
    record = json.loads((folder / f"torch_{'quantized_' + scheme if scheme else 'converted'}.json").read_text())
    assert record["_source"] == [[p.name, p.stat().st_size, p.stat().st_mtime_ns]
                                 for p in (folder / "model.safetensors", folder / "config.json")]
    assert record.get("_quant_format") == (quant.quant_format(scheme) if scheme else None)
    _Spy(monkeypatch, loader, "_read_safetensors", fail=True)
    _Spy(monkeypatch, quant, "quantize_whisper_params", fail=True)
    again = loader.load_whisper(folder, quantization=quantization, device="cpu")
    assert again[0] == first[0] == DIMS
    _assert_bit_equal(again[1], first[1])
    assert again[1]["decoder"]["token_embed"].dtype == torch.bfloat16


def test_pipeline_load_hits_the_cache(folder, monkeypatch):
    """WhisperPipeline(model_folder) as W8A16 serving: the second pipeline
    loads from the quantized cache, equal to the first."""
    config = WhisperConfig(model_folder=str(folder), compute_options=ComputeOptions.serving(quantization="w8a16"))
    first = WhisperPipeline(config, device="cpu")
    _Spy(monkeypatch, loader, "_read_safetensors", fail=True)
    second = WhisperPipeline(config, device="cpu")
    _assert_bit_equal(second.params, first.params)


@pytest.mark.parametrize("change", ["mtime", "size", "weights"])
def test_cache_rebuilt_when_a_source_changes(folder, monkeypatch, change):
    """A safetensors file touched, grown (its mtime put back) or rewritten
    with other weights: the next load parses it again, gives the new
    tree, and rewrites both caches with the new fingerprint."""
    loader.load_whisper(folder, quantization="w8a16", device="cpu")
    st = folder / "model.safetensors"
    stat = st.stat()
    if change == "mtime":
        os.utime(st, ns=(stat.st_atime_ns, stat.st_mtime_ns + 10**9))
    elif change == "size":
        with open(st, "ab") as f:
            f.write(b"\0" * 8)
        os.utime(st, ns=(stat.st_atime_ns, stat.st_mtime_ns))
    else:
        write_hf_checkpoint(folder, DIMS, model.init_params(5, DIMS, torch.float32, "cpu"))
    parse = _Spy(monkeypatch, loader, "_read_safetensors")
    quantize = _Spy(monkeypatch, quant, "quantize_whisper_params")
    dims, params, _ = loader.load_whisper(folder, quantization="w8a16", device="cpu")
    assert (parse.calls, quantize.calls) == (1, 1)
    fresh = quant.quantize_whisper_params(loader.convert_hf_state_dict(
        loader._read_safetensors(folder), dims, torch.bfloat16, "cpu"), bits=8)
    _assert_bit_equal(params, fresh)
    for name in ("torch_converted.json", "torch_quantized_w8a16.json"):
        assert json.loads((folder / name).read_text())["_source"][0] == [
            st.name, st.stat().st_size, st.stat().st_mtime_ns]


def test_quantized_cache_requantizes_on_a_format_change(folder, monkeypatch):
    """A quantized cache recorded under another packed format is rebuilt
    from the converted cache (no parse), and records the format now."""
    first = loader.load_whisper(folder, quantization="w4a16", device="cpu")
    monkeypatch.setitem(quant.QUANT_FORMATS, "w4a16", quant.QUANT_FORMATS["w4a16"] + 1)
    _Spy(monkeypatch, loader, "_read_safetensors", fail=True)
    quantize = _Spy(monkeypatch, quant, "quantize_whisper_params")
    again = loader.load_whisper(folder, quantization="w4a16", device="cpu")
    assert quantize.calls == 1
    _assert_bit_equal(again[1], first[1])
    record = json.loads((folder / "torch_quantized_w4a16.json").read_text())
    assert record["_quant_format"] == quant.QUANT_FORMATS["w4a16"]


def test_other_dtypes_neither_read_nor_write_the_caches(folder):
    """A float32 load writes no cache, and reads none: with garbage caches
    in place it loads the safetensors' float32 tree."""
    dims, params, _ = loader.load_whisper(folder, dtype=torch.float32, quantization="w8a16", device="cpu")
    assert _cache_files(folder) == []
    loader.load_whisper(folder, quantization="w8a16", device="cpu")
    for name in ("torch_converted.pt", "torch_quantized_w8a16.pt"):
        (folder / name).write_bytes(b"garbage")
    again = loader.load_whisper(folder, dtype=torch.float32, quantization="w8a16", device="cpu")
    _assert_bit_equal(again[1], params)
    assert again[1]["decoder"]["token_embed"].dtype == torch.float32


def test_unwritable_folder_loads_and_keeps_nothing(folder, monkeypatch):
    """A folder the caches cannot be written to (the write raises as on a
    read-only folder) still loads, and keeps no cache file, partial or
    whole; an unreadable cache falls back to the sources and is rebuilt."""
    def refuse(obj, path, *args, **kwargs):
        Path(path).write_bytes(b"partial")
        raise PermissionError(13, "Read-only file system", str(path))

    reference = loader.load_whisper(folder, dtype=torch.bfloat16, quantization="w8a16", device="cpu")
    for p in folder.glob("torch_*"):
        p.unlink()
    monkeypatch.setattr(torch, "save", refuse)
    dims, params, _ = loader.load_whisper(folder, quantization="w8a16", device="cpu")
    assert _cache_files(folder) == []
    _assert_bit_equal(params, reference[1])
    monkeypatch.undo()
    loader.load_whisper(folder, quantization="w8a16", device="cpu")
    (folder / "torch_quantized_w8a16.pt").write_bytes(b"not a torch file")
    again = loader.load_whisper(folder, quantization="w8a16", device="cpu")
    _assert_bit_equal(again[1], reference[1])
    assert torch.load(folder / "torch_quantized_w8a16.pt", weights_only=True)["decoder"]["blocks"]


# ---------------------------------------------------------------------------
# signposts and --profile-dir
# ---------------------------------------------------------------------------


def test_signpost_intervals_and_summary():
    signposts.reset()
    with signposts.signpost("outer"):
        for _ in range(3):
            with signposts.signpost("inner"):
                time.sleep(0.01)
    assert len(signposts.intervals("inner")) == 3 and len(signposts.intervals("outer")) == 1
    assert signposts.intervals("outer")[0] >= sum(signposts.intervals("inner")) >= 0.03
    s = signposts.summary()
    assert s["inner"]["count"] == 3 and s["inner"]["mean_ms"] == pytest.approx(1000 * s["inner"]["total_s"] / 3)
    assert signposts.intervals("missing") == []
    signposts.reset()
    assert signposts.summary() == {}


def test_trace_session_writes_a_chrome_trace(tmp_path):
    signposts.start_trace(tmp_path / "trace")
    try:
        with pytest.raises(RuntimeError, match="already running"):
            signposts.start_trace(tmp_path / "other")
        with signposts.signpost("stage"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    finally:
        path = signposts.stop_trace()
    assert path.parent == tmp_path / "trace"
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "stage" in names and "aten::mm" in names
    with pytest.raises(RuntimeError, match="no trace"):
        signposts.stop_trace()


def _wav(path, seconds, seed):
    audio = np.random.default_rng(seed).standard_normal(int(16000 * seconds)) * 0.1
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())
    return path


def test_cli_profile_dir_traces_the_batch(source, tmp_path, capsys):
    """`transcribe --profile-dir D` runs the batch and writes a trace under
    D that json.load reads, holding the model's ops; it names the file."""
    wav = _wav(tmp_path / "a.wav", 3.0, 0)
    rc = cli.main(["transcribe", "--device", "cpu", "--model-folder", str(source), "--no-download",
                   "--audio-path", str(wav), "--language", "en", "--sample-length", "4",
                   "--profile-dir", str(tmp_path / "prof")])
    err = capsys.readouterr().err
    assert rc == 0
    traces = sorted((tmp_path / "prof").glob("*.json"))
    assert len(traces) == 1 and f"-- profiler trace written to {traces[0]}" in err
    names = {e.get("name") for e in json.load(open(traces[0]))["traceEvents"]}
    assert {"aten::conv1d", "aten::layer_norm"} <= names


@pytest.mark.parametrize("flag", ["--stream", "--stream-simulated"])
def test_cli_profile_dir_with_a_stream_exits_as_jax(flag, capsys):
    argv = ["transcribe", "--audio-path", "x.wav", "--profile-dir", "p", flag]
    assert jcli.main(argv) == cli.main(argv) == 2
    err = capsys.readouterr().err.splitlines()
    assert err[0] == err[1] == "--profile-dir is not supported with --stream/--stream-simulated"


# ---------------------------------------------------------------------------
# the model manager
# ---------------------------------------------------------------------------


def _script(manager_cls, states, prewarm_fails):
    """One lifecycle through a manager class: a failed load, a load, a
    second ensure_loaded, an unload, a load with prewarm."""
    attempts = []

    def load():
        attempts.append(1)
        if len(attempts) == 1:
            raise OSError("first load fails")
        return {"model": len(attempts)}

    def prewarm(m):
        if prewarm_fails:
            raise RuntimeError("prewarm fails")
        m["warm"] = True

    mgr = manager_cls(load, prewarm, lambda old, new: states.append((str(old), str(new))))
    with pytest.raises(OSError):
        mgr.ensure_loaded()
    out = [str(mgr.state), mgr.ensure_loaded(), mgr.ensure_loaded(prewarm=True)]
    mgr.unload()
    out += [str(mgr.state), mgr.ensure_loaded(prewarm=True), str(mgr.state)]
    return out


@pytest.mark.parametrize("prewarm_fails", [False, True], ids=["prewarm", "prewarm_fails"])
def test_model_manager_matches_jax(prewarm_fails):
    """The same lifecycle through both managers: the same results and the
    same state transitions; a failed prewarm still ends LOADED."""
    ours, ref = [], []
    a = _script(model_manager.ModelManager, ours, prewarm_fails)
    b = _script(jmodel_manager.ModelManager, ref, prewarm_fails)
    assert a == b and ours == ref
    assert a[-1] == "loaded" and a[-2] == ({"model": 3} if prewarm_fails else {"model": 3, "warm": True})
    assert ("loading", "prewarming") in ours and ours[-1] == ("prewarming", "loaded")


def test_concurrent_ensure_loaded_coalesces_into_one_load():
    """Twelve threads (more than the cores) ask at once, with a short
    switch interval: one load runs, every caller gets its result."""
    loads = []

    def load():
        loads.append(threading.get_ident())
        time.sleep(0.2)
        return object()

    mgr = model_manager.ModelManager(load)
    results = [None] * 12
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, mgr.ensure_loaded()))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(loads) == 1 and all(r is results[0] for r in results) and mgr.state is ModelState.LOADED


def test_property_lock_keeps_every_update():
    lock = concurrency.PropertyLock(0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda: [lock.with_lock(lambda v: v + 1) for _ in range(500)])
                   for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and lock.get() == 6000
    lock.set(-1)
    assert lock.get() == -1


def test_model_manager_over_the_pipeline_load(source):
    """A ModelManager whose load builds a WhisperPipeline from a folder and
    whose prewarm is the pipeline's: four threads, one load."""
    built = []

    def load():
        built.append(1)
        return WhisperPipeline(WhisperConfig(model_folder=str(source)), device="cpu")

    mgr = model_manager.ModelManager(load, lambda p: p.prewarm())
    out = [None] * 4
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, mgr.ensure_loaded(prewarm=True)))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1 and all(p is out[0] for p in out) and out[0].model_state is ModelState.LOADED
    assert mgr.state is ModelState.LOADED and mgr.load_time > 0


# ---------------------------------------------------------------------------
# the JAX package's pre-converted npz folders
# ---------------------------------------------------------------------------


def _np_tree(tree):
    """A tree of torch tensors as numpy, bf16 as ml_dtypes' bfloat16 (as a
    JAX tree saved with jax.tree.map(np.asarray, ...) holds it)."""
    return map_tree(lambda _, t: t.float().numpy().astype(ml_dtypes.bfloat16) if t.dtype == torch.bfloat16
                    else t.numpy(), tree)


def _assert_holds(ours, ref_np):
    a, b = _flat(ours), {k: np.asarray(v) for k, v in _flat(ref_np).items()}
    assert sorted(a) == sorted(b)
    for k in a:
        ref = b[k].astype(np.float32) if b[k].dtype == ml_dtypes.bfloat16 else b[k]
        np.testing.assert_array_equal(a[k].float().numpy() if a[k].is_floating_point() else a[k].numpy(), ref,
                                      err_msg=k)


@pytest.mark.parametrize("variant", ["w32a32", "w8a16"])
def test_speaker_npz_pair_loads_the_trees_it_holds(tmp_path, monkeypatch, variant):
    """segmenter.npz + embedder.npz of the JAX converters' trees: the port's
    from_pretrained holds them, in the variant asked for, and agrees with
    its own load of the torch checkpoints they were converted from."""
    seg_ckpt, emb_ckpt = write_pyannote_checkpoint(tmp_path / "torch", seed=0, full=False)
    monkeypatch.setattr(jpn, "RESNET34_BLOCKS", SMALL_BLOCKS)
    trees = {"segmenter": jax.tree.map(np.asarray, jpn.load_pyannote_segmentation(seg_ckpt)),
             "embedder": jax.tree.map(np.asarray, jpn.load_wespeaker_resnet34(emb_ckpt))}
    (tmp_path / "npz").mkdir()
    for name, tree in trees.items():
        np.savez(tmp_path / "npz" / f"{name}.npz", params=tree)
    pipe = td.DiarizePipeline.from_pretrained(tmp_path / "npz", variant=variant, device="cpu")
    assert (pipe.segmenter_backend, pipe.embedder_backend) == ("pyannet", "resnet")
    direct = td.DiarizePipeline(
        segmenter_params=td.DiarizePipeline.apply_variant(td.params_from_numpy(trees["segmenter"]), variant),
        embedder_params=td.DiarizePipeline.apply_variant(td.params_from_numpy(trees["embedder"]), variant),
        device="cpu")
    _assert_bit_equal(pipe.segmenter_params, direct.segmenter_params)
    _assert_bit_equal(pipe.embedder_params, direct.embedder_params)
    if variant == "w32a32":
        _assert_holds({"s": pipe.embedder_params}, {"s": trees["embedder"]})
    ported = td.DiarizePipeline.from_pretrained(tmp_path / "torch", variant=variant, device="cpu")
    a, b = _flat(pipe.segmenter_params), _flat(ported.segmenter_params)
    for k in a:
        torch.testing.assert_close(a[k].float(), b[k].float(), rtol=1e-6, atol=1e-6, msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tts_npz_loads_the_tree_it_holds(tmp_path, dtype):
    tree = _np_tree(init_tts_params(torch.Generator().manual_seed(0), TINY_TTS_DIMS, dtype, "cpu"))
    np.savez(tmp_path / "qwen3_tts.npz", params=tree)
    pipe = TTSPipeline.from_pretrained(str(tmp_path), device="cpu")
    _assert_holds(pipe.params, tree)
    assert pipe.params["text_embed"].dtype == dtype and pipe.dims == TINY_TTS_DIMS
    with pytest.raises(FileNotFoundError, match="qwen3_tts.npz"):
        TTSPipeline.from_pretrained(str(tmp_path / "empty"), device="cpu")


def test_npz_with_other_leaves_is_refused(tmp_path):
    """A leaf that is not a numpy array is named; a params entry that is
    not a pickled tree is refused."""
    np.savez(tmp_path / "a.npz", params={"w": np.ones(2, np.float32), "blocks": [{"g": 1.5}]})
    with pytest.raises(TypeError, match=r"params\['blocks'\]\[0\]\['g'\] is a float"):
        read_params_npz(tmp_path / "a.npz")
    np.savez(tmp_path / "b.npz", params=np.ones(3))
    with pytest.raises(ValueError, match="not a pickled tree"):
        read_params_npz(tmp_path / "b.npz")
    np.savez(tmp_path / "segmenter.npz", params={"w": jax.numpy.ones(2)})
    with pytest.raises(pickle.UnpicklingError, match="jax.Array"):
        read_params_npz(tmp_path / "segmenter.npz")


def test_npz_with_a_jax_array_is_refused_without_importing_jax(tmp_path):
    np.savez(tmp_path / "qwen3_tts.npz", params={"w": jax.numpy.ones(2)})
    code = (
        "import pickle, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib'):\n"
        "            raise ImportError(name + ' is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from whisperkit_tpu_torch.pipelines.tts import TTSPipeline\n"
        "try:\n"
        f"    TTSPipeline.from_pretrained({str(tmp_path)!r}, device='cpu')\n"
        "except pickle.UnpicklingError as e:\n"
        "    assert 'jax.Array' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('loaded')\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')]\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_cache_record_names_what_it_keys_on(folder):
    """The sidecar holds the dims the tree was built for, the sources'
    (name, size, mtime_ns) and the scheme's format, and nothing else."""
    loader.load_whisper(folder, quantization="w8a16", device="cpu")
    record = json.loads((folder / "torch_quantized_w8a16.json").read_text())
    assert set(record) == {f.name for f in dataclasses.fields(model.WhisperDims)} | {"_source", "_quant_format"}
    assert loader.cache_paths(folder, "w8a16") == (folder / "torch_quantized_w8a16.pt",
                                                   folder / "torch_quantized_w8a16.json")
