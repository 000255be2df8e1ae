"""The port's speaker models and DiarizePipeline against the JAX package's,
on the CPU, with the weights carried across.

The published architectures (PyanNet with a 2-layer BiLSTM(32), WeSpeaker
ResNet with 8 base channels and blocks (2, 2, 2, 2)) come from one folder
written by `tools/checkpoint.write_pyannote_checkpoint(full=False)`: each
package's `from_pretrained` reads it, JAX with `RESNET34_BLOCKS` patched
for the small ResNet (the port counts the blocks from the keys). The conv
models (the random-init default) share one NumPy tree. The pipeline's
RTTM must be equal on both backends and all three variants.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperkit_tpu.models import pyannet as jpn
from whisperkit_tpu.models import pyannote as jpy
from whisperkit_tpu.pipelines import diarize as jd
from whisperkit_tpu_torch.models import pyannet as pn
from whisperkit_tpu_torch.models import pyannote as py
from whisperkit_tpu_torch.ops.mel import log_mel_spectrogram
from whisperkit_tpu_torch.pipelines import diarize as td
from whisperkit_tpu_torch.tools.checkpoint import write_pyannote_checkpoint
from whisperkit_tpu_torch.tools.workload import synth_speechlike_audio

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

SMALL_BLOCKS = {"layer1": 2, "layer2": 2, "layer3": 2, "layer4": 2}
VARIANTS = ("w32a32", "w16a16", "w8a16")
# float32 activations in both packages (the variants round or quantize the
# weights only): the outputs differ by summation order, ~1e-6 here
MODEL_ATOL = 1e-4


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """The small pyannote folder; JAX's converter reads it with
    RESNET34_BLOCKS patched for the whole module."""
    root = tmp_path_factory.mktemp("pyannote")
    write_pyannote_checkpoint(root, seed=0, full=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpn, "RESNET34_BLOCKS", SMALL_BLOCKS)
        yield root


@pytest.fixture(scope="module")
def audio():
    return synth_speechlike_audio(30.0, seed=1)


def carry(tree):
    """A JAX parameter tree (as NumPy) → the port's tree of CPU tensors."""
    if isinstance(tree, dict):
        return {k: carry(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(carry(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _pipes(folder, variant):
    return (jd.DiarizePipeline.from_pretrained(str(folder), variant=variant),
            td.DiarizePipeline.from_pretrained(folder, variant=variant, device="cpu"))


def test_converters_take_the_published_names(folder):
    """The port's trees hold the JAX converters' leaves, value for value;
    the ResNet's blocks per layer come from the keys."""
    seg, emb = td.find_pyannote_checkpoints(folder)
    ref = jax.tree.map(np.asarray, jpn.load_pyannote_segmentation(seg))
    ours = pn.load_pyannote_segmentation(seg)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-7), ref, ours)
    sd = pn.read_state_dict(emb)
    assert pn.resnet_blocks(sd) == SMALL_BLOCKS
    ref = jax.tree.map(np.asarray, jpn.load_wespeaker_resnet34(emb))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-6), ref,
                 pn.load_wespeaker_resnet34(emb))


@pytest.mark.parametrize("variant", VARIANTS)
def test_published_models_and_pipeline_match_jax(folder, audio, variant):
    """Each package's from_pretrained of the same folder, in each variant:
    pyannet_forward and wespeaker_embed_masked agree (a row with no active
    frame and a short one among the masks), and DiarizePipeline.diarize on
    30 s gives an equal RTTM and equal chunk and embedding counts; for
    w32a32 also with two speakers asked for, wespeaker_resnet_forward and
    merge_with_transcript."""
    from whisperkit_tpu.core import results as jresults
    from whisperkit_tpu_torch.core import results

    jpipe, pipe = _pipes(folder, variant)
    assert (pipe.segmenter_backend, pipe.embedder_backend) == ("pyannet", "resnet")
    if variant == "w8a16":
        # the LSTM stack is built once, from the dequantized W8A16 codes
        q = td.DiarizePipeline.apply_variant(pn.load_pyannote_segmentation(td.find_pyannote_checkpoints(folder)[0]),
                                             variant)["lstms"][1]["bwd"]["wh"]
        lstm = pipe.segmenter_params["lstm"]
        assert torch.equal(lstm.weight_hh_l1_reverse, (q["w_q"].float() * q["scale"].float()).T)
        assert "w_q" in pipe.segmenter_params["conv1"]["w"]
        assert "w_q" in pipe.embedder_params["layer4"][0]["conv2"]["w"] and "w_q" in pipe.embedder_params["seg_1"]["w"]
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal((1, 32_000)) * 0.1).astype(np.float32)
    want = np.asarray(jpn.pyannet_forward(jpipe.segmenter_params, jnp.asarray(wave)))
    got = pn.pyannet_forward(pipe.segmenter_params, torch.from_numpy(wave)).numpy()
    assert got.shape == want.shape == (1, td._pyannet_frames(32_000), 7)
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL, rtol=0)
    fb = rng.standard_normal((3, 96, 80)).astype(np.float32)
    mask = (rng.random((3, 96)) < 0.5).astype(np.float32)
    mask[1] = 0.0  # no active frame
    mask[2] = 0.0
    mask[2, :7] = 1.0
    want = np.asarray(jpn.wespeaker_embed_masked(jpipe.embedder_params, jnp.asarray(fb), jnp.asarray(mask)))
    got = pn.wespeaker_embed_masked(pipe.embedder_params, torch.from_numpy(fb), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL, rtol=1e-5)

    option_sets = [{}]
    if variant == "w32a32":
        option_sets.append({"number_of_speakers": 2, "min_active_offset": 0.2, "use_exclusive_reconciliation": False})
    for kw in option_sets:
        ref = jpipe.diarize(audio, jd.DiarizationOptions(**kw))
        ours = pipe.diarize(audio, td.DiarizationOptions(**kw))
        assert ours.to_rttm("talk") == ref.to_rttm("talk") and ours.segments, kw
        for key in ("chunk_count", "embedding_count"):
            assert ours.timings[key] == ref.timings[key], key
        assert ours.timings["embedding_count"] > 0
    if variant != "w32a32":
        return
    want = np.asarray(jpn.wespeaker_resnet_forward(jpipe.embedder_params, jnp.asarray(fb)))
    got = pn.wespeaker_resnet_forward(pipe.embedder_params, torch.from_numpy(fb)).numpy()
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL, rtol=1e-5)

    def transcript(module):
        segs = [module.TranscriptionSegment(id=i, start=3.0 * i, end=3.0 * i + 2.5, text=f" s{i}", tokens=[i])
                for i in range(10)]
        return module.TranscriptionResult(text="", segments=segs, language="en")

    merged = td.DiarizePipeline.merge_with_transcript(ours, transcript(results))
    jmerged = jd.DiarizePipeline.merge_with_transcript(ref, transcript(jresults))
    assert [s.speaker for s in merged.segments] == [s.speaker for s in jmerged.segments]
    assert any(s.speaker for s in merged.segments)


def test_conv_models_and_pipeline_match_jax(audio):
    """The conv backend (the random-init default's architectures) at small
    dims: one tree drawn by the port's init_segmenter/init_embedder, as
    NumPy arrays for JAX and carried into the port (JAX's own random init
    would compile once per shape). DiarizePipeline.diarize on 40 s (two
    30 s chunks) gives an equal RTTM, and segmenter_forward and
    embedder_forward agree at the pipeline's shapes."""
    sdims = jpy.SegmenterDims(conv_channels=16, lstm_hidden=16, n_lstm=2)
    edims = jpy.EmbedderDims(n_mels=80, channels=(16, 24), embedding_dim=32)
    tsdims = py.SegmenterDims(**dataclasses.asdict(sdims))
    tedims = py.EmbedderDims(**{**dataclasses.asdict(edims), "channels": edims.channels})
    trees = [jax.tree.map(lambda t: t.numpy(), tree) for tree in (
        py.init_segmenter(torch.Generator().manual_seed(5), tsdims),
        py.init_embedder(torch.Generator().manual_seed(6), tedims))]
    jpipe = jd.DiarizePipeline(jd.PyannoteConfig(segmenter_dims=sdims, embedder_dims=edims),
                               segmenter_params=trees[0], embedder_params=trees[1])
    pipe = td.DiarizePipeline(td.PyannoteConfig(segmenter_dims=tsdims, embedder_dims=tedims),
                              segmenter_params=carry(trees[0]), embedder_params=carry(trees[1]), device="cpu")
    assert (pipe.segmenter_backend, pipe.embedder_backend) == ("conv", "conv")
    long = np.concatenate([audio, synth_speechlike_audio(10.0, seed=4)])
    for kw in ({}, {"number_of_speakers": 2, "min_active_offset": 0.2}):
        ref = jpipe.diarize(long, jd.DiarizationOptions(**kw))
        ours = pipe.diarize(long, td.DiarizationOptions(**kw))
        assert ours.to_rttm() == ref.to_rttm() and ours.segments, kw
        assert ours.timings["chunk_count"] == ref.timings["chunk_count"] == 2

    # the pipeline's shapes (two chunks, its pairs), so JAX compiles once
    n_pairs = ours.timings["embedding_count"]
    rng = np.random.default_rng(1)
    wave = (rng.standard_normal((2, py.CHUNK_SAMPLES)) * 0.1).astype(np.float32)
    want = jpy.segmenter_forward(jpipe.segmenter_params, jnp.asarray(wave), sdims)
    got = py.segmenter_forward(pipe.segmenter_params, torch.from_numpy(wave), tsdims)
    for key in ("speaker_activity", "overlapped_speaker_activity"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=MODEL_ATOL, rtol=0)
    mel = log_mel_spectrogram(torch.from_numpy(wave), n_mels=80)[np.arange(n_pairs) % 2]
    mask = np.repeat(rng.random((n_pairs, 300)) < 0.4, 10, axis=1).astype(np.float32)
    want = np.asarray(jpy.embedder_forward(jpipe.embedder_params, jnp.asarray(mel.numpy()), jnp.asarray(mask),
                                           edims))
    got = py.embedder_forward(pipe.embedder_params, mel, torch.from_numpy(mask), tedims)
    np.testing.assert_allclose(got.numpy(), want, atol=MODEL_ATOL, rtol=0)


class Recorder:
    """Wraps `owner.name`; each call records the process's TF32 flags
    (cuDNN's, cuBLAS's) as the call sees them."""

    def __init__(self, monkeypatch, owner, name):
        orig, self.flags = getattr(owner, name), []

        def wrapped(*args, **kwargs):
            self.flags.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
            return orig(*args, **kwargs)

        monkeypatch.setattr(owner, name, wrapped)


@pytest.mark.parametrize("backend", ["published", "conv"])
def test_speaker_models_run_in_ieee_float32(folder, audio, monkeypatch, backend):
    """With the process's TF32 flags on, the pipeline's convolutions, LSTM
    and fbank see them off (core.device.ieee_float32), and the flags are on
    again after diarize returns."""
    from whisperkit_tpu_torch.ops import fbank

    if backend == "published":
        pipe = td.DiarizePipeline.from_pretrained(folder, device="cpu")
    else:
        pipe = td.DiarizePipeline(td.PyannoteConfig(
            segmenter_dims=py.SegmenterDims(conv_channels=8, lstm_hidden=8),
            embedder_dims=py.EmbedderDims(channels=(8, 8), embedding_dim=16)), device="cpu")
    recs = [Recorder(monkeypatch, torch.nn.functional, name) for name in ("conv1d", "conv2d")]
    recs += [Recorder(monkeypatch, torch.nn.LSTM, "forward"), Recorder(monkeypatch, fbank, "_bases")]
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert pipe.diarize(audio).timings["embedding_count"] > 0
    seen = [r.flags for r in recs]
    # the conv models: conv1d and the LSTM (their mel is K1's, not the fbank)
    assert [bool(f) for f in seen] == ([True] * 4 if backend == "published" else [True, False, True, False]), seen
    assert {f for flags in seen for f in flags} == {(False, False)}
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_ieee_float32_blocks_overlapping_in_threads(monkeypatch):
    """Blocks that overlap in three threads (and a nested one) all see TF32
    off, and the flags come back on only when the last block ends."""
    import threading

    from whisperkit_tpu_torch.core.device import ieee_float32

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    entered, release, seen = threading.Barrier(4), [threading.Event() for _ in range(3)], []

    def block(i):
        with ieee_float32():
            entered.wait()
            release[i].wait()
            with ieee_float32():
                pass
            seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))

    threads = [threading.Thread(target=block, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    entered.wait()
    for i, t in enumerate(threads):  # the blocks end one by one
        release[i].set()
        t.join()
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        assert flags == ((True, True) if i == 2 else (False, False)), i
    assert seen == [(False, False)] * 3


@pytest.mark.parametrize("backend", ["published", "conv"])
def test_block_rows_leave_the_result(folder, audio, monkeypatch, backend):
    """The segmenter and embedder calls in blocks of BLOCK_ROWS rows: one
    row a block gives the embeddings (to 1e-5: the ResNet's float32 sums
    run in another order at another batch size, ~4e-6 relative here) and
    the RTTM of one block for all, through more calls."""
    if backend == "published":
        pipe = td.DiarizePipeline.from_pretrained(folder, device="cpu")
        name = "wespeaker_embed_masked"
    else:
        pipe = td.DiarizePipeline(td.PyannoteConfig(
            segmenter_dims=py.SegmenterDims(conv_channels=8, lstm_hidden=8),
            embedder_dims=py.EmbedderDims(channels=(8, 8), embedding_dim=16)), device="cpu")
        name = "embedder_forward"
    runs = []
    for rows in (td.BLOCK_ROWS, 1):
        monkeypatch.setattr(td, "BLOCK_ROWS", rows)
        calls = []
        orig = getattr(td, name)
        monkeypatch.setattr(td, name, lambda *a, orig=orig, calls=calls: calls.append(orig(*a)) or calls[-1])
        result = pipe.diarize(audio, td.DiarizationOptions(number_of_speakers=2))
        monkeypatch.setattr(td, name, orig)
        runs.append((result.to_rttm(), torch.cat(calls), len(calls)))
    (rttm, emb, n), (rttm1, emb1, n1) = runs
    assert n == 1 and n1 == len(emb) > 1 and rttm1 == rttm and rttm
    np.testing.assert_allclose(emb1.numpy(), emb.numpy(), atol=1e-5, rtol=1e-5)


def test_from_pretrained_refusals(tmp_path, folder):
    with pytest.raises(ValueError, match="unknown pyannote variant"):
        td.DiarizePipeline.from_pretrained(folder, variant="w4a4", device="cpu")
    with pytest.raises(FileNotFoundError, match="no pyannote checkpoints"):
        td.DiarizePipeline.from_pretrained(tmp_path, device="cpu")
    two = td.DiarizePipeline(device=["cpu", "cpu"])  # once refused; now a data-parallel mesh
    assert (two._plan.dcn, two._plan.dp, two._plan.tp) == (1, 2, 1) and len(two._replicas) == 2
    assert td.DiarizePipeline(device=["cpu"]).segmenter_backend == "conv"
