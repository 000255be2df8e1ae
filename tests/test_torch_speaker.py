"""The port's speaker front end and host code against the JAX package's, on
the CPU: the kaldi fbank, the sinc filterbank, the powerset map, the
speaker quantizer, the clustering (the same labels from the same
embeddings, the same SplitMix64 stream), the diarization result types
(RTTM strings, transcript merging) and `compression_ratio_tokens`.
Inputs are made from seeds with NumPy and go through both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperkit_tpu.core import results as jresults
from whisperkit_tpu.models import pyannet as jpn
from whisperkit_tpu.ops import fbank as jfbank
from whisperkit_tpu.ops import quant as jquant
from whisperkit_tpu.speaker import clustering as jcl
from whisperkit_tpu.speaker import results as jsr
from whisperkit_tpu.text import utils as jutils
from whisperkit_tpu_torch.core import results
from whisperkit_tpu_torch.models import pyannet as pn
from whisperkit_tpu_torch.ops import fbank, quant
from whisperkit_tpu_torch.speaker import clustering as cl
from whisperkit_tpu_torch.speaker import results as sr
from whisperkit_tpu_torch.text import utils
from whisperkit_tpu_torch.tools.workload import synth_speechlike_audio

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

# the fbank's log energies: float32 DFT products of int16-range samples
# summed in another order (XLA's and torch's CPU GEMMs) differ by ~3e-4 in
# the quiet bins of these inputs
FBANK_ATOL = 1e-3


@pytest.mark.parametrize("mean_norm", [False, True])
def test_kaldi_fbank_matches_jax(mean_norm):
    rng = np.random.default_rng(0)
    audio = np.stack([synth_speechlike_audio(3.0, seed=1)[:47_123],
                      (rng.standard_normal(47_123) * 0.1).astype(np.float32)])
    ref = np.asarray(jfbank.kaldi_fbank(jnp.asarray(audio), mean_norm=mean_norm))
    ours = fbank.kaldi_fbank(torch.from_numpy(audio), mean_norm=mean_norm).numpy()
    assert ours.shape == ref.shape == (2, 1 + (47_123 - 400) // 160, 80)
    np.testing.assert_allclose(ours, ref, atol=FBANK_ATOL, rtol=0)


def test_sinc_filters_and_powerset_match_jax():
    rng = np.random.default_rng(1)
    low, band = rng.random((80, 1)) * 3000 + 30, rng.random((80, 1)) * 400 + 30
    np.testing.assert_array_equal(pn.sinc_filters(low, band), jpn.sinc_filters(low, band))
    assert pn.POWERSET_CLASSES == jpn.POWERSET_CLASSES
    lp = rng.standard_normal((3, 50, 7)).astype(np.float32)
    np.testing.assert_array_equal(pn.powerset_to_activity(torch.from_numpy(lp)).numpy(),
                                  np.asarray(jpn.powerset_to_activity(jnp.asarray(lp))))


def test_speaker_quantizer_matches_jax():
    """quantize_speaker_params on the same float tree: the same leaves
    quantized (the conv allowlist, the size floor), equal int8 codes and
    bf16 scales; the sinc filterbank and norms stay float."""
    rng = np.random.default_rng(2)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tree = {
        "sinc": {"w": r(80, 1, 251)},
        "conv1": {"w": r(60, 80, 5), "b": r(60)},
        "norm0": {"g": r(80), "b": r(80)},
        "lstms": [{"fwd": {"wx": r(60, 512), "wh": r(128, 512), "b": r(512)}}],
        "linears": [{"w": r(256, 128), "b": r(128)}],
        "cls": {"w": r(128, 7), "b": r(7)},
        "layer2": [{"conv1": {"w": r(64, 32, 3, 3), "b": r(64)}, "down": {"w": r(64, 32, 1, 1), "b": r(64)}}],
    }
    ref = jquant.quantize_speaker_params(_map(tree, jnp.asarray))
    ours = quant.quantize_speaker_params(_map(tree, torch.from_numpy))
    flat_ref, flat_ours = _flatten(ref), _flatten(ours)
    assert sorted(flat_ref) == sorted(flat_ours)
    assert "sinc.w" in flat_ours and "lstms.0.fwd.wx.w_q" in flat_ours and "layer2.0.down.w" in flat_ours
    for key, value in flat_ref.items():
        want = np.asarray(value.astype(jnp.float32)) if value.dtype == jnp.bfloat16 else np.asarray(value)
        got = flat_ours[key].float().numpy() if flat_ours[key].dtype == torch.bfloat16 else flat_ours[key].numpy()
        np.testing.assert_array_equal(got, want, err_msg=key)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flatten(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flatten(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


# -- clustering ------------------------------------------------------------------------


def _embeddings(seed: int, n: int = 40, d: int = 16, speakers: int = 3) -> np.ndarray:
    """Unit-norm embeddings around `speakers` random centres."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((speakers, d))
    x = centres[rng.integers(0, speakers, n)] + 0.35 * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def test_splitmix_stream_and_distances_match():
    ours, ref = cl.SplitMix64(12345), jcl.SplitMix64(12345)
    assert [ours.next() for _ in range(64)] == [ref.next() for _ in range(64)]
    assert [ours.uniform() for _ in range(8)] == [ref.uniform() for _ in range(8)]
    assert [ours.choice(7) for _ in range(8)] == [ref.choice(7) for _ in range(8)]
    e = _embeddings(0)
    np.testing.assert_array_equal(cl.cosine_distance_matrix(e), jcl.cosine_distance_matrix(e))
    assert dataclasses.asdict(cl.VBxClusteringConfig()) == dataclasses.asdict(jcl.VBxClusteringConfig())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clustering_labels_match(seed):
    e = _embeddings(seed)
    for threshold, min_size in ((0.6, 1), (0.3, 3)):
        np.testing.assert_array_equal(cl.fast_linkage_cluster(e, threshold, min_size),
                                      jcl.fast_linkage_cluster(e, threshold, min_size))
    for k in (2, 3, 5):
        np.testing.assert_array_equal(cl.kmeans(e, k, seed=seed), jcl.kmeans(e, k, seed=seed))
    init = jcl.fast_linkage_cluster(e, 0.3)
    np.testing.assert_array_equal(cl.vbx_refine(e, init), jcl.vbx_refine(e, init))
    ratios = np.random.default_rng(seed).random(len(e))
    plda = np.random.default_rng(seed + 10).standard_normal((16, 8)).astype(np.float32)
    for num_speakers, projection in ((None, None), (2, None), (None, plda)):
        ours, ref = cl.VBxClusterer(plda=projection), jcl.VBxClusterer(plda=projection)
        for x, ratio in zip(e, ratios):
            ours.add(x, float(ratio))
            ref.add(x, float(ratio))
        np.testing.assert_array_equal(ours.cluster(num_speakers), ref.cluster(num_speakers))


# -- result types ----------------------------------------------------------------------


def _activity(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    runs = rng.random((3, 400)) < 0.03
    return (np.cumsum(runs, axis=1) % 2).astype(np.int8)  # toggling runs


def _transcript(module):
    words = [module.WordTiming(f" w{i}", [i], 0.7 * i + (2.0 if i >= 6 else 0.0), 0.7 * i + 0.5, 0.9)
             for i in range(12)]
    segs = [
        module.TranscriptionSegment(id=0, start=0.0, end=4.0, text=" a b", tokens=[1, 2], words=words[:6]),
        module.TranscriptionSegment(id=1, start=6.0, end=10.4, text=" c d", tokens=[3, 4], words=words[6:]),
        module.TranscriptionSegment(id=2, start=18.0, end=21.0, text=" e", tokens=[5]),
    ]
    return module.TranscriptionResult(text="a b c d e", segments=segs, language="en")


@pytest.mark.parametrize("seed", [0, 1])
def test_diarization_result_matches(seed):
    act = _activity(seed)
    for offset in (1.0, 0.2):
        ours = sr.DiarizationResult.from_activity_matrix(act, 0.05, offset)
        ref = jsr.DiarizationResult.from_activity_matrix(act, 0.05, offset)
        assert ours.to_rttm("f") == ref.to_rttm("f") and ours.segments
        assert [ours.speaker_at(a, a + 1.5) for a in range(20)] == [ref.speaker_at(a, a + 1.5) for a in range(20)]
    for strategy in sr.SpeakerMergeStrategy:
        merged = ours.add_speaker_info(_transcript(results), strategy)
        jmerged = ref.add_speaker_info(_transcript(jresults), jsr.SpeakerMergeStrategy(strategy.value))
        assert [dataclasses.asdict(s) for s in merged.segments] == [dataclasses.asdict(s) for s in jmerged.segments]
        assert sr.DiarizationResult.rttm_from_words(merged) == jsr.DiarizationResult.rttm_from_words(jmerged)
    assert sr.RTTMLine("a", 1.0, 2.5, "SPEAKER_01").render() == jsr.RTTMLine("a", 1.0, 2.5, "SPEAKER_01").render()


def test_compression_ratio_tokens_matches():
    rng = np.random.default_rng(3)
    for tokens in ([], [7], list(rng.integers(0, 50_000, 60)), [11, 12] * 40):
        assert utils.compression_ratio_tokens(tokens) == jutils.compression_ratio_tokens(tokens)
