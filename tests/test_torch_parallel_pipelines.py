"""The port's pipelines on a mesh of CPU replicas against the JAX
package's pipelines on its 8-device mesh (tests/conftest.py), on the CPU.

  WhisperPipeline, tp = 2 on four replicas (dp inferred as 2), against
      JAX's ComputeOptions(tp_size=2) (dp 4): segments and tokens equal
  DiarizePipeline on two replicas against JAX's data-parallel run: the
      RTTM equal, on the published architectures at small size
  TTSPipeline on two replicas (three chunks, padded to four with a copy
      of the last) against JAX's mesh run: the audio within WAVE_TOL
      (JAX's `frames` counts its padded rows, so audio is compared); and
      at temperature 0.9 with one seed against the port on one device:
      the audio bit for bit, so the codes are equal
  tools/dryrun_multichip on 8 replicas: dcn 2 x dp 2 x tp 2, its tokens
      equal one device's, and the sequence-parallel leg
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperkit_tpu.core import configurations as jconf
from whisperkit_tpu.decoding import tts_loop as jloop
from whisperkit_tpu.models import pyannet as jpn
from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.pipelines import diarize as jd
from whisperkit_tpu.pipelines import tts as jtts
from whisperkit_tpu.pipelines.whisper import WhisperPipeline as JaxPipeline
from whisperkit_tpu_torch.core.configurations import ComputeOptions, DecodingOptions, WhisperConfig
from whisperkit_tpu_torch.models import qwen3_tts as tm
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.pipelines import diarize as td
from whisperkit_tpu_torch.pipelines import tts as ttts
from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
from whisperkit_tpu_torch.tools.checkpoint import write_pyannote_checkpoint
from whisperkit_tpu_torch.tools.dryrun_multichip import dryrun_multichip
from whisperkit_tpu_torch.tools.workload import synth_speechlike_audio

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

DIMS = model.WhisperDims(80, 207, 1500, 64, 4, 2, 64, 64, 4, 2)
JDIMS = jmodel.WhisperDims(*dataclasses.astuple(DIMS))
GREEDY = dict(
    language="en", sample_length=10, temperature_fallback_count=0,
    logprob_threshold=None, compression_ratio_threshold=None,
    no_speech_threshold=None, first_token_log_prob_threshold=None,
)
WAVE_TOL = 1e-4  # float32 waveforms (samples in [-1, 1])
TEXT = "Hello world. This is a test of the speech pipeline! Does it chunk? Yes."


def _assert_same_result(ours, ref):
    """test_torch_pipeline's comparison: text, segments and tokens equal."""
    assert ours.language == ref.language and ours.text == ref.text
    assert len(ours.segments) == len(ref.segments) > 0
    for a, b in zip(ours.segments, ref.segments):
        assert a.tokens == b.tokens
        assert (a.id, a.seek, a.text, a.language) == (b.id, b.seek, b.text, b.language)
        assert a.start == pytest.approx(b.start, abs=1e-6) and a.end == pytest.approx(b.end, abs=1e-6)
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-4)
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=1e-5)


@pytest.mark.parametrize("quantize_cross_kv", [False, True])
def test_whisper_tp2_matches_jax_mesh(quantize_cross_kv):
    jparams = jmodel.init_params(jax.random.PRNGKey(0), JDIMS, dtype=jnp.float32)
    jax_pipe = JaxPipeline(
        jconf.WhisperConfig(compute_options=jconf.ComputeOptions(
            tp_size=2, quantize_cross_kv=quantize_cross_kv), load=False),
        dims=JDIMS, params=jparams,
    )
    tparams = model.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    pipe = WhisperPipeline(
        WhisperConfig(compute_options=ComputeOptions(tp_size=2, quantize_cross_kv=quantize_cross_kv), load=False),
        dims=DIMS, params=tparams, device=["cpu"] * 4,
    )
    audio = synth_speechlike_audio(65.0, seed=1)
    kw = dict(chunking_strategy="vad", concurrent_worker_count=4, **GREEDY)
    ours = pipe.transcribe(audio, DecodingOptions(**kw))
    plan = pipe._mesh()
    assert (plan.dcn, plan.dp, plan.tp) == (1, 2, 2)
    assert jax_pipe._mesh() is not None and jax_pipe._mesh().tp == 2
    _assert_same_result(ours, jax_pipe.transcribe(audio, jconf.DecodingOptions(**kw)))


def test_diarize_on_two_replicas_matches_jax_mesh(tmp_path):
    write_pyannote_checkpoint(tmp_path, seed=0, full=False)
    audio = synth_speechlike_audio(30.0, seed=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpn, "RESNET34_BLOCKS", {"layer1": 2, "layer2": 2, "layer3": 2, "layer4": 2})
        jpipe = jd.DiarizePipeline.from_pretrained(str(tmp_path))
        assert jpipe._mesh() is not None  # JAX's run shards over its 8 devices
        ref = jpipe.diarize(audio, jd.DiarizationOptions())
    pipe = td.DiarizePipeline.from_pretrained(tmp_path, device=["cpu"] * 2)
    ours = pipe.diarize(audio, td.DiarizationOptions())
    assert ours.to_rttm("talk") == ref.to_rttm("talk") and ours.segments
    for key in ("chunk_count", "embedding_count"):
        assert ours.timings[key] == ref.timings[key], key
    one = td.DiarizePipeline.from_pretrained(tmp_path, device="cpu").diarize(audio, td.DiarizationOptions())
    assert one.to_rttm("talk") == ours.to_rttm("talk")


@pytest.fixture(scope="module")
def tts_trees():
    """(port tree, JAX tree), float32, with test_torch_tts's Code2Wav."""
    g = torch.Generator().manual_seed(0)
    tp = tm.init_tts_params(g, tm.TINY_TTS_DIMS, torch.float32, "cpu")

    def leaf(_, t):
        t = t * (1 + 0.05 * torch.randn(t.shape, generator=g)) + 0.02 * torch.randn(t.shape, generator=g)
        return t * (0.8 if t.ndim == 3 else 1.0)

    tp["c2w"] = tm.map_tree(leaf, tp["c2w"])
    nt = tm.map_tree(lambda _, t: t.detach().float().numpy() if t.is_floating_point() else t.numpy(), tp)
    return tp, jax.tree.map(jnp.asarray, nt)


def _tts_options(**kw):
    base = dict(max_new_tokens=8, temperature=0.0, seed=1, target_chunk_size=24, min_chunk_size=5,
                use_prompt_cache=False)
    return jtts.GenerationOptions(**{**base, **kw}), ttts.GenerationOptions(**{**base, **kw})


def test_tts_on_two_replicas_matches_jax_mesh_and_one_device(tts_trees, monkeypatch):
    tp, jp = tts_trees
    orig = jloop.init_code_kv_cache  # the JAX loop's bf16 cache, in float32 as the port's trees are
    monkeypatch.setattr(jloop, "init_code_kv_cache",
                        lambda dims, batch, max_seq=None: tuple(c.astype(jnp.float32) for c in orig(dims, batch, max_seq)))
    two = ttts.TTSPipeline(tm.TINY_TTS_DIMS, params=tp, device=["cpu"] * 2)
    jo, to = _tts_options()
    ref = jtts.TTSPipeline(tm.TINY_TTS_DIMS, params=jp).generate(TEXT, jo)
    ours = two.generate(TEXT, to)
    assert ours.timings.chunks == ref.timings.chunks == 3  # padded to 4 rows by the port, 8 by JAX
    assert ours.timings.frames == 3 * to.max_new_tokens
    assert ours.audio.shape == ref.audio.shape
    np.testing.assert_allclose(ours.audio, ref.audio, atol=WAVE_TOL)

    one = ttts.TTSPipeline(tm.TINY_TTS_DIMS, params=tp, device="cpu")
    _, hot = _tts_options(temperature=0.9, seed=5, max_new_tokens=12)
    a, b = one.generate(TEXT, hot), two.generate(TEXT, hot)
    assert a.timings.frames == b.timings.frames and np.array_equal(a.audio, b.audio)
    _, other = _tts_options(temperature=0.9, seed=6, max_new_tokens=12)
    assert not np.array_equal(two.generate(TEXT, other).audio, b.audio)  # the seed does reach the draws


def test_dryrun_multichip_on_eight_replicas():
    report = dryrun_multichip(8, "cpu")
    assert (report["dcn"], report["dp"], report["tp"], report["batch"]) == (2, 2, 2, 8)
    assert report["tokens_equal"] and report["seq_parallel_max_abs"] <= 2e-5
