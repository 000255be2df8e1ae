"""Segmented decode, batch compaction and mid-window cancellation in the
PyTorch port against the JAX package, on the CPU (the port's side of
tests/test_decoding.py's segmented tests and
tests/test_core_components.py's EarlyStopFlag test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperkit_tpu.core import configurations as jconf
from whisperkit_tpu.core.concurrency import EarlyStopFlag as JaxEarlyStopFlag
from whisperkit_tpu.decoding import loop as jloop
from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.pipelines.whisper import WhisperPipeline as JaxPipeline
from whisperkit_tpu.text import tokenizer as jtok
from whisperkit_tpu_torch.core.concurrency import EarlyStopFlag
from whisperkit_tpu_torch.core.configurations import ComputeOptions, DecodingOptions, WhisperConfig
from whisperkit_tpu_torch.decoding import loop
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.parallel.mesh import SharedDraws
from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
from whisperkit_tpu_torch.text.tokenizer import special_tokens_for_vocab
from whisperkit_tpu_torch.tools.workload import synth_speechlike_audio
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

V = 207
SP = special_tokens_for_vocab(V)
JSP = jtok.special_tokens_for_vocab(V)
DIMS = model.WhisperDims(80, V, 1500, 64, 4, 2, 64, 64, 4, 2)
JDIMS = jmodel.WhisperDims(*dataclasses.astuple(DIMS))
HEADS = ((0, 0), (1, 2))
# eight rows with different second prompt tokens
PROMPTS = [[SP.sot, t] for t in (5, 9, 17, 33, 57, 101, 150, 188)]
GREEDY = dict(
    language="en", temperature_fallback_count=0, logprob_threshold=None, compression_ratio_threshold=None,
    no_speech_threshold=None, first_token_log_prob_threshold=None,
)


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(jax.random.PRNGKey(0), JDIMS, dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return model.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)


@pytest.fixture(scope="module")
def cross8(jparams):
    """The raw cross-KV of 8 windows (mel ~ N(0, 0.05)), both layouts."""
    mel = (np.random.default_rng(3).standard_normal((8, 80, 3000)) * 0.05).astype(np.float32)
    _, jk, jv = jloop.encode_window(jparams, jnp.asarray(mel), JDIMS)
    return (jk, jv), (torch.from_numpy(np.array(jk)), torch.from_numpy(np.array(jv)))


# a positive EOT bias makes greedy rows finish at scattered steps
EOT_BIAS = np.zeros(V, np.float32)
EOT_BIAS[SP.eot] = 3.0
KW = dict(sample_begin=2, max_new_tokens=48, top_k=5, sot_index=0, use_timestamp_rules=False,
          suppress_blank=False)


def _jax(fn, jparams, jc, suppress, **kw):
    scalars = jloop.DecodeScalars(jnp.float32(0.0), jnp.int32(1500), jnp.float32(float("-inf")),
                                  jax.random.PRNGKey(0))
    return fn(jparams, *jc, jnp.asarray(PROMPTS, jnp.int32), jnp.asarray(suppress), scalars, dims=JDIMS,
              special=JSP, **{**KW, **kw})


def _torch(fn, tparams, tc, suppress, **kw):
    return fn(tparams, *tc, torch.tensor(PROMPTS), torch.from_numpy(suppress),
              loop.DecodeScalars(0.0, 1500, float("-inf")), dims=DIMS, special=SP, **{**KW, **kw})


@pytest.fixture
def compactions(monkeypatch):
    """The batch sizes the decode was compacted to, in order."""
    sizes = []
    compact = loop._compact
    monkeypatch.setattr(loop, "_compact", lambda st, rows, n: (sizes.append(len(rows)), compact(st, rows, n))[1])
    return sizes


def test_segmented_matches_the_single_loop_and_jax(jparams, tparams, cross8):
    """segment_tokens=4 over 11 tokens, no compaction: the port's segmented
    loop, its single loop and JAX's segmented loop give the same tokens."""
    jc, tc = cross8
    zero = np.zeros(V, np.float32)
    kw = dict(max_new_tokens=11, use_timestamp_rules=True)
    single = _torch(loop.decode_loop, tparams, tc, zero, **kw)
    seg = _torch(loop.decode_loop_segmented, tparams, tc, zero, segment_tokens=4, **kw)
    ref = _jax(jloop.decode_loop_segmented, jparams, jc, zero, segment_tokens=4, **kw)
    np.testing.assert_array_equal(seg.tokens.numpy(), single.tokens.numpy())
    np.testing.assert_array_equal(seg.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(seg.token_logprobs.numpy(), np.asarray(ref.token_logprobs), rtol=1e-4, atol=1e-4)
    assert seg.length == single.length == int(ref.length)


@pytest.mark.parametrize("polls_before_stop", [1, 2])
def test_should_stop_matches_jax(jparams, tparams, cross8, polls_before_stop):
    """should_stop polled between segments: True at its first poll (after
    the first segment) or its second gives JAX's tokens; the rest of the
    window stays EOT."""
    jc, tc = cross8
    zero = np.zeros(V, np.float32)

    def stopper():
        calls = []
        return calls, lambda: (calls.append(1), len(calls) >= polls_before_stop)[1]

    ours_calls, ours_stop = stopper()
    ref_calls, ref_stop = stopper()
    out = _torch(loop.decode_loop_segmented, tparams, tc, zero, max_new_tokens=16, segment_tokens=4,
                 should_stop=ours_stop)
    ref = _jax(jloop.decode_loop_segmented, jparams, jc, zero, max_new_tokens=16, segment_tokens=4,
               should_stop=ref_stop)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    assert len(ours_calls) == len(ref_calls) == polls_before_stop
    assert out.length == int(ref.length) == 2 + 4 * polls_before_stop
    assert (out.tokens.numpy()[:, out.length :] == SP.eot).all()


@pytest.mark.parametrize("quantize_self_kv", [False, True], ids=["raw_cache", "int8_cache"])
def test_compaction_is_token_exact(jparams, tparams, cross8, compactions, quantize_self_kv):
    """Rows end at scattered steps (EOT bias 3), so the decode compacts
    (asserted): its tokens and log-probs equal the uncompacted loop's, and
    its tokens JAX's compacted loop's, with the raw and the int8 self-KV
    cache (no row of these inputs meets a requantization near-tie)."""
    jc, tc = cross8
    kw = dict(quantize_self_kv=quantize_self_kv)
    base = _torch(loop.decode_loop, tparams, tc, EOT_BIAS, **kw)
    comp = _torch(loop.decode_loop_segmented, tparams, tc, EOT_BIAS, segment_tokens=8, compact=True, **kw)
    finish = (base.tokens.numpy()[:, 2:] != SP.eot).sum(1)
    assert len(set(finish.tolist())) > 2, finish
    assert compactions and all(b < 8 for b in compactions), compactions
    np.testing.assert_array_equal(comp.tokens.numpy(), base.tokens.numpy())
    np.testing.assert_allclose(comp.token_logprobs.numpy(), base.token_logprobs.numpy(), rtol=1e-5, atol=1e-5)
    ref = _jax(jloop.decode_loop_segmented, jparams, jc, EOT_BIAS, segment_tokens=8, compact=True, **kw)
    np.testing.assert_array_equal(comp.tokens.numpy(), np.asarray(ref.tokens))


def test_compaction_keeps_each_rows_alignment(tparams, cross8, compactions):
    """With alignment capture, the per-row buffers survive the gathers and
    land back at their original rows: equal to the uncompacted loop's up to
    each row's finish position."""
    _, tc = cross8
    kw = dict(alignment_heads=HEADS)
    base = _torch(loop.decode_loop, tparams, tc, EOT_BIAS, **kw)
    comp = _torch(loop.decode_loop_segmented, tparams, tc, EOT_BIAS, segment_tokens=8, compact=True, **kw)
    assert compactions
    np.testing.assert_array_equal(comp.tokens.numpy(), base.tokens.numpy())
    finish = (base.tokens.numpy()[:, 2:] != SP.eot).sum(1)
    for r, n in enumerate(finish):
        torch.testing.assert_close(comp.alignment[: 2 + n + 1, r], base.alignment[: 2 + n + 1, r], rtol=0,
                                   atol=1e-6)


def test_sampled_compaction_keeps_each_rows_draws(tparams, cross8, compactions):
    """At temperature 0.7 the rows draw from one group's shared draws
    (parallel/mesh.SharedDraws, as a mesh's VAD group does): the compacting
    decode of all eight rows, and of two halves of them as two mesh cells
    decode them, give every row the uncompacted loop's tokens, so a row
    compacted to another index goes on with its own noise."""
    _, tc = cross8

    def run(fn, halves, **kw):
        shared = SharedDraws(torch.Generator().manual_seed(7), 8)
        outs = []
        for rows in halves:
            outs.append(fn(
                tparams, tc[0][:, rows], tc[1][:, rows], torch.tensor(PROMPTS[rows]), torch.from_numpy(EOT_BIAS),
                loop.DecodeScalars(0.7, 1500, float("-inf"), shared.rows(rows)), dims=DIMS, special=SP,
                **{**KW, **kw},
            ).tokens.numpy())
        return np.concatenate(outs)

    base = run(loop.decode_loop, [slice(0, 8)])
    whole = run(loop.decode_loop_segmented, [slice(0, 8)], segment_tokens=8, compact=True)
    n_whole = len(compactions)
    halves = run(loop.decode_loop_segmented, [slice(0, 4), slice(4, 8)], segment_tokens=8, compact=True)
    finish = (base[:, 2:] != SP.eot).sum(1)
    assert len(set(finish.tolist())) > 2, finish
    assert n_whole and len(compactions) > n_whole, compactions
    np.testing.assert_array_equal(whole, base)
    np.testing.assert_array_equal(halves, base)


def test_compaction_gathers_the_int8_cross_kv(tparams, cross8, compactions):
    """An int8 cross-KV dict is gathered part by part (as the int8 self-KV
    cache is): compacted tokens equal the uncompacted int8 loop's."""
    _, (k, v) = cross8
    tq8 = []
    for x in (k, v):
        codes, scale = model._q8_quantize(x.float(), -2)
        tq8.append({"q8": codes, "scale": scale})
    base = _torch(loop.decode_loop, tparams, tq8, EOT_BIAS)
    comp = _torch(loop.decode_loop_segmented, tparams, tq8, EOT_BIAS, segment_tokens=8, compact=True)
    assert compactions
    np.testing.assert_array_equal(comp.tokens.numpy(), base.tokens.numpy())


def test_early_stop_flag_behaves_as_jax():
    for flag in (EarlyStopFlag(), JaxEarlyStopFlag()):
        assert not flag.should_stop
        flag.stop()
        assert flag.should_stop
        flag.reset()
        assert not flag.should_stop


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def _pipes(jparams, **compute):
    jax_pipe = JaxPipeline(
        jconf.WhisperConfig(compute_options=jconf.ComputeOptions(dp_size=1, **compute), load=False),
        dims=JDIMS, params=jparams,
    )
    tparams = model.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    torch_pipe = WhisperPipeline(
        WhisperConfig(compute_options=ComputeOptions(**compute), load=False), dims=DIMS, params=tparams, device="cpu",
    )
    return jax_pipe, torch_pipe


def test_pipeline_segmented_decode_matches_jax(jparams, monkeypatch):
    """ComputeOptions(segmented_decode=True) on the VAD path (groups of 4):
    the segmented, compacting loop runs and gives JAX's segments."""
    jax_pipe, torch_pipe = _pipes(jparams, segmented_decode=True)
    calls = []
    segmented = loop.decode_loop_segmented
    from whisperkit_tpu_torch.pipelines import whisper as pipeline_module

    monkeypatch.setattr(pipeline_module, "decode_loop_segmented",
                        lambda *a, **k: (calls.append(k["compact"]), segmented(*a, **k))[1])
    audio = synth_speechlike_audio(65.0, seed=1)
    kw = dict(GREEDY, sample_length=40, chunking_strategy="vad", concurrent_worker_count=4)
    ours = torch_pipe.transcribe(audio, DecodingOptions(**kw))
    ref = jax_pipe.transcribe(audio, jconf.DecodingOptions(**kw))
    assert calls and all(calls)
    assert [s.tokens for s in ours.segments] == [s.tokens for s in ref.segments]
    assert ours.text == ref.text


def test_pipeline_early_stop_flag_matches_jax(jparams):
    """A flag already set stops every window after its first 32-token
    segment, as the JAX pipeline stops; a cleared flag gives the whole
    window again."""
    jax_pipe, torch_pipe = _pipes(jparams)
    flag, jflag = EarlyStopFlag(), JaxEarlyStopFlag()
    flag.stop()
    jflag.stop()
    torch_pipe.early_stop_flag, jax_pipe.early_stop_flag = flag, jflag
    audio = (np.random.default_rng(2).standard_normal(16000 * 6) * 0.1).astype(np.float32)
    kw = dict(GREEDY, sample_length=48)
    ours = torch_pipe.transcribe(audio, DecodingOptions(**kw))
    ref = jax_pipe.transcribe(audio, jconf.DecodingOptions(**kw))
    assert [s.tokens for s in ours.segments] == [s.tokens for s in ref.segments]
    assert sum(len(s.tokens) for s in ours.segments) <= 32
    flag.reset()
    torch_pipe.early_stop_flag = None
    full = torch_pipe.transcribe(audio, DecodingOptions(**kw))
    assert sum(len(s.tokens) for s in full.segments) > 32
