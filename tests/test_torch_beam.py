"""Beam search in the PyTorch port against the JAX package, on the CPU.

The same float32 weights and encoder output go through JAX
`beam_decode_loop` and the port's; the tokens and the winning sums must
agree, with and without the length penalty, and through the pipeline,
whose serving preset hands beam search the raw cross-KV and whose word
timestamps come from `alignment_forward`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperkit_tpu.core import configurations as jconf
from whisperkit_tpu.decoding import beam as jbeam
from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.pipelines.whisper import WhisperPipeline as JaxPipeline
from whisperkit_tpu.text import tokenizer as jtok
from whisperkit_tpu_torch.core.configurations import ComputeOptions, DecodingOptions, WhisperConfig
from whisperkit_tpu_torch.decoding import beam, loop
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
from whisperkit_tpu_torch.text.tokenizer import special_tokens_for_vocab
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

V = 207
SP = special_tokens_for_vocab(V)
JSP = jtok.special_tokens_for_vocab(V)
DIMS = model.WhisperDims(80, V, 1500, 64, 4, 2, 64, 64, 4, 2)
JDIMS = jmodel.WhisperDims(*dataclasses.astuple(DIMS))
PROMPT = [SP.sot, SP.transcribe]
HEADS = ((0, 0), (1, 2))
GREEDY = dict(
    language="en", sample_length=8, temperature_fallback_count=0,
    logprob_threshold=None, compression_ratio_threshold=None,
    no_speech_threshold=None, first_token_log_prob_threshold=None,
)


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(jax.random.PRNGKey(0), JDIMS, dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return model.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)


@pytest.fixture(scope="module")
def cross(jparams):
    mel = (np.random.default_rng(1).standard_normal((2, 80, 3000)) * 0.5).astype(np.float32)
    enc = jmodel.encoder_forward(jparams, jnp.asarray(mel), JDIMS)
    jc = jmodel.compute_cross_kv(jparams, enc, JDIMS)
    return jc, tuple(torch.from_numpy(np.array(x)) for x in jc)


def _run_both(jparams, tparams, cross, k, suppress, max_new=8, **kw):
    jc, tc = cross
    ref = jbeam.beam_decode_loop(
        jparams, *jc, jnp.asarray([PROMPT, PROMPT], jnp.int32), jnp.asarray(suppress), jnp.int32(50),
        dims=JDIMS, special=JSP, sample_begin=2, max_new_tokens=max_new, beam_size=k, sot_index=0, **kw,
    )
    out = beam.beam_decode_loop(
        tparams, *tc, torch.tensor([PROMPT, PROMPT]), torch.from_numpy(suppress), 50,
        dims=DIMS, special=SP, sample_begin=2, max_new_tokens=max_new, beam_size=k, sot_index=0, **kw,
    )
    return out, ref


@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("length_penalty", [None, 0.6])
@pytest.mark.parametrize("eot_bias", [0.0, 2.5])
def test_beam_matches_jax(jparams, tparams, cross, k, length_penalty, eot_bias):
    """Tokens equal and the winning sum within 1e-4 (float32, the same
    operations) for beams of 2 and 5, with and without the GNMT length
    penalty; an EOT bias makes hypotheses finish mid-window, so the
    finished set's merge and the early stop are exercised too."""
    suppress = np.zeros(V, np.float32)
    suppress[SP.eot] = eot_bias
    out, ref = _run_both(jparams, tparams, cross, k, suppress, max_new=10, use_timestamp_rules=True,
                         suppress_blank=False, length_penalty=length_penalty)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(out.token_logprobs.numpy(), np.asarray(ref.token_logprobs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.sum_logprob.numpy(), np.asarray(ref.sum_logprob), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob), rtol=1e-4, atol=1e-6)
    if eot_bias:  # some hypothesis finished before the budget
        assert (out.tokens.numpy()[:, 2:] == SP.eot).any()


def test_beam_without_timestamp_rules_and_blank_matches_jax(jparams, tparams, cross):
    suppress = np.zeros(V, np.float32)
    out, ref = _run_both(jparams, tparams, cross, 3, suppress, use_timestamp_rules=False, suppress_blank=True)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(out.sum_logprob.numpy(), np.asarray(ref.sum_logprob), rtol=1e-4, atol=1e-4)


def test_beam_1_is_greedy_and_wider_scores_no_worse(tparams, cross):
    _, tc = cross
    kw = dict(dims=DIMS, special=SP, sample_begin=2, max_new_tokens=8, sot_index=0,
              use_timestamp_rules=False, suppress_blank=False)
    prompt, suppress = torch.tensor([PROMPT, PROMPT]), torch.zeros(V)
    b1 = beam.beam_decode_loop(tparams, *tc, prompt, suppress, 50, beam_size=1, **kw)
    b4 = beam.beam_decode_loop(tparams, *tc, prompt, suppress, 50, beam_size=4, **kw)
    greedy = loop.decode_loop(tparams, *tc, prompt, suppress, loop.DecodeScalars(0.0, 50, float("-inf")),
                              top_k=5, **kw)
    gt, bt = greedy.tokens.numpy(), b1.tokens.numpy()
    eot = (gt[:, 2:] == SP.eot).any(0)
    n = int(np.argmax(eot)) if eot.any() else 8
    np.testing.assert_array_equal(bt[:, 2 : 2 + n], gt[:, 2 : 2 + n])
    assert (b4.sum_logprob >= b1.sum_logprob - 1e-3).all()


def test_beam_refuses_the_int8_cross_kv(tparams):
    q8 = {"q8": torch.zeros((2, 1, 4, 1500, 16), dtype=torch.int8), "scale": torch.ones((2, 1, 4, 1, 16))}
    with pytest.raises(TypeError, match="raw cross-KV"):
        beam.beam_decode_loop(tparams, q8, q8, torch.tensor([PROMPT]), torch.zeros(V), 50, dims=DIMS, special=SP,
                              sample_begin=2, max_new_tokens=4, beam_size=2, sot_index=0,
                              use_timestamp_rules=False, suppress_blank=False)


def test_length_score_matches_jax():
    sums = np.asarray([-3.0, -1e9, -0.5], np.float32)
    lengths = np.asarray([4, 0, 1], np.int64)
    for penalty in (None, 0.0, 1.0):
        ours = beam._length_score(torch.from_numpy(sums), torch.from_numpy(lengths), penalty)
        ref = jbeam._length_score(jnp.asarray(sums), jnp.asarray(lengths, jnp.int32), penalty)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def _pipes(jparams, **compute):
    jax_pipe = JaxPipeline(
        jconf.WhisperConfig(compute_options=jconf.ComputeOptions(dp_size=1, **compute), load=False),
        dims=JDIMS, params=jparams, alignment_heads=np.asarray(HEADS, np.int32),
    )
    tparams = model.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    torch_pipe = WhisperPipeline(
        WhisperConfig(compute_options=ComputeOptions(**compute), load=False),
        dims=DIMS, params=tparams, device="cpu", alignment_heads=np.asarray(HEADS, np.int32),
    )
    return jax_pipe, torch_pipe


def _audio(seconds, seed):
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)


def test_pipeline_beam_under_serving_gets_the_raw_cross_kv(jparams, monkeypatch):
    """ComputeOptions.serving() with beam_size 3: the encode hands beam
    search the raw cross-KV (JAX's rule), and the segments equal JAX's."""
    jax_pipe, torch_pipe = _pipes(jparams, quantize_cross_kv=True)
    seen = []
    encode = torch_pipe._encode
    monkeypatch.setattr(torch_pipe, "_encode", lambda mel, o: (lambda r: (seen.append(r[1]), r)[1])(encode(mel, o)))
    audio = _audio(4.0, 5)
    kw = dict(GREEDY, beam_size=3)
    ours = torch_pipe.transcribe(audio, DecodingOptions(**kw))
    ref = jax_pipe.transcribe(audio, jconf.DecodingOptions(**kw))
    assert seen and all(isinstance(ck, torch.Tensor) for ck in seen)
    assert [s.tokens for s in ours.segments] == [s.tokens for s in ref.segments]
    for a, b in zip(ours.segments, ref.segments):
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-4)
    # greedy decodes under the same preset keep the int8 form
    torch_pipe.transcribe(audio, DecodingOptions(**GREEDY))
    assert isinstance(seen[-1], dict)


def test_pipeline_beam_word_timestamps_go_through_alignment_forward(jparams, monkeypatch):
    """Beam search with word timestamps: one teacher-forced
    `alignment_forward` pass per rung, and JAX's words."""
    from whisperkit_tpu_torch.pipelines import whisper as pipeline_module

    jax_pipe, torch_pipe = _pipes(jparams)
    calls = []
    forward = pipeline_module.alignment_forward
    monkeypatch.setattr(pipeline_module, "alignment_forward", lambda *a, **k: (calls.append(1), forward(*a, **k))[1])
    audio = _audio(5.0, 6)
    kw = dict(GREEDY, beam_size=2, word_timestamps=True)
    ours = torch_pipe.transcribe(audio, DecodingOptions(**kw))
    ref = jax_pipe.transcribe(audio, jconf.DecodingOptions(**kw))
    assert calls == [1]
    assert len(ours.segments) == len(ref.segments) > 0
    for a, b in zip(ours.segments, ref.segments):
        assert a.tokens == b.tokens
        assert [(w.word, w.start, w.end) for w in a.words] == [(w.word, w.start, w.end) for w in b.words]
    assert ours.all_words


def test_pipeline_beam_rung_then_sampled_fallback(jparams):
    """The ladder with a beam rung 0 whose text fails the quality gate:
    the sampled rung after it runs on a prefill made then, and the result
    counts the fallback."""
    _, torch_pipe = _pipes(jparams)
    res = torch_pipe.transcribe(_audio(3.0, 6), DecodingOptions(
        sample_length=8, language="en", beam_size=2, temperature_fallback_count=2,
        compression_ratio_threshold=0.1, logprob_threshold=None, no_speech_threshold=None,
        first_token_log_prob_threshold=None,
    ))
    assert res.segments
    assert torch_pipe.timings.total_decoding_fallbacks >= 1


@pytest.mark.parametrize("eot_bias, jax_length", [(2.5, 25), (6.0, 4)])
def test_beam_length_matches_jax(jparams, tparams, cross, eot_bias, jax_length):
    """`length` is JAX's: the position after the step that left every
    window done, not the next stop check's (beam 3, 30 new tokens, no
    timestamp rules, an EOT bias that ends both windows early)."""
    suppress = np.zeros(V, np.float32)
    suppress[SP.eot] = eot_bias
    out, ref = _run_both(jparams, tparams, cross, 3, suppress, max_new=30, use_timestamp_rules=False,
                         suppress_blank=False)
    assert int(ref.length) == jax_length
    assert out.length == int(ref.length)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(out.sum_logprob.numpy(), np.asarray(ref.sum_logprob), rtol=1e-4, atol=1e-4)
