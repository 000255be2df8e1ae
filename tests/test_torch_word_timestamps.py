"""Word timestamps in the PyTorch port against the JAX package, on the CPU:
the copied DTW and timing heuristics, K3's probs form (its plain version
here), the alignment captured by `decoder_forward`, the decode loop and
`alignment_forward`, and the pipeline's words on the seek, VAD and
short-batch paths.

Both packages get the same float32 weights (the JAX `init_params` tree,
carried across with `params_from_numpy`) and the same numpy inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperkit_tpu.core import configurations as jconf
from whisperkit_tpu.core import results as jresults
from whisperkit_tpu.decoding import loop as jloop
from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.ops.attention_decode import cross_attend_q8_reference as jcross_attend_q8_reference
from whisperkit_tpu.pipelines.whisper import WhisperPipeline as JaxPipeline
from whisperkit_tpu.text import tokenizer as jtok
from whisperkit_tpu.text import word_timestamps as jwt
from whisperkit_tpu_torch.core import results
from whisperkit_tpu_torch.core.configurations import ComputeOptions, DecodingOptions, WhisperConfig
from whisperkit_tpu_torch.decoding import loop
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.ops import attention_decode as ad
from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
from whisperkit_tpu_torch.text import word_timestamps as wt
from whisperkit_tpu_torch.text.tokenizer import FakeTokenizer, special_tokens_for_vocab
from whisperkit_tpu_torch.tools.workload import synth_speechlike_audio
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

V = 207
SP = special_tokens_for_vocab(V)
JSP = jtok.special_tokens_for_vocab(V)
DIMS = model.WhisperDims(80, V, 1500, 64, 4, 2, 64, 64, 4, 2)
JDIMS = jmodel.WhisperDims(*dataclasses.astuple(DIMS))
HEADS = ((0, 1), (1, 2))
PROMPT = [SP.sot, SP.language_token("en"), SP.transcribe]
GREEDY = dict(
    language="en", sample_length=10, temperature_fallback_count=0,
    logprob_threshold=None, compression_ratio_threshold=None,
    no_speech_threshold=None, first_token_log_prob_threshold=None,
)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(jax.random.PRNGKey(0), JDIMS, dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return model.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)


@pytest.fixture(scope="module")
def cross(jparams):
    """Raw and int8 cross K/V of two random windows from the JAX encoder,
    in both packages' layouts (the same values on both sides)."""
    mel = np.random.default_rng(0).standard_normal((2, 80, 3000)).astype(np.float32)
    enc = jmodel.encoder_forward(jparams, jnp.asarray(mel), JDIMS)
    jraw = jmodel.compute_cross_kv(jparams, enc, JDIMS)
    jq8 = jmodel.compute_cross_kv_quantized(jparams, enc, JDIMS)
    traw = tuple(_t(np.asarray(x)) for x in jraw)
    tq8 = tuple({k: _t(np.asarray(v)) for k, v in d.items()} for d in jq8)
    return {"raw": (jraw, traw), "q8": (jq8, tq8)}


# ---------------------------------------------------------------------------
# the copied host algorithms (exact: the same numpy code)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape, width", [((5, 40), 7), ((2, 3, 30), 7), ((4, 6), 7), ((3, 50), 5)])
def test_median_filter_matches(shape, width):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(wt.median_filter(x, width), jwt.median_filter(x, width))


@pytest.mark.parametrize("n, m, seed", [(1, 1, 0), (5, 40, 1), (12, 300, 2), (30, 17, 3)])
def test_dtw_matches(n, m, seed):
    cost = np.random.default_rng(seed).standard_normal((n, m)).astype(np.float32)
    ours, ref = wt.dtw(cost), jwt.dtw(cost)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert ours[0][0] == 0 and ours[0][-1] == n - 1 and ours[1][-1] == m - 1


def test_find_alignment_matches():
    rng = np.random.default_rng(4)
    ids = [5, 9, SP.timestamp_begin + 3, 11, 17, 23]
    matrix = rng.standard_normal((len(ids), 120)).astype(np.float32)
    lps = list(rng.uniform(-2, 0, len(ids)))
    ours = wt.find_alignment(ids, matrix, lps, FakeTokenizer(V), "en")
    ref = jwt.find_alignment(ids, matrix, lps, jtok.FakeTokenizer(V), "en")
    assert [dataclasses.asdict(w) for w in ours] == [dataclasses.asdict(w) for w in ref]


@pytest.mark.parametrize(
    "words",
    [
        [" hello", ",", " world", "."],
        [' "', "quoted", '"', " text"],
        [" (", "a", ")", " b", "?"],
    ],
)
def test_merge_punctuations_and_word_rules_match(words):
    def timings(cls):
        return [cls(word=w, tokens=[i], start=0.3 * i, end=0.3 * i + 0.25 + 0.9 * (i == 2), probability=0.5)
                for i, w in enumerate(words)]

    ours, ref = timings(results.WordTiming), timings(jresults.WordTiming)
    assert [dataclasses.asdict(w) for w in wt.merge_punctuations(ours)] == [
        dataclasses.asdict(w) for w in jwt.merge_punctuations(ref)]
    assert wt.calculate_word_duration_constraints(ours) == jwt.calculate_word_duration_constraints(ref)
    assert [dataclasses.asdict(w) for w in wt.truncate_long_words_at_sentence_boundaries(ours, 0.3)] == [
        dataclasses.asdict(w) for w in jwt.truncate_long_words_at_sentence_boundaries(ref, 0.3)]


def _segments(cls, rng):
    ts = SP.timestamp_begin
    toks = [[ts, 5, 9, 11, ts + 40], [ts + 40, 17, 23, ts + 90], [ts + 90, 31, ts + 140]]
    return [
        cls(id=i, seek=0, start=(t[0] - ts) * 0.02, end=(t[-1] - ts) * 0.02, text="", tokens=t,
            token_log_probs=[{tok: float(rng.uniform(-2, 0))} for tok in t])
        for i, t in enumerate(toks)
    ]


@pytest.mark.parametrize("time_offset, window_frames", [(0.0, 3000), (12.5, 2400), (3.0, 700)])
def test_add_word_timestamps_matches(time_offset, window_frames):
    """Synthetic segments and a random alignment [T, A, 1500]: the same
    words, times and probabilities."""
    ours = _segments(results.TranscriptionSegment, np.random.default_rng(5))
    ref = _segments(jresults.TranscriptionSegment, np.random.default_rng(5))
    align = np.random.default_rng(6).uniform(0, 1, (3 + 13, 2, 1500)).astype(np.float32)
    kw = dict(alignment=align, sample_begin=3, tokens=[t for s in ours for t in s.tokens], language="en",
              time_offset=time_offset, window_frames=window_frames)
    out = wt.add_word_timestamps(segments=ours, tokenizer=FakeTokenizer(V), **kw)
    exp = jwt.add_word_timestamps(segments=ref, tokenizer=jtok.FakeTokenizer(V), **kw)
    assert [dataclasses.asdict(s) for s in out] == [dataclasses.asdict(s) for s in exp]
    assert sum(len(s.words) for s in out) > 0


# ---------------------------------------------------------------------------
# K3's probs form (its plain version on the CPU)
# ---------------------------------------------------------------------------


def _q8_case(t, seed):
    rng = np.random.default_rng(seed)
    b, h, s = 2, 4, 1500
    qi = rng.integers(-127, 128, (b, h, t, 64)).astype(np.int8)
    q_scale = (rng.uniform(1e-5, 3e-5, (b, h, t, 1))).astype(np.float32)
    k = rng.integers(-127, 128, (b, h, s, 64)).astype(np.int8)
    v = rng.integers(-127, 128, (b, h, s, 64)).astype(np.int8)
    v_scale = rng.uniform(0.005, 0.025, (b, h, 1, 64)).astype(np.float32)
    return qi, q_scale, k, v, v_scale


@pytest.mark.parametrize("t", [1, 3])
def test_k3_probs_form_equals_jax_capture_probs(t):
    """K3's plain probs form against the JAX int8 `_cross_attend(capture_probs
    =True)` math (its reference with the probabilities kept): probs within
    1e-6 in f32, written to the slots named and nowhere else; the output
    is the same with and without the probs form."""
    qi, q_scale, k, v, v_scale = _q8_case(t, t)
    scores = jnp.einsum("bhtd,bhsd->bhts", jnp.asarray(qi), jnp.asarray(k), preferred_element_type=jnp.int32)
    jprobs = np.asarray(jax.nn.softmax(scores.astype(jnp.float32) * jnp.asarray(q_scale), axis=-1))
    args = [_t(x) for x in (qi, q_scale, k, v, v_scale)]
    plain = ad.cross_attend_q8(*args)
    probs_out = torch.full((2, 3, t, 1500), -1.0)
    slots = [2, -1, 0, -1]  # head 0 → slot 2, head 2 → slot 0; slot 1 untouched
    out = ad.cross_attend_q8(*args, probs_out=probs_out, probs_slots=slots)
    assert torch.equal(out, plain)
    np.testing.assert_allclose(probs_out[:, 2].numpy(), jprobs[:, 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(probs_out[:, 0].numpy(), jprobs[:, 2], rtol=0, atol=1e-6)
    assert (probs_out[:, 1] == -1.0).all()
    ref_out = np.asarray(jcross_attend_q8_reference(*(jnp.asarray(x) for x in (qi, q_scale, k, v, v_scale))))
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=2e-3, atol=2e-4)


def test_k3_probs_form_arguments_go_together():
    args = [_t(x) for x in _q8_case(1, 0)]
    with pytest.raises(ValueError, match="go together"):
        ad.cross_attend_q8(*args, probs_out=torch.zeros((2, 1, 1, 1500)))


def test_head_slots():
    slots = model.head_slots([(1, 2), (0, 1), (1, 0)], n_layer=3, n_head=4)
    assert slots == [[-1, 1, -1, -1], [2, -1, 0, -1], None]
    with pytest.raises(ValueError, match="twice"):
        model.head_slots([(0, 1), (0, 1)], 2, 4)
    with pytest.raises(ValueError, match="outside"):
        model.head_slots([(2, 0)], 2, 4)


# ---------------------------------------------------------------------------
# alignment capture: decoder_forward, the decode loop, alignment_forward
# ---------------------------------------------------------------------------


def _jax_gathered(jparams, tokens, pos, kv, jc):
    logits, kv, probs = jmodel.decoder_forward(
        jparams, jnp.asarray(tokens, jnp.int32), pos, kv[0], kv[1], *jc, JDIMS, capture_alignment=True,
    )
    return np.asarray(logits), kv, np.asarray(jloop._gather_alignment(probs, np.asarray(HEADS, np.int32)))


@pytest.mark.parametrize("kind", ["raw", "q8"])
def test_decoder_forward_alignment_matches_jax(jparams, tparams, cross, kind):
    """Prefill (T=3) and one T==1 step with alignment capture: the probs of
    the alignment heads as JAX gathers them, to 1e-5 (raw: the same f32
    softmax; int8: the same integer scores, exact in both)."""
    jc, tc = cross[kind]
    s = 8
    shape = (2, 2, 4, s, 16)
    jkv = (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    prompt = np.asarray([PROMPT, PROMPT], np.int64)
    jl, jkv, jalign = _jax_gathered(jparams, prompt, 0, jkv, jc)
    tk, tv = model.init_kv_cache(DIMS, 2, s, torch.float32, "cpu")
    align = torch.zeros((3, 2, len(HEADS), 1500))
    tl = model.decoder_forward(tparams, _t(prompt), 0, tk, tv, *tc, DIMS, alignment_heads=HEADS, align_out=align)
    np.testing.assert_allclose(align.numpy(), jalign, rtol=0, atol=1e-5)
    tol = 1e-4 if kind == "raw" else 2e-3
    np.testing.assert_allclose(tl.numpy(), jl, rtol=tol, atol=tol)

    step = np.asarray([[SP.timestamp_begin], [SP.timestamp_begin + 3]], np.int64)
    _, _, jalign1 = _jax_gathered(jparams, step, 3, jkv, jc)
    align1 = torch.zeros((1, 2, len(HEADS), 1500))
    model.decoder_forward(tparams, _t(step), 3, tk, tv, *tc, DIMS, alignment_heads=HEADS, align_out=align1)
    np.testing.assert_allclose(align1.numpy(), jalign1, rtol=0, atol=1e-5)


def test_capture_leaves_the_logits_unchanged(tparams, cross):
    _, tc = cross["q8"]
    toks = torch.tensor([PROMPT, PROMPT])
    k1, v1 = model.init_kv_cache(DIMS, 2, 8, torch.float32, "cpu")
    k2, v2 = model.init_kv_cache(DIMS, 2, 8, torch.float32, "cpu")
    plain = model.decoder_forward(tparams, toks, 0, k1, v1, *tc, DIMS)
    align = torch.zeros((3, 2, len(HEADS), 1500))
    captured = model.decoder_forward(tparams, toks, 0, k2, v2, *tc, DIMS, alignment_heads=HEADS, align_out=align)
    assert torch.equal(plain, captured)
    with pytest.raises(ValueError, match="go together"):
        model.decoder_forward(tparams, toks, 0, k2, v2, *tc, DIMS, alignment_heads=HEADS)


LOOP_KW = dict(sample_begin=3, max_new_tokens=12, top_k=5, sot_index=0, use_timestamp_rules=True,
               suppress_blank=True)


def _jax_loop(jparams, jc, **kw):
    scalars = jloop.DecodeScalars(jnp.float32(0.0), jnp.int32(1500), jnp.float32(float("-inf")),
                                  jax.random.PRNGKey(0))
    return jloop.decode_loop(jparams, *jc, jnp.asarray([PROMPT, PROMPT], jnp.int32), jnp.zeros((V,)), scalars,
                             dims=JDIMS, special=JSP, alignment_heads=HEADS, **LOOP_KW, **kw)


def _torch_loop(tparams, tc, **kw):
    return loop.decode_loop(tparams, *tc, torch.tensor([PROMPT, PROMPT]), torch.zeros(V),
                            loop.DecodeScalars(0.0, 1500, float("-inf")), dims=DIMS, special=SP,
                            alignment_heads=HEADS, **LOOP_KW, **kw)


@pytest.mark.parametrize("kind, quantize_self_kv", [("raw", False), ("q8", False), ("q8", True)])
def test_decode_loop_alignment_matches_jax(jparams, tparams, cross, kind, quantize_self_kv):
    """The loop's alignment buffer [TOTAL, B, A, 1500] against JAX's, over
    each row's decoded positions (to 1e-5), with the same tokens. The
    int8 self-KV case is held on rows that decode the same tokens."""
    jc, tc = cross[kind]
    ref = _jax_loop(jparams, jc, quantize_self_kv=quantize_self_kv)
    out = _torch_loop(tparams, tc, quantize_self_kv=quantize_self_kv)
    ref_tokens = np.asarray(ref.tokens)
    assert out.alignment.shape == (15, 2, len(HEADS), 1500)
    same = [r for r in range(2) if (out.tokens[r].numpy() == ref_tokens[r]).all()]
    # int8: a requantization flip may decide a near-tie either way
    # (test_torch_model's int8 loop tests); raw: every row the same
    assert same == [0, 1] if kind == "raw" else same
    for r in same:
        eot = np.nonzero(ref_tokens[r, 3:] == SP.eot)[0]
        n = 3 + (int(eot[0]) + 1 if len(eot) else 12)
        np.testing.assert_allclose(out.alignment[:n, r].numpy(), np.asarray(ref.alignment)[:n, r], rtol=0,
                                   atol=1e-5)


def test_decode_loop_needs_a_capturing_prefill(tparams, cross):
    _, tc = cross["raw"]
    pre = loop.prefill_window(tparams, *tc, torch.tensor([PROMPT, PROMPT]), dims=DIMS, special=SP,
                              sample_begin=3, max_new_tokens=12, sot_index=0)
    with pytest.raises(ValueError, match="did not capture"):
        _torch_loop(tparams, tc, prefill=pre)


@pytest.mark.parametrize("kind", ["raw", "q8"])
def test_alignment_forward_matches_jax_and_the_loop(jparams, tparams, cross, kind):
    """The teacher-forced pass (beam search's word timestamps) against
    JAX's `alignment_forward` on the same tokens, and against the loop's
    own capture on a raw cross-KV (the JAX f32 parity test's claim)."""
    jc, tc = cross[kind]
    out = _torch_loop(tparams, tc)
    n = out.length
    tokens = out.tokens[:, :n]
    ours = loop.alignment_forward(tparams, *tc, tokens, dims=DIMS, alignment_heads=HEADS)
    ref = jloop.alignment_forward(jparams, *jc, jnp.asarray(tokens.numpy(), jnp.int32), dims=JDIMS,
                                  alignment_heads=HEADS)
    assert ours.dtype == torch.float32 and ours.shape == (n, 2, len(HEADS), 1500)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    if kind == "raw":
        np.testing.assert_allclose(ours.numpy(), out.alignment[:n].numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the pipeline's words
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


def assert_same_words(ours, ref, time_tol=0.02):
    """The same segments and words; each word's times within `time_tol` s
    (the round-to-0.01 s of a DTW boundary), and the count of words whose
    times differ at all asserted 0 (float32 weights)."""
    assert len(ours.segments) == len(ref.segments) > 0
    n_words, differ = 0, 0
    for a, b in zip(ours.segments, ref.segments):
        assert a.tokens == b.tokens
        assert a.start == pytest.approx(b.start, abs=time_tol) and a.end == pytest.approx(b.end, abs=time_tol)
        assert [w.word for w in a.words] == [w.word for w in b.words]
        for wa, wb in zip(a.words, b.words):
            assert wa.tokens == wb.tokens
            assert wa.start == pytest.approx(wb.start, abs=time_tol)
            assert wa.end == pytest.approx(wb.end, abs=time_tol)
            assert wa.probability == pytest.approx(wb.probability, abs=0.011)
            differ += (wa.start, wa.end) != (wb.start, wb.end)
            n_words += 1
    assert n_words > 0
    assert differ == 0


@pytest.mark.parametrize(
    "path, seconds, chunking",
    [("seek_short", 5.0, None), ("seek_long", 40.0, None), ("vad", 65.0, "vad")],
)
def test_pipeline_word_timestamps_match_jax(jparams, path, seconds, chunking):
    jax_pipe, torch_pipe = _pipes(jparams)
    audio = synth_speechlike_audio(seconds, seed=1) if chunking else (
        np.random.default_rng(7).standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)
    kw = dict(GREEDY, word_timestamps=True, chunking_strategy=chunking, concurrent_worker_count=2)
    ours = torch_pipe.transcribe(audio, DecodingOptions(**kw))
    ref = jax_pipe.transcribe(audio, jconf.DecodingOptions(**kw))
    assert_same_words(ours, ref)
    assert ours.timings.decoding_timestamp_alignment > 0


def test_pipeline_word_timestamps_short_batch_int8_cross_kv_matches_jax(jparams):
    """The batch API's short-clip path under the int8 cross-KV (K3's
    probs form, plain here)."""
    jax_pipe, torch_pipe = _pipes(jparams, quantize_cross_kv=True)
    rng = np.random.default_rng(3)
    items = [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in (4, 6)]
    kw = dict(GREEDY, word_timestamps=True)
    ours = torch_pipe.transcribe(items, DecodingOptions(**kw))
    ref = jax_pipe.transcribe(items, jconf.DecodingOptions(**kw))
    for a, b in zip(ours, ref):
        assert_same_words(a, b)


def test_word_timestamps_without_heads_leave_words_unset(tparams):
    pipe = WhisperPipeline(WhisperConfig(load=False), dims=DIMS, params=tparams, device="cpu")
    res = pipe.transcribe(np.zeros(16000 * 2, np.float32), DecodingOptions(**GREEDY, word_timestamps=True))
    assert all(s.words is None for s in res.segments)
