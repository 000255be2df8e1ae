"""Speculative decoding in the PyTorch port, on the CPU (the port's side of
tests/test_speculative.py): for any draft sharing the vocab, the committed
tokens are the greedy loop's, and the JAX package's speculative loop's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperkit_tpu.core import configurations as jconf
from whisperkit_tpu.decoding import loop as jloop
from whisperkit_tpu.decoding import speculative as jspec
from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.pipelines.whisper import WhisperPipeline as JaxPipeline
from whisperkit_tpu.text import tokenizer as jtok
from whisperkit_tpu_torch.core.concurrency import EarlyStopFlag
from whisperkit_tpu_torch.core.configurations import ComputeOptions, DecodingOptions, WhisperConfig
from whisperkit_tpu_torch.decoding import loop, speculative
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.pipelines import whisper as pipeline_module
from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
from whisperkit_tpu_torch.text.tokenizer import special_tokens_for_vocab
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

V = 207
SP = special_tokens_for_vocab(V)
JSP = jtok.special_tokens_for_vocab(V)
DIMS = model.WhisperDims(80, V, 1500, 64, 4, 2, 64, 64, 4, 2)
DRAFT_DIMS = model.WhisperDims(80, V, 1500, 32, 4, 1, 64, 32, 4, 1)
JDIMS = jmodel.WhisperDims(*dataclasses.astuple(DIMS))
JDRAFT_DIMS = jmodel.WhisperDims(*dataclasses.astuple(DRAFT_DIMS))
PROMPT = [SP.sot, SP.transcribe]
GREEDY = dict(
    language="en", temperature_fallback_count=0, logprob_threshold=None, compression_ratio_threshold=None,
    no_speech_threshold=None, first_token_log_prob_threshold=None,
)


def _port(tree):
    return model.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu", torch.float32)


@pytest.fixture(scope="module")
def setup():
    """float32 target and independent draft, both packages, and the cross-KV
    of one random window from each (the JAX encoder's, carried across)."""
    target = jmodel.init_params(jax.random.PRNGKey(0), JDIMS, jnp.float32)
    draft = jmodel.init_params(jax.random.PRNGKey(7), JDRAFT_DIMS, jnp.float32)
    mel = jnp.asarray((np.random.default_rng(1).standard_normal((1, 80, 3000)) * 0.5).astype(np.float32))
    _, ck, cv = jloop.encode_window(target, mel, JDIMS)
    _, dck, dcv = jloop.encode_window(draft, mel, JDRAFT_DIMS)

    def port_kv(*xs):
        return tuple(torch.from_numpy(np.array(x)) for x in xs)

    return {
        "jax": (target, draft, (ck, cv), (dck, dcv)),
        "port": (_port(target), _port(draft), port_kv(ck, cv), port_kv(dck, dcv)),
    }


def _scalars(first_threshold=float("-inf")):
    return loop.DecodeScalars(0.0, 50, first_threshold)


def _jscalars(first_threshold=float("-inf")):
    return jloop.DecodeScalars(jnp.float32(0.0), jnp.int32(50), jnp.float32(first_threshold), jax.random.PRNGKey(0))


def _greedy(target, kv, suppress, max_new, first_threshold=float("-inf"), rules=True):
    return loop.decode_loop(
        target, *kv, torch.tensor([PROMPT]), suppress, _scalars(first_threshold), dims=DIMS, special=SP,
        sample_begin=2, max_new_tokens=max_new, top_k=5, sot_index=0, use_timestamp_rules=rules,
        suppress_blank=False,
    )


def _spec(target, draft, kv, dkv, draft_dims, suppress, max_new, k, first_threshold=float("-inf"), rules=True,
          **kw):
    return speculative.speculative_decode_loop(
        target, draft, *kv, *dkv, torch.tensor([PROMPT]), suppress, _scalars(first_threshold), dims=DIMS,
        draft_dims=draft_dims, special=SP, sample_begin=2, max_new_tokens=max_new, draft_k=k,
        use_timestamp_rules=rules, **kw,
    )


@pytest.mark.parametrize("draft_kind", ["independent", "self"])
@pytest.mark.parametrize("draft_k", [1, 3, 4])
def test_speculative_equals_greedy_and_jax(setup, draft_kind, draft_k):
    """Lossless against the port's greedy loop, for an independent random
    draft (worst-case acceptance) and draft == target (every round
    accepts), and the same tokens as JAX's speculative loop."""
    target, draft, kv, dkv = setup["port"]
    jtarget, jdraft, jkv, jdkv = setup["jax"]
    dims, jdims = DRAFT_DIMS, JDRAFT_DIMS
    if draft_kind == "self":
        draft, dkv, jdraft, jdkv, dims, jdims = target, kv, jtarget, jkv, DIMS, JDIMS
    suppress = torch.zeros(V)
    ref = _greedy(target, kv, suppress, 24)
    out = _spec(target, draft, kv, dkv, dims, suppress, 24, draft_k)
    np.testing.assert_array_equal(out.tokens.numpy(), ref.tokens.numpy())
    np.testing.assert_allclose(out.token_logprobs.numpy(), ref.token_logprobs.numpy(), atol=1e-4)
    np.testing.assert_allclose(out.no_speech_prob.numpy(), ref.no_speech_prob.numpy(), rtol=1e-4)
    jout = jspec.speculative_decode_loop(
        jtarget, jdraft, *jkv, *jdkv, jnp.asarray([PROMPT], jnp.int32), jnp.zeros((V,)), _jscalars(),
        dims=JDIMS, draft_dims=jdims, special=JSP, sample_begin=2, max_new_tokens=24, draft_k=draft_k,
    )
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(jout.tokens))


def test_speculative_first_token_threshold(setup):
    """An impossible first-token floor stops at once, as the greedy loop."""
    target, draft, kv, dkv = setup["port"]
    ref = _greedy(target, kv, torch.zeros(V), 12, first_threshold=1e9)
    out = _spec(target, draft, kv, dkv, DRAFT_DIMS, torch.zeros(V), 12, 3, first_threshold=1e9)
    np.testing.assert_array_equal(out.tokens.numpy(), ref.tokens.numpy())
    assert (out.tokens.numpy()[0, 2:] == SP.eot).all()


def test_speculative_eot_stop(setup):
    """EOT biased upward so the target reaches it mid-window: both loops
    stop at the same position with the same committed EOT."""
    target, draft, kv, dkv = setup["port"]
    suppress = torch.zeros(V)
    suppress[SP.eot] = 2.7  # EOT at the tenth step for this window
    ref = _greedy(target, kv, suppress, 16, rules=False)
    out = _spec(target, draft, kv, dkv, DRAFT_DIMS, suppress, 16, 4, rules=False)
    np.testing.assert_array_equal(out.tokens.numpy(), ref.tokens.numpy())
    assert 2 < list(out.tokens[0]).index(SP.eot) < 2 + 15


def test_draft_kv_matches_target_kv(setup):
    """With draft == target every round accepts and pos advances k+1 per
    round; the draft cache then matches the target cache at every committed
    position, with no zero hole."""
    target, _, kv, _ = setup["port"]
    suppress = torch.zeros(V)
    suppress[SP.eot] = -1e9
    k = 3
    out, st = _spec(target, target, kv, kv, DIMS, suppress, 3 * (k + 1) + 1, k, return_state=True)
    assert st.pos >= 2 + 3 * (k + 1)
    for t_cache, d_cache in ((st.kv_t_k, st.kv_d_k), (st.kv_t_v, st.kv_d_v)):
        torch.testing.assert_close(d_cache[:, :, :, : st.pos - 1], t_cache[:, :, :, : st.pos - 1], rtol=1e-4,
                                   atol=1e-4)
        assert (d_cache[:, :, :, : st.pos - 1].norm(dim=-1) > 1e-6).all()


def test_speculative_takes_batch_1_and_a_shared_vocab(setup):
    target, draft, kv, dkv = setup["port"]
    with pytest.raises(ValueError, match="batch-1"):
        speculative.speculative_decode_loop(
            target, draft, *kv, *dkv, torch.tensor([PROMPT, PROMPT]), torch.zeros(V), _scalars(), dims=DIMS,
            draft_dims=DRAFT_DIMS, special=SP, sample_begin=2, max_new_tokens=4,
        )
    with pytest.raises(ValueError, match="vocab"):
        _spec(target, draft, kv, dkv, dataclasses.replace(DRAFT_DIMS, n_vocab=V + 1), torch.zeros(V), 4, 2)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


@pytest.fixture
def spec_calls(monkeypatch):
    calls = []
    loop_fn = pipeline_module.speculative_decode_loop
    monkeypatch.setattr(pipeline_module, "speculative_decode_loop",
                        lambda *a, **k: (calls.append(1), loop_fn(*a, **k))[1])
    return calls


def _audio(seconds, seed):
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)


def test_pipeline_speculative_matches_plain_and_jax(setup, spec_calls):
    """WhisperPipeline(draft_dims/draft_params): batch-1 greedy decodes take
    the speculative loop and transcribe as the pipeline without a draft,
    and as the JAX pipeline with the same draft."""
    target, draft, _, _ = setup["port"]
    jtarget, jdraft, _, _ = setup["jax"]
    audio = _audio(4.0, 5)
    opts = dict(GREEDY, sample_length=12)
    plain = WhisperPipeline(WhisperConfig(load=False), dims=DIMS, params=target, device="cpu")
    spec = WhisperPipeline(WhisperConfig(load=False), dims=DIMS, params=target, draft_dims=DRAFT_DIMS,
                           draft_params=draft, device="cpu")
    jspec_pipe = JaxPipeline(jconf.WhisperConfig(load=False), dims=JDIMS, params=jtarget, draft_dims=JDRAFT_DIMS,
                             draft_params=jdraft)
    r_spec = spec.transcribe(audio, DecodingOptions(**opts))
    assert spec_calls
    r_plain = plain.transcribe(audio, DecodingOptions(**opts))
    r_jax = jspec_pipe.transcribe(audio, jconf.DecodingOptions(**opts))
    assert [s.tokens for s in r_spec.segments] == [s.tokens for s in r_plain.segments]
    assert [s.tokens for s in r_spec.segments] == [s.tokens for s in r_jax.segments]
    assert r_spec.text == r_plain.text


def test_pipeline_speculative_under_the_serving_preset(setup, spec_calls):
    """The serving preset's int8 cross-KV feeds the verify pass (K3 with
    k+1 query rows, plain here), the draft stays float: the same tokens as
    the serving pipeline without a draft."""
    target, draft, _, _ = setup["port"]
    cfg = WhisperConfig(compute_options=ComputeOptions.serving(), load=False)
    audio = _audio(3.0, 9)
    opts = DecodingOptions(**GREEDY, sample_length=10)
    spec = WhisperPipeline(cfg, dims=DIMS, params=target, draft_dims=DRAFT_DIMS, draft_params=draft, device="cpu")
    r_spec = spec.transcribe(audio, opts)
    assert spec_calls
    r_plain = WhisperPipeline(cfg, dims=DIMS, params=target, device="cpu").transcribe(audio, opts)
    assert [s.tokens for s in r_spec.segments] == [s.tokens for s in r_plain.segments]


@pytest.mark.parametrize("case", ["word_timestamps", "early_stop_flag", "segmented_decode", "beam"])
def test_options_that_keep_the_draft_idle(setup, spec_calls, case):
    """Word timestamps, an early-stop flag, segmented decode and beam search
    never take the speculative path, and the draft does not encode for
    them (JAX's `_encode` rule)."""
    target, draft, _, _ = setup["port"]
    compute = ComputeOptions(segmented_decode=case == "segmented_decode")
    pipe = WhisperPipeline(WhisperConfig(compute_options=compute, load=False), dims=DIMS, params=target,
                           draft_dims=DRAFT_DIMS, draft_params=draft, device="cpu",
                           alignment_heads=np.asarray([[0, 1], [1, 2]]))
    if case == "early_stop_flag":
        pipe.early_stop_flag = EarlyStopFlag()
    opts = DecodingOptions(**GREEDY, sample_length=6, word_timestamps=case == "word_timestamps",
                           beam_size=2 if case == "beam" else 5)
    res = pipe.transcribe(_audio(2.0, 3), opts)
    assert res.segments is not None
    assert not spec_calls and pipe._draft_kv is None
