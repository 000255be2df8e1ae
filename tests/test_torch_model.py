"""The PyTorch port's model, filters, sampler and decode loop against the
JAX package, on the CPU.

The same parameters (the JAX `init_params` tree, carried across with
`params_from_numpy`) and the same numpy inputs go through both packages at
float32. Where the JAX function reaches a Pallas kernel it runs as the JAX
package's own tests run it; the port's wrappers run their plain torch
versions for CPU tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperkit_tpu.decoding import filters as jfilters
from whisperkit_tpu.decoding import loop as jloop
from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.text.tokenizer import special_tokens_for_vocab as jspecial_tokens_for_vocab
from whisperkit_tpu_torch.core.device import resolve_device
from whisperkit_tpu_torch.decoding import filters, loop, sampler
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.text.tokenizer import special_tokens_for_vocab
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

V = 207
SP = special_tokens_for_vocab(V)  # the port's special tokens, for the port
JSP = jspecial_tokens_for_vocab(V)  # the same layout as the JAX package's type
DIMS = model.WhisperDims(80, V, 1500, 64, 4, 2, 64, 64, 4, 2)
JDIMS = jmodel.WhisperDims(*dataclasses.astuple(DIMS))
PROMPT = [SP.sot, SP.language_token("en"), SP.transcribe]


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(jax.random.PRNGKey(0), JDIMS, dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return model.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)


@pytest.fixture(scope="module")
def mel():
    rng = np.random.default_rng(0)
    return rng.standard_normal((2, 80, 3000)).astype(np.float32)


@pytest.fixture(scope="module")
def encoded(jparams, tparams, mel):
    """(JAX enc_out, port enc_out) for the same mel."""
    j = jmodel.encoder_forward(jparams, jnp.asarray(mel), JDIMS)
    t = model.encoder_forward(tparams, _t(mel), DIMS)
    return j, t


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def test_params_from_numpy_round_trips_the_jax_tree(jparams, tparams):
    tree = jax.tree.map(np.asarray, jparams)
    back = model.params_to_numpy(tparams)
    flat_a, tree_a = jax.tree.flatten(tree)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    assert len(tparams["encoder"]["blocks"]) == DIMS.n_audio_layer
    assert len(tparams["decoder"]["blocks"]) == DIMS.n_text_layer
    assert tparams["decoder"]["token_embed_f32"].dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_params_has_the_jax_structure(jparams, dtype):
    ours = model.init_params(0, DIMS, dtype, "cpu")
    assert ours["decoder"]["token_embed"].dtype == dtype
    assert ours["decoder"]["token_embed_f32"].dtype == torch.float32
    ref = jax.tree.map(lambda a: np.asarray(a).shape, jax.tree.map(np.asarray, jparams))
    got = jax.tree.map(lambda a: a.shape, model.params_to_numpy(ours))
    assert jax.tree.structure(ref) == jax.tree.structure(got)
    assert jax.tree.leaves(ref) == jax.tree.leaves(got)
    # zero and one initialisers as in JAX; the same seed draws the same values
    blk = ours["decoder"]["blocks"][0]
    assert float(blk["attn"]["q"]["b"].abs().max()) == 0.0
    assert float(blk["attn_ln"]["g"].float().min()) == 1.0
    again = model.init_params(0, DIMS, dtype, "cpu")
    assert torch.equal(again["decoder"]["token_embed"], ours["decoder"]["token_embed"])


def test_sinusoidal_positions_match_jax():
    np.testing.assert_array_equal(
        model.sinusoidal_positions(1500, 64), jmodel.sinusoidal_positions(1500, 64)
    )
    assert {k: dataclasses.astuple(v) for k, v in model.VARIANT_DIMS.items()} == {
        k: dataclasses.astuple(v) for k, v in jmodel.VARIANT_DIMS.items()
    }


# ---------------------------------------------------------------------------
# encoder and cross K/V
# ---------------------------------------------------------------------------


def test_encoder_forward_matches_jax(encoded):
    j, t = encoded
    assert t.shape == (2, 1500, 64)
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-4, atol=1e-4)


def test_layer_norm_gelu_and_conv_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    p = {"g": rng.standard_normal(64).astype(np.float32), "b": rng.standard_normal(64).astype(np.float32)}
    ref = jmodel.layer_norm(jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    out = model.layer_norm(_t(x), {k: _t(v) for k, v in p.items()})
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(model._gelu(_t(x))), np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6
    )
    xc = rng.standard_normal((2, 8, 30)).astype(np.float32)
    w = rng.standard_normal((16, 8, 3)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    for stride in (1, 2):
        ref = jmodel._conv1d(jnp.asarray(xc), jnp.asarray(w), jnp.asarray(b), stride)
        out = model._conv1d(_t(xc), _t(w), _t(b), stride)
        np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_compute_cross_kv_matches_jax(jparams, tparams, encoded):
    j, t = encoded
    jk, jv = jmodel.compute_cross_kv(jparams, j, JDIMS)
    tk, tv = model.compute_cross_kv(tparams, t, DIMS)
    for a, b in ((tk, jk), (tv, jv)):
        assert a.shape == (2, 2, 4, 1500, 16)
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_compute_cross_kv_quantized_matches_jax(jparams, tparams, encoded):
    """Same inputs (the JAX encoder output) so only the quantizer differs:
    scales equal to float32 rounding, int8 values equal up to ±1 on at most
    0.1% of entries (a value at a rounding boundary)."""
    j, _ = encoded
    jk, jv = jmodel.compute_cross_kv_quantized(jparams, j, JDIMS)
    tk, tv = model.compute_cross_kv_quantized(tparams, _t(np.asarray(j)), DIMS)
    for a, b in ((tk, jk), (tv, jv)):
        assert a["q8"].dtype == torch.int8 and a["q8"].shape == (2, 2, 4, 1500, 16)
        assert a["scale"].shape == (2, 2, 4, 1, 16)
        np.testing.assert_allclose(a["scale"].numpy(), np.asarray(b["scale"]), rtol=1e-5)
        diff = np.abs(a["q8"].numpy().astype(np.int32) - np.asarray(b["q8"]).astype(np.int32))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= 1e-3


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cross(jparams, tparams, encoded):
    """Raw and int8 cross K/V from the JAX encoder output, in both
    packages' layouts (the int8 ones are the JAX values carried across, so
    the decoders see identical operands)."""
    j, _ = encoded
    jraw = jmodel.compute_cross_kv(jparams, j, JDIMS)
    jq8 = jmodel.compute_cross_kv_quantized(jparams, j, JDIMS)
    traw = tuple(_t(np.asarray(x)) for x in jraw)
    tq8 = tuple({k: _t(np.asarray(v)) for k, v in d.items()} for d in jq8)
    return {"raw": (jraw, traw), "q8": (jq8, tq8)}


def _jax_decode(jparams, tokens, pos, kv, cross_kv):
    logits, kv, _ = jmodel.decoder_forward(
        jparams, jnp.asarray(tokens, jnp.int32), pos, kv[0], kv[1], *cross_kv, JDIMS
    )
    return np.asarray(logits), kv


@pytest.mark.parametrize("kind", ["raw", "q8"])
def test_decoder_prefill_and_step_match_jax(jparams, tparams, cross, kind):
    jc, tc = cross[kind]
    s = 16
    shape = (DIMS.n_text_layer, 2, DIMS.n_text_head, s, DIMS.head_dim)
    jkv = (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    prompt = np.asarray([PROMPT, PROMPT], np.int64)
    jl, jkv = _jax_decode(jparams, prompt, 0, jkv, jc)
    tk, tv = model.init_kv_cache(DIMS, 2, s, torch.float32, "cpu")
    tl = model.decoder_forward(tparams, _t(prompt), 0, tk, tv, *tc, DIMS)
    assert tl.dtype == torch.float32 and tl.shape == (2, 3, V)
    # int8: JAX's int32 and the port's float64 integer dots are both exact;
    # a probability at a requantization boundary may round the other way
    tol = 1e-4 if kind == "raw" else 2e-3
    np.testing.assert_allclose(_np(tl), jl, rtol=tol, atol=tol)
    np.testing.assert_allclose(tk.numpy()[:, :, :, :3], np.asarray(jkv[0])[:, :, :, :3], rtol=1e-4, atol=1e-4)

    step = np.asarray([[SP.timestamp_begin], [SP.timestamp_begin + 3]], np.int64)
    jl1, _ = _jax_decode(jparams, step, 3, jkv, jc)
    tl1 = model.decoder_forward(tparams, _t(step), 3, tk, tv, *tc, DIMS)
    np.testing.assert_allclose(_np(tl1), jl1, rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["raw", "q8"])
def test_incremental_decoding_equals_prefill(tparams, cross, kind):
    """Prefill of 3 tokens + one T==1 step (the self-attention kernel's
    plain version over the cache) gives the logits of a 4-token prefill."""
    _, tc = cross[kind]
    toks = torch.tensor([PROMPT + [SP.timestamp_begin]] * 2)
    k1, v1 = model.init_kv_cache(DIMS, 2, 16, torch.float32, "cpu")
    full = model.decoder_forward(tparams, toks, 0, k1, v1, *tc, DIMS)
    k2, v2 = model.init_kv_cache(DIMS, 2, 16, torch.float32, "cpu")
    model.decoder_forward(tparams, toks[:, :3], 0, k2, v2, *tc, DIMS)
    step = model.decoder_forward(tparams, toks[:, 3:], 3, k2, v2, *tc, DIMS)
    torch.testing.assert_close(step[:, 0], full[:, 3], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(k2[:, :, :, :4], k1[:, :, :, :4])


def _jax_q8_cache(s, b=2):
    shape = (DIMS.n_text_layer, b, DIMS.n_text_head, s, DIMS.head_dim)
    return tuple(
        {"q8": jnp.zeros(shape, jnp.int8), "scale": jnp.zeros(shape[:-1] + (1,), jnp.float32)}
        for _ in range(2)
    )


def _assert_q8_cache_close(ours, ref, upto):
    """int8 cache rows [0, upto): scales equal to float32 rounding, codes
    equal up to ±1 on at most 1% of entries (a value at a rounding
    boundary); rows after `upto` untouched (zero codes and scales)."""
    q8, scale = ours["q8"].numpy(), ours["scale"].numpy()
    np.testing.assert_allclose(scale[..., :upto, :], np.asarray(ref["scale"])[..., :upto, :], rtol=1e-5)
    diff = np.abs(q8[..., :upto, :].astype(np.int32) - np.asarray(ref["q8"])[..., :upto, :].astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-2
    assert not q8[..., upto:, :].any() and not scale[..., upto:, :].any()


def test_init_kv_cache_int8_form():
    k, v = model.init_kv_cache(DIMS, 3, 10, torch.float32, "cpu", quantize=True)
    for c in (k, v):
        assert c["q8"].dtype == torch.int8 and c["q8"].shape == (2, 3, 4, 10, 16)
        assert c["scale"].dtype == torch.float32 and c["scale"].shape == (2, 3, 4, 10, 1)
        assert not c["q8"].any() and not c["scale"].any()
    assert k["q8"].data_ptr() != v["q8"].data_ptr()


@pytest.mark.parametrize("kind", ["raw", "q8"])
def test_decoder_int8_self_cache_matches_jax(jparams, tparams, cross, kind):
    """The int8 self-KV cache: a 3-token prefill (plain `_attend_self_q8`)
    and one T==1 step (K5's plain version) against JAX's decoder, whose
    step runs `_attend_self_q8` too: logits within 2e-3 (a probability at
    a requantization boundary may round the other way), and the cache's
    codes and scales as JAX writes them."""
    jc, tc = cross[kind]
    s = 16
    prompt = np.asarray([PROMPT, PROMPT], np.int64)
    jl, jkv = _jax_decode(jparams, prompt, 0, _jax_q8_cache(s), jc)
    tk, tv = model.init_kv_cache(DIMS, 2, s, torch.float32, "cpu", quantize=True)
    tl = model.decoder_forward(tparams, _t(prompt), 0, tk, tv, *tc, DIMS)
    np.testing.assert_allclose(_np(tl), jl, rtol=2e-3, atol=2e-3)
    _assert_q8_cache_close(tk, jkv[0], 3)
    _assert_q8_cache_close(tv, jkv[1], 3)

    step = np.asarray([[SP.timestamp_begin], [SP.timestamp_begin + 3]], np.int64)
    jl1, jkv = _jax_decode(jparams, step, 3, jkv, jc)
    tl1 = model.decoder_forward(tparams, _t(step), 3, tk, tv, *tc, DIMS)
    np.testing.assert_allclose(_np(tl1), jl1, rtol=2e-3, atol=2e-3)
    _assert_q8_cache_close(tk, jkv[0], 4)
    _assert_q8_cache_close(tv, jkv[1], 4)


@pytest.mark.parametrize("kind", ["raw", "q8"])
def test_incremental_decoding_equals_prefill_int8_self_cache(tparams, cross, kind):
    """With the int8 self-KV cache, prefill of 3 tokens + one T==1 step
    (K5's plain version) gives the logits and the cache of a 4-token
    prefill (`_attend_self_q8`): the same int8 recipe on the same rows."""
    _, tc = cross[kind]
    toks = torch.tensor([PROMPT + [SP.timestamp_begin]] * 2)
    k1, v1 = model.init_kv_cache(DIMS, 2, 16, torch.float32, "cpu", quantize=True)
    full = model.decoder_forward(tparams, toks, 0, k1, v1, *tc, DIMS)
    k2, v2 = model.init_kv_cache(DIMS, 2, 16, torch.float32, "cpu", quantize=True)
    model.decoder_forward(tparams, toks[:, :3], 0, k2, v2, *tc, DIMS)
    step = model.decoder_forward(tparams, toks[:, 3:], 3, k2, v2, *tc, DIMS)
    torch.testing.assert_close(step[:, 0], full[:, 3], rtol=1e-4, atol=1e-4)
    for a, b in ((k1, k2), (v1, v2)):
        torch.testing.assert_close(a["scale"], b["scale"], rtol=1e-6, atol=0)
        assert (a["q8"].int() - b["q8"].int()).abs().max() <= 1


def test_cross_attend_raw_keeps_f32_scores():
    """bf16 operands: the raw cross path scores in float32 like JAX's
    force_f32_scores, so it agrees with an all-f32 attention to bf16
    output rounding."""
    rng = np.random.default_rng(4)
    q = _t(rng.standard_normal((1, 2, 1, 16)).astype(np.float32) * 4)
    k = _t(rng.standard_normal((1, 2, 50, 16)).astype(np.float32) * 4)
    v = _t(rng.standard_normal((1, 2, 50, 16)).astype(np.float32))
    ref = model._attend(q, k, v)
    out = model._cross_attend(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# filters and sampler
# ---------------------------------------------------------------------------


def _ts_rules_case(rng, pos, sample_begin=3):
    logits = rng.standard_normal((4, V)).astype(np.float32) * 3
    buf = np.full((4, 12), SP.eot, np.int64)
    buf[:, :sample_begin] = PROMPT
    for r in range(4):
        for p in range(sample_begin, pos):
            # rows mix text tokens and (rising) timestamps
            buf[r, p] = SP.timestamp_begin + p * (r + 1) if (p + r) % 2 else rng.integers(0, SP.eot)
    return logits, buf


@pytest.mark.parametrize("pos", [3, 4, 5, 6, 9])
@pytest.mark.parametrize("max_initial", [1500, 2])
def test_timestamp_rules_match_jax(pos, max_initial):
    rng = np.random.default_rng(pos * 10 + max_initial)
    logits, buf = _ts_rules_case(rng, pos)
    ref = jfilters.apply_timestamp_rules(
        jnp.asarray(logits), jnp.asarray(buf, jnp.int32), jnp.asarray(pos), 3, JSP,
        jnp.asarray(max_initial),
    )
    out = filters.apply_timestamp_rules(_t(logits), _t(buf), pos, 3, SP, max_initial)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("at_begin", [True, False])
def test_suppress_blank_matches_jax(at_begin):
    sp, jsp = special_tokens_for_vocab(V, whitespace_id=5), jspecial_tokens_for_vocab(V, whitespace_id=5)
    logits = np.random.default_rng(1).standard_normal((2, V)).astype(np.float32)
    ref = jfilters.apply_suppress_blank(jnp.asarray(logits), jsp, jnp.asarray(at_begin))
    out = filters.apply_suppress_blank(_t(logits), sp, at_begin)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_static_masks_match_jax():
    np.testing.assert_array_equal(
        filters.suppress_tokens_bias(V, [3, 5, 900]), jfilters.suppress_tokens_bias(V, [3, 5, 900])
    )
    np.testing.assert_array_equal(filters.language_token_mask(SP), jfilters.language_token_mask(JSP))
    assert filters.non_speech_token_ids(SP) == jfilters.non_speech_token_ids(JSP)


def test_sampler_greedy_matches_jax_and_top_k_draws_from_the_top():
    from whisperkit_tpu.decoding.sampler import sample_token as jsample

    logits = np.random.default_rng(3).standard_normal((3, V)).astype(np.float32) * 4
    jt, jlp = jsample(jnp.asarray(logits), jnp.float32(0.0), jax.random.PRNGKey(0), 5)
    tt, tlp = sampler.sample_token(_t(logits), 0.0)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-6, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    draws = [sampler.sample_token(_t(logits), 1.0, g, top_k=5)[0] for _ in range(20)]
    top5 = np.argsort(-logits, axis=-1)[:, :5]
    for d in draws:
        assert all(int(d[r]) in top5[r] for r in range(3))
    again = torch.Generator().manual_seed(0)
    assert torch.equal(sampler.sample_token(_t(logits), 1.0, again, top_k=5)[0], draws[0])


# ---------------------------------------------------------------------------
# decode loop
# ---------------------------------------------------------------------------


LOOP_KW = dict(
    sample_begin=3, max_new_tokens=20, top_k=5, sot_index=0,
    use_timestamp_rules=True, suppress_blank=True,
)


def _jax_loop(jparams, jc, suppress, first_threshold=float("-inf"), quantize_self_kv=False):
    scalars = jloop.DecodeScalars(
        temperature=jnp.float32(0.0),
        max_initial_timestamp_index=jnp.int32(1500),
        first_token_logprob_threshold=jnp.float32(first_threshold),
        rng_key=jax.random.PRNGKey(0),
    )
    prompt = jnp.asarray([PROMPT, PROMPT], jnp.int32)
    return jloop.decode_loop(
        jparams, *jc, prompt, jnp.asarray(suppress), scalars, dims=JDIMS, special=JSP,
        quantize_self_kv=quantize_self_kv, **LOOP_KW,
    )


def _torch_loop(
    tparams, tc, suppress, stop_check_interval=16, first_threshold=float("-inf"),
    quantize_self_kv=False,
):
    scalars = loop.DecodeScalars(0.0, 1500, first_threshold)
    prompt = torch.tensor([PROMPT, PROMPT])
    return loop.decode_loop(
        tparams, *tc, prompt, _t(suppress), scalars, dims=DIMS, special=SP,
        stop_check_interval=stop_check_interval, quantize_self_kv=quantize_self_kv, **LOOP_KW,
    )


def _filtered_jax_logits(jparams, jc, suppress, tokens_row, pos, q8_self=False):
    """JAX's filtered step logits at `pos` for row tokens_row[:pos]."""
    s = len(tokens_row)
    shape = (JDIMS.n_text_layer, 1, JDIMS.n_text_head, s, JDIMS.head_dim)
    kv = _jax_q8_cache(s, 1) if q8_self else (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    one_row = jax.tree.map(lambda a: a[:, :1], jc)
    logits, _ = _jax_decode(jparams, np.asarray([tokens_row[:pos]]), 0, kv, one_row)
    f = jnp.asarray(logits[:, -1]) + jnp.asarray(suppress)[None]
    f = jfilters.apply_suppress_blank(f, JSP, jnp.asarray(pos == 3))
    f = jfilters.apply_timestamp_rules(
        f, jnp.asarray([tokens_row], jnp.int32), jnp.asarray(pos), 3, JSP, jnp.asarray(1500)
    )
    return np.sort(np.asarray(f)[0])[::-1]


def test_decode_loop_greedy_tokens_equal_jax_raw_cross_kv(jparams, tparams, cross):
    suppress = filters.suppress_tokens_bias(V, [SP.translate, SP.sot])
    jc, tc = cross["raw"]
    ref = _jax_loop(jparams, jc, suppress)
    out = _torch_loop(tparams, tc, suppress)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(out.token_logprobs.numpy(), np.asarray(ref.token_logprobs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob), rtol=1e-4, atol=1e-6)


def test_decode_loop_greedy_tokens_int8_cross_kv(jparams, tparams, cross):
    """int8 cross-KV: tokens are identical to JAX's up to the first step
    where JAX's top-2 filtered logit gap is below 1e-3 (a requantization
    flip may decide such a near-tie either way)."""
    suppress = filters.suppress_tokens_bias(V, [SP.translate, SP.sot])
    jc, tc = cross["q8"]
    ref = np.asarray(_jax_loop(jparams, jc, suppress).tokens)
    out = _torch_loop(tparams, tc, suppress).tokens.numpy()
    for r in range(2):
        diff = np.nonzero(out[r] != ref[r])[0]
        if len(diff):
            pos = int(diff[0])
            top = _filtered_jax_logits(jparams, jc, suppress, ref[r], pos)
            assert top[0] - top[1] < 1e-3, f"row {r} diverged at {pos} with gap {top[0] - top[1]}"


@pytest.mark.parametrize("kind", ["raw", "q8"])
def test_decode_loop_greedy_tokens_int8_self_kv(jparams, tparams, cross, kind):
    """quantize_self_kv: the int8 self-KV cache through prefill and K5's
    plain version gives JAX's greedy tokens, up to the first step where
    JAX's own top-2 filtered logit gap is below 1e-3 (a requantization flip
    may decide such a near-tie either way)."""
    suppress = filters.suppress_tokens_bias(V, [SP.translate, SP.sot])
    jc, tc = cross[kind]
    ref = _jax_loop(jparams, jc, suppress, quantize_self_kv=True)
    out = _torch_loop(tparams, tc, suppress, quantize_self_kv=True)
    ref_tokens, out_tokens = np.asarray(ref.tokens), out.tokens.numpy()
    for r in range(2):
        diff = np.nonzero(out_tokens[r] != ref_tokens[r])[0]
        if len(diff):
            pos = int(diff[0])
            top = _filtered_jax_logits(jparams, jc, suppress, ref_tokens[r], pos, q8_self=True)
            assert top[0] - top[1] < 1e-3, f"row {r} diverged at {pos} with gap {top[0] - top[1]}"
    np.testing.assert_allclose(out.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob), rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("interval", [1, 16])
def test_decode_loop_early_stop_matches_jax(jparams, tparams, cross, interval):
    """A first-token floor of 0 ends every row at its first step. JAX's
    loop stops there; the port sees it at its next stop check, and the
    buffers are the same whatever the interval, because finished rows keep
    emitting EOT with log-probability 0; `length` is JAX's, the position
    after the step that left every row done."""
    suppress = filters.suppress_tokens_bias(V, [])
    jc, tc = cross["raw"]
    ref = _jax_loop(jparams, jc, suppress, first_threshold=0.0)
    out = _torch_loop(tparams, tc, suppress, stop_check_interval=interval, first_threshold=0.0)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.token_logprobs.numpy(), np.asarray(ref.token_logprobs))
    assert int(ref.length) == 4
    assert out.length == int(ref.length)


def test_prefill_is_reusable_across_rungs(tparams, cross):
    suppress = filters.suppress_tokens_bias(V, [])
    _, tc = cross["raw"]
    prompt = torch.tensor([PROMPT, PROMPT])
    pre = loop.prefill_window(
        tparams, *tc, prompt, dims=DIMS, special=SP, sample_begin=3, max_new_tokens=20, sot_index=0
    )
    scalars = loop.DecodeScalars(0.0, 1500, float("-inf"))
    kw = dict(dims=DIMS, special=SP, **LOOP_KW)
    first = loop.decode_loop(tparams, *tc, prompt, _t(suppress), scalars, prefill=pre, **kw)
    g = torch.Generator().manual_seed(3)
    loop.decode_loop(tparams, *tc, prompt, _t(suppress), scalars._replace(temperature=1.0, generator=g),
                     prefill=pre, **kw)
    again = loop.decode_loop(tparams, *tc, prompt, _t(suppress), scalars, prefill=pre, **kw)
    assert torch.equal(first.tokens, again.tokens)


def test_prefill_is_reusable_across_rungs_int8_self_kv(tparams, cross):
    """A sampled rung over the same int8-cache prefill leaves nothing the
    next greedy rung can read: each step writes codes and scale at its
    position before K5 reads it, and later positions are masked."""
    suppress = filters.suppress_tokens_bias(V, [])
    _, tc = cross["q8"]
    prompt = torch.tensor([PROMPT, PROMPT])
    pre = loop.prefill_window(
        tparams, *tc, prompt, dims=DIMS, special=SP, sample_begin=3, max_new_tokens=20,
        sot_index=0, quantize_self_kv=True,
    )
    assert isinstance(pre.kv_k, dict) and pre.kv_k["q8"].shape[3] == 23
    scalars = loop.DecodeScalars(0.0, 1500, float("-inf"))
    kw = dict(dims=DIMS, special=SP, **LOOP_KW)
    first = loop.decode_loop(tparams, *tc, prompt, _t(suppress), scalars, prefill=pre, **kw)
    g = torch.Generator().manual_seed(3)
    loop.decode_loop(tparams, *tc, prompt, _t(suppress), scalars._replace(temperature=1.0, generator=g),
                     prefill=pre, **kw)
    again = loop.decode_loop(tparams, *tc, prompt, _t(suppress), scalars, prefill=pre, **kw)
    assert torch.equal(first.tokens, again.tokens)
    assert torch.equal(first.token_logprobs, again.token_logprobs)


def test_detect_language_logits_match_jax(jparams, tparams, cross):
    jc, tc = cross["raw"]
    ref = jloop.detect_language_logits(jparams, *jc, dims=JDIMS, special=JSP)
    out = loop.detect_language_logits(tparams, *tc, dims=DIMS, special=SP)
    assert out.shape == (2, SP.n_languages)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_encode_window_quantized_matches_jax(jparams, tparams, mel):
    _, jk, _ = jloop.encode_window(jparams, jnp.asarray(mel), JDIMS, quantize_kv=True)
    enc, tk, tv = loop.encode_window(tparams, _t(mel), DIMS, quantize_kv=True)
    assert enc.shape == (2, 1500, 64) and set(tk) == {"q8", "scale"}
    np.testing.assert_allclose(tk["scale"].numpy(), np.asarray(jk["scale"]), rtol=1e-3)


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------


def test_resolve_device_is_explicit():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device(None)
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()  # "cuda" by default
    with pytest.raises(RuntimeError):
        model.init_params(0, DIMS, torch.float32, "cuda")
    with pytest.raises(RuntimeError):
        model.init_params(0, DIMS, torch.float32)
