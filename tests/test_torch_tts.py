"""The port's Qwen3-TTS stack (whisperkit_tpu_torch/models/qwen3_tts.py,
decoding/tts_loop.py, pipelines/tts.py, the TTS quantizer) against the JAX
package's on the CPU: the same weights (the port's init at TINY_TTS_DIMS,
carried across as numpy) and the same inputs, drawn with numpy from a seed.

In float32 the logits and hidden states agree within 1e-4 and the
waveforms within WAVE_TOL, and the codes are equal at temperature 0.
JAX's frame loop makes its backbone KV cache bf16 whatever the weights'
dtype, so its `lax.scan` rejects float32 weights; the float32 runs give it
a float32 cache (`jax_f32_cache`), nothing else changes. In bf16, JAX's
own configuration, logits differ by an ulp (XLA's and torch's bf16
rounding), so codes are held by the top-2-gap rule: each row's first
divergence must sit where the port's logits put JAX's choice within
BF16_GAP of its own.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

from whisperkit_tpu.decoding import tts_loop as jloop  # noqa: E402
from whisperkit_tpu.models import qwen3_tts as jm  # noqa: E402
from whisperkit_tpu.ops import quant as jquant  # noqa: E402
from whisperkit_tpu.pipelines import tts as jtts  # noqa: E402
from whisperkit_tpu_torch.decoding import tts_loop as tloop  # noqa: E402
from whisperkit_tpu_torch.models import qwen3_tts as tm  # noqa: E402
from whisperkit_tpu_torch.ops import quant as tquant  # noqa: E402
from whisperkit_tpu_torch.pipelines import tts as ttts  # noqa: E402

DIMS = tm.TINY_TTS_DIMS
TOL = 1e-4  # float32 logits, hidden states, caches
WAVE_TOL = 1e-4  # float32 waveforms (samples in [-1, 1])
BF16_GAP = 0.125  # 4 bf16 ulps of a logit near 4
CPU = "cpu"


def _sane_c2w(c2w, g):
    """Random Code2Wav weights whose conv cascade neither saturates the
    final clamp nor fades out (either would hide errors), made as
    tests/test_tts_parity.py makes them: every leaf perturbed, the conv
    kernels scaled (by 0.8 here, where the samples peak near 0.6)."""
    def leaf(_, t):
        t = t * (1 + 0.05 * torch.randn(t.shape, generator=g)) + 0.02 * torch.randn(t.shape, generator=g)
        return t * (0.8 if t.ndim == 3 else 1.0)
    return tm.map_tree(leaf, c2w)


def _numpy(tree):
    return tm.map_tree(lambda _, t: t.detach().cpu().float().numpy() if t.is_floating_point() else t.numpy(), tree)


@pytest.fixture(scope="module")
def trees():
    """(port tree, JAX tree, numpy tree), float32."""
    g = torch.Generator().manual_seed(0)
    tp = tm.init_tts_params(g, DIMS, torch.float32, CPU)
    tp["c2w"] = _sane_c2w(tp["c2w"], g)
    nt = _numpy(tp)
    return tp, jax.tree.map(jnp.asarray, nt), nt


@pytest.fixture(scope="module")
def quantized(trees):
    """bits → (port tree, JAX tree) with every linear quantized (min_size 1)."""
    tp, jp, _ = trees
    return {bits: (tquant.quantize_tts_params(tp, min_size=1, bits=bits),
                   jquant.quantize_tts_params(jp, min_size=1, bits=bits)) for bits in (8, 4)}


@pytest.fixture
def jax_f32_cache(monkeypatch):
    orig = jloop.init_code_kv_cache

    def f32_cache(dims, batch, max_seq=None):
        return tuple(c.astype(jnp.float32) for c in orig(dims, batch, max_seq))

    monkeypatch.setattr(jloop, "init_code_kv_cache", f32_cache)


def _j(x):
    return np.asarray(x, np.float32)


def _t(x):
    return x.detach().float().numpy()


def _inputs(seed, b=2, p=7):
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((b, p, DIMS.d_model)).astype(np.float32)
    trailing = rng.integers(0, DIMS.text_vocab, (b, 4))
    return embeds, trailing


# -- modules -------------------------------------------------------------------


def test_rms_norm_rope_and_quantized_products_match(trees):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(_t(tm.rms_norm(torch.from_numpy(x), torch.from_numpy(g))),
                               _j(jm.rms_norm(jnp.asarray(x), jnp.asarray(g))), atol=1e-6)
    pos = rng.integers(0, 300, (2, 3))
    cos, sin = tm._rope_angles(torch.from_numpy(pos), 1e6, 16)
    np.testing.assert_allclose(_t(tm._rope(torch.from_numpy(x), cos, sin)),
                               _j(jm._rope(jnp.asarray(x), jnp.asarray(pos), 1e6)), atol=2e-5)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    xx = rng.standard_normal((3, 64)).astype(np.float32)
    for qt, qj in ((tquant.quantize_weight, jquant.quantize_weight),
                   (tquant.quantize_weight_w4, jquant.quantize_weight_w4)):
        q, jq = qt(torch.from_numpy(w)), jax.tree.map(np.asarray, qj(jnp.asarray(w)))
        np.testing.assert_allclose(_t(tm._mm(torch.from_numpy(xx), q)), _j(jm._mm(jnp.asarray(xx), jq)), atol=1e-5)


def test_code_decoder_forward_with_left_pads_matches(trees):
    """Prefill of left-padded rows (rope_offset, key_invalid: a pad slot
    attends only to itself) and one step after it."""
    tp, jp, _ = trees
    embeds, _ = _inputs(2)
    pad = np.array([3, 0])
    s = 12
    invalid = (np.arange(s)[None] < pad[:, None])
    jk, jv = (c.astype(jnp.float32) for c in jm.init_code_kv_cache(DIMS, 2, s))
    tk, tv = tm.init_code_kv_cache(DIMS, 2, s, torch.float32, CPU)
    jl, jh, (jk, jv) = jm.code_decoder_forward(jp, jnp.asarray(embeds), 0, jk, jv, DIMS,
                                               rope_offset=jnp.asarray(-pad), key_invalid=jnp.asarray(invalid))
    tl, th = tm.code_decoder_forward(tp, torch.from_numpy(embeds), 0, tk, tv, DIMS,
                                     rope_offset=torch.from_numpy(-pad), key_invalid=torch.from_numpy(invalid))
    np.testing.assert_allclose(_t(tl), _j(jl), atol=TOL)
    np.testing.assert_allclose(_t(th), _j(jh), atol=TOL)
    assert np.isfinite(_t(th)).all()
    step = np.random.default_rng(3).standard_normal((2, 1, DIMS.d_model)).astype(np.float32)
    jl, jh, (jk, jv) = jm.code_decoder_forward(jp, jnp.asarray(step), 7, jk, jv, DIMS,
                                               rope_offset=jnp.asarray(7 - pad), key_invalid=jnp.asarray(invalid))
    tl, th = tm.code_decoder_forward(tp, torch.from_numpy(step), 7, tk, tv, DIMS,
                                     rope_offset=torch.from_numpy(7 - pad), key_invalid=torch.from_numpy(invalid))
    np.testing.assert_allclose(_t(tl), _j(jl), atol=TOL)
    np.testing.assert_allclose(_t(tk), _j(jk), atol=TOL)
    np.testing.assert_allclose(_t(tv), _j(jv), atol=TOL)


def test_multicode_forward_matches(trees):
    """The 15 heads at temperature 0: codes equal, codec_sum within TOL."""
    tp, jp, _ = trees
    hidden = np.random.default_rng(4).standard_normal((3, DIMS.d_model)).astype(np.float32)
    code0 = np.array([5, 700, 2047])
    jc, js = jm.multicode_forward(jp, jnp.asarray(hidden), jnp.asarray(code0), jax.random.PRNGKey(0),
                                  jnp.float32(0.0), dims=DIMS)
    tc, ts = tm.multicode_forward(tp, torch.from_numpy(hidden), torch.from_numpy(code0), 0.0, dims=DIMS)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(_t(ts), _j(js), atol=TOL)


@pytest.mark.parametrize("temperature", [0.7, 1e-6])
def test_sampler_picks_categoricals_token(temperature):
    """Given jax.random.categorical's own Gumbel noise, the port's sampler
    picks its token; temperature below 1e-4 divides by 1e-4."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 300)).astype(np.float32) * 3
    key = jax.random.PRNGKey(9)
    want = np.asarray(jm._sample_topk(jnp.asarray(logits), key, jnp.float32(temperature), 50))
    g = np.array(jax.random.gumbel(key, (6, 50), jnp.float32))
    got = tm.sample_topk(torch.from_numpy(logits), temperature, 50, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (tm.sample_topk(torch.from_numpy(logits), 0.0, 50).numpy() == logits.argmax(-1)).all()


def test_repetition_penalty_and_suppress_match():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, tm.CODEC_VOCAB)).astype(np.float32)
    counts = rng.integers(0, 2, (2, tm.CODEC_VOCAB))
    want = _j(jloop.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(counts), jnp.float32(1.05)))
    got = tloop.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(counts), 1.05)
    np.testing.assert_array_equal(_t(got), want)
    np.testing.assert_array_equal(tloop.suppress_bias(CPU).numpy(), jloop._SUPPRESS)


def test_code2wav_whole_and_streamed_match(trees):
    """Whole-utterance Code2Wav and speech_decoder_forward within WAVE_TOL
    of JAX's; the streamed blocks (first, ramp-up and steady context) equal
    the whole decode."""
    tp, jp, _ = trees
    c2w = DIMS.c2w
    codes = np.random.default_rng(7).integers(0, 2048, (2, 23, 16))
    want = _j(jm.speech_decoder_forward(jp, jnp.asarray(codes), DIMS))
    got = _t(tm.speech_decoder_forward(tp, torch.from_numpy(codes), DIMS))
    assert got.shape == (2, 23 * tm.SAMPLES_PER_FRAME) and 0.3 < np.abs(want).max() < 0.9
    np.testing.assert_allclose(got, want, atol=WAVE_TOL)
    assert (got[:, :c2w.conv_delay] == 0).all()
    cache = tm.init_code2wav_cache(c2w, 2, max_frames=64, device=CPU)
    blocks, pos = [], 0
    for n in (5, 9, 6, 3):
        wave, cache = tm.code2wav_decode_block(tp["c2w"], torch.from_numpy(codes[:, pos:pos + n]), cache, c2w,
                                               ctx_frames=min(pos, tm.C2W_CONTEXT_FRAMES))
        blocks.append(_t(wave))
        pos += n
    np.testing.assert_allclose(np.concatenate(blocks, 1), got, atol=1e-5)


def test_vocoder_sets_ieee_float32_itself(trees, monkeypatch):
    """The vocoder's entry points run with cuDNN's and cuBLAS's TF32 off
    whatever the process's flags, and restore them after; without the
    guard (`__wrapped__`) the process's flags hold."""
    tp, _, _ = trees
    c2w = DIMS.c2w
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen, stack = [], tm._c2w_conv_stack

    def spy(*args):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return stack(*args)

    monkeypatch.setattr(tm, "_c2w_conv_stack", spy)
    codes = torch.from_numpy(np.random.default_rng(8).integers(0, 2048, (1, 4, 16)))
    tm.speech_decoder_forward(tp, codes, DIMS)
    tm.code2wav_forward(tp["c2w"], codes, c2w)
    tm.code2wav_decode_block(tp["c2w"], codes, tm.init_code2wav_cache(c2w, 1, max_frames=8, device=CPU), c2w,
                             ctx_frames=0)
    tm.speech_decoder_forward.__wrapped__(tp, codes, DIMS)
    assert seen == [(False, False)] * 3 + [(True, True)]
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("min_size", [1 << 16, 1])
def test_quantized_trees_equal_jax(trees, quantized, bits, min_size):
    """quantize_tts_params gives JAX's codes and scales bit for bit: the
    heads at the default threshold, every linear at min_size 1."""
    tp, jp, _ = trees
    if min_size == 1:
        ours, ref = quantized[bits]
    else:
        ours = tquant.quantize_tts_params(tp, min_size=min_size, bits=bits)
        ref = jquant.quantize_tts_params(jp, min_size=min_size, bits=bits)
    ours = _numpy(ours)
    ref = jax.tree.map(lambda x: np.asarray(x).astype(np.float32) if x.dtype == jnp.bfloat16 else np.asarray(x), ref)
    flat, ref_flat = jax.tree.leaves_with_path(ours), jax.tree.leaves_with_path(ref)
    assert [p for p, _ in flat] == [p for p, _ in ref_flat]
    for (path, a), (_, b) in zip(flat, ref_flat):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    key = "w_q4" if bits == 4 else "w_q"
    assert key in ours["mc"]["heads"] and (key in ours["blocks"]["wq"]) == (min_size == 1)


# -- the frame loop -------------------------------------------------------------


def _loop_args(seed):
    embeds, trailing = _inputs(seed)
    return dict(embeds=embeds, pad=np.array([3, 0]), trailing=trailing, cap=np.array([5, 9]))


def _jax_loop(jp, a, n=9):
    out = jloop.tts_generate_loop(
        jp, jnp.asarray(a["embeds"]), jloop.TTSScalars(jnp.float32(0.0), jnp.float32(1.05), jax.random.PRNGKey(0)),
        dims=DIMS, max_new_tokens=n, top_k=50, prompt_pad=jnp.asarray(a["pad"]),
        trailing_text=jnp.asarray(a["trailing"]), step_cap=jnp.asarray(a["cap"]))
    return np.asarray(out.codes), np.asarray(out.n_frames), out


def _port_loop(tp, a, n=9, temperature=0.0, seed=0):
    out = tloop.tts_generate_loop(
        tp, torch.from_numpy(a["embeds"]), tloop.TTSScalars(temperature, 1.05, torch.Generator().manual_seed(seed)),
        dims=DIMS, max_new_tokens=n, top_k=50, prompt_pad=torch.from_numpy(a["pad"]),
        trailing_text=torch.from_numpy(a["trailing"]), step_cap=torch.from_numpy(a["cap"]))
    return out.codes.numpy(), out.n_frames.numpy(), out


def test_generate_loop_with_left_pads_matches_jax(trees, jax_f32_cache):
    """Temperature 0, a left-padded row with its own step cap: codes and
    frame counts equal to JAX's, the final KV within TOL; a row done emits
    EOS frames; the padded row's codes equal its run alone."""
    tp, jp, _ = trees
    a = _loop_args(8)
    jc, jn, jout = _jax_loop(jp, a)
    tc, tn, tout = _port_loop(tp, a)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tn, jn)
    assert tn.tolist() == [5, 9] and (tc[0, 5:] == tm.CODEC_EOS).all()
    np.testing.assert_allclose(_t(tout.kv[0]), _j(jout.kv[0]), atol=TOL)
    alone = dict(embeds=a["embeds"][:1, 3:], pad=np.array([0]), trailing=a["trailing"][:1], cap=a["cap"][:1])
    np.testing.assert_array_equal(_port_loop(tp, alone)[0][0], tc[0])


def test_generate_loop_ending_inside_a_segment_matches_jax_length_and_cache(trees, jax_f32_cache):
    """Step caps that leave every row done at frame 7, well inside the port's
    first segment of 16: `length` is JAX's 7 (the frames stepped until every
    row was done), and the final KV within TOL of JAX's, whose slots past
    that frame were never written."""
    tp, jp, _ = trees
    a = dict(_loop_args(8), cap=np.array([5, 7]))
    jc, jn, jout = _jax_loop(jp, a, n=20)
    tc, tn, tout = _port_loop(tp, a, n=20)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tn, jn)
    assert tout.length == int(jout.length) == 7
    for t, j in zip(tout.kv, jout.kv):
        np.testing.assert_allclose(_t(t), _j(j), atol=TOL)


@pytest.mark.parametrize("scheme", ["w8a16", "w4a16"])
def test_quantized_loop_matches_jax(quantized, jax_f32_cache, scheme):
    """The loop over W8A16 and W4A16 trees (every linear quantized): codes
    equal to JAX's at temperature 0."""
    tq, jq = quantized[4 if scheme == "w4a16" else 8]
    a = _loop_args(9)
    np.testing.assert_array_equal(_port_loop(tq, a)[0], _jax_loop(jq, a)[0])


def _spy_logits(monkeypatch):
    """Record the logits of every sampling call, in call order: code0, then
    the 15 heads, frame by frame."""
    seen = []

    def spy(fn):
        def wrapped(logits, *args, **kw):
            seen.append(logits.detach().float().clone())
            return fn(logits, *args, **kw)
        return wrapped

    monkeypatch.setattr(tloop, "sample_topk", spy(tloop.sample_topk))
    monkeypatch.setattr(tm, "sample_topk", spy(tm.sample_topk))
    return seen


def test_bf16_loop_within_the_gap_rule(trees, monkeypatch):
    """JAX's own configuration, bf16 weights and cache: every row's codes
    equal JAX's up to a first divergence, if any, where the port's logits
    (its own run so far being JAX's) put JAX's token within BF16_GAP of
    its own argmax."""
    _, _, nt = trees
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), nt)
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    assert tp["blocks"]["wq"].dtype == torch.bfloat16
    a = _loop_args(8)
    jc, _, _ = _jax_loop(jp, a)
    seen = _spy_logits(monkeypatch)
    tc, _, _ = _port_loop(tp, a)
    gaps = []
    for r in range(2):
        diff = np.argwhere(tc[r] != jc[r])
        if len(diff):
            f, j = diff[0]
            logits = seen[f * 16 + j][r]
            gaps.append(float(logits[tc[r, f, j]] - logits[jc[r, f, j]]))
    assert all(0 <= g <= BF16_GAP for g in gaps), gaps


def test_seeded_sampling_repeats_and_never_samples_the_suppressed_range(trees):
    tp, _, _ = trees
    a = _loop_args(10)
    a["cap"] = np.array([30, 30])
    c1, _, _ = _port_loop(tp, a, n=30, temperature=0.9, seed=3)
    c2, _, _ = _port_loop(tp, a, n=30, temperature=0.9, seed=3)
    c3, _, _ = _port_loop(tp, a, n=30, temperature=0.9, seed=4)
    np.testing.assert_array_equal(c1, c2)
    assert not np.array_equal(c1, c3)
    code0 = c1[:, :, 0]
    assert not ((code0 >= tm.SUPPRESS_BEGIN) & (code0 < tm.SUPPRESS_END) & (code0 != tm.CODEC_EOS)).any()
    eos = code0 == tm.CODEC_EOS
    assert (c1[~eos][:, 1:] < tm.HEAD_VOCAB).all() and (c1[eos] == tm.CODEC_EOS).all()


# -- the pipeline ---------------------------------------------------------------

TEXT = "Hello world. This is a test of the speech pipeline! Does it chunk? Yes."


def _pipes(trees, **kw):
    tp, jp, _ = trees
    return jtts.TTSPipeline(DIMS, params=jp, **kw), ttts.TTSPipeline(DIMS, params=tp, device=CPU, **kw)


def _options(**kw):
    base = dict(max_new_tokens=8, temperature=0.0, seed=1, target_chunk_size=24, min_chunk_size=5,
                use_prompt_cache=False)
    return jtts.GenerationOptions(**{**base, **kw}), ttts.GenerationOptions(**{**base, **kw})


def test_generate_chunked_matches_jax(trees, jax_f32_cache):
    """Sentence chunks as one batch (B = 3) with the crossfade: the same
    chunks and waveform within WAVE_TOL. (The JAX pipeline's `frames` also
    counts the copies of the last row that its mesh pads the batch with,
    8 CPU devices here; the port's counts the chunks' frames.)"""
    jpipe, tpipe = _pipes(trees)
    jo, to = _options()
    ref, ours = jpipe.generate(TEXT, jo), tpipe.generate(TEXT, to)
    assert ours.timings.chunks == ref.timings.chunks == 3
    assert ours.timings.frames == 3 * to.max_new_tokens
    assert ours.audio.shape == ref.audio.shape and ours.sample_rate == tm.OUTPUT_SAMPLE_RATE
    np.testing.assert_allclose(ours.audio, ref.audio, atol=WAVE_TOL)


def test_stream_blocks_match_generate(trees, jax_f32_cache):
    """stream_blocks (blocks of 16 frames, first and steady context) against
    JAX's whole-utterance generate of the same text as one chunk."""
    jpipe, tpipe = _pipes(trees)
    jo, to = _options(max_new_tokens=24, chunking_strategy="none")
    ref = jpipe.generate("stream equivalence", jo).audio
    blocks = list(tpipe.stream_blocks("stream equivalence", to, block_frames=16))
    assert [len(b) for b in blocks] == [16 * tm.SAMPLES_PER_FRAME, 8 * tm.SAMPLES_PER_FRAME]
    np.testing.assert_allclose(np.concatenate(blocks), ref, atol=WAVE_TOL)
    engine, thread = tpipe.play_streaming("stream equivalence", to, ttts.PlaybackStrategy.STREAM, block_frames=16)
    thread.join(timeout=120)
    assert not thread.is_alive()
    out = np.concatenate([engine.pull(4800) for _ in range(len(ref) // 4800 + 1)])
    assert engine.drained and engine.pulled_samples == len(ref)
    assert np.abs(out[:len(ref)]).max() > 0


def test_prompt_cache_hit_matches_miss_and_a_jax_cache_loads(trees, jax_f32_cache, tmp_path):
    """A prompt-cache hit gives the codes (and audio within WAVE_TOL) of the
    miss; a cache saved by the JAX package loads in the port and gives
    JAX's audio on it."""
    jpipe, tpipe = _pipes(trees)
    jo, to = _options(voice="serena", instruction="Speak slowly.")
    miss = tpipe.generate(TEXT, to)
    to_hit = dataclasses.replace(to, use_prompt_cache=True)
    tpipe.build_prompt_cache(to_hit)
    kv, plen = tpipe.prompt_cache.get("serena", "english", "Speak slowly.")
    assert kv[0].shape[3] == plen > 7
    hit = tpipe.generate(TEXT, to_hit)
    assert hit.timings.frames == miss.timings.frames
    np.testing.assert_allclose(hit.audio, miss.audio, atol=WAVE_TOL)

    jo_hit = dataclasses.replace(jo, use_prompt_cache=True)
    jpipe.build_prompt_cache(jo_hit)
    path = tmp_path / "cache.npz"
    jpipe.prompt_cache.save(path)
    jfresh = jtts.TTSPipeline(DIMS, params=jpipe.params)
    jfresh.prompt_cache.load(path)
    tfresh = ttts.TTSPipeline(DIMS, params=tpipe.params, device=CPU)
    tfresh.prompt_cache.load(path)
    loaded = tfresh.prompt_cache.get("serena", "english", "Speak slowly.")
    assert loaded[1] == plen and loaded[0][0].dtype == torch.bfloat16
    ref = jfresh.generate(TEXT, jo_hit)
    ours = tfresh.generate(TEXT, to_hit)
    assert ours.timings.frames == miss.timings.frames
    np.testing.assert_allclose(ours.audio, ref.audio, atol=WAVE_TOL)
    # and the port's own save loads as it was
    tpipe.prompt_cache.save(tmp_path / "ours.npz")
    back = ttts.TTSPromptCache(CPU)
    back.load(tmp_path / "ours.npz")
    np.testing.assert_array_equal(back.get("serena", "english", "Speak slowly.")[0][1].float().numpy(),
                                  kv[1].to(torch.bfloat16).float().numpy())


def test_prompt_layout_and_helpers_match(trees):
    jpipe, tpipe = _pipes(trees)
    jo, to = _options(voice="uncle-fu", language="japanese", instruction="Whisper.")
    assert tpipe._chunk_tracks("Hello world", to) == jpipe._chunk_tracks("Hello world", jo)
    assert tpipe._speaker_id("nobody") == jpipe._speaker_id("nobody") == tm.SPEAKERS[tm.DEFAULT_SPEAKER]
    assert ttts.TextChunker().chunk(TEXT, 30, 5) == jtts.TextChunker().chunk(TEXT, 30, 5)
    assert ttts.TTS_VARIANTS.keys() == jtts.TTS_VARIANTS.keys()
    for name, dims in ttts.TTS_VARIANTS.items():
        assert dataclasses.asdict(dims) == dataclasses.asdict(jtts.TTS_VARIANTS[name])
    assert [f.name for f in dataclasses.fields(ttts.SpeechTimings)] == [
        f.name for f in dataclasses.fields(jtts.SpeechTimings)]
    assert dataclasses.asdict(ttts.GenerationOptions()) == dataclasses.asdict(jtts.GenerationOptions())
    for name in ("CODEC_PAD", "CODEC_BOS", "CODEC_EOS", "CODEC_THINK", "CODEC_THINK_BOS", "CODEC_THINK_EOS",
                 "TEXT_PAD", "TEXT_BOS", "CODEC_VOCAB", "HEAD_VOCAB", "SUPPRESS_BEGIN", "SUPPRESS_END",
                 "SPEAKERS", "TTS_LANGUAGES", "SAMPLES_PER_FRAME", "C2W_CONTEXT_FRAMES"):
        assert getattr(tm, name) == getattr(jm, name), name
    t = ttts.SpeechTimings(generate_seconds=2.0, total_seconds=4.0, frames=50)
    j = jtts.SpeechTimings(generate_seconds=2.0, total_seconds=4.0, frames=50)
    assert (t.ms_per_step, t.frames_per_second, t.real_time_ratio) == (
        j.ms_per_step, j.frames_per_second, j.real_time_ratio)


def test_pipeline_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: this checks a host without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttts.TTSPipeline()
    with pytest.raises(ValueError, match="unknown quantization"):
        ttts.TTSPipeline(device=CPU, quantize="w8a8")
