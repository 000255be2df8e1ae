"""The decode loop's device-side form in the PyTorch port, on the CPU: the
filters at a tensor position against JAX's, `decoder_forward` at a tensor
position against the int one, the loop (greedy, alignment heads,
segmented with compaction) against JAX's, the sampler's pre-drawn noise,
and the launch accounting of a CUDA graph's capture and replays
(decoding/graph.py, with the CUDA calls stood in).

On the card the step is captured as a CUDA graph and replayed; here the
same `_step` runs eagerly, so these tests hold the body the card captures.
Inputs are made from numpy seeds and given to both packages.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

from whisperkit_tpu.decoding import filters as jfilters
from whisperkit_tpu.decoding import loop as jloop
from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.text import tokenizer as jtok
from whisperkit_tpu_torch.decoding import filters, graph, loop, sampler
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.ops import _build
from whisperkit_tpu_torch.text.tokenizer import special_tokens_for_vocab

V = 207
SP = special_tokens_for_vocab(V, whitespace_id=5)
JSP = jtok.special_tokens_for_vocab(V, whitespace_id=5)
DIMS = model.WhisperDims(80, V, 1500, 64, 4, 2, 64, 64, 4, 2)
JDIMS = jmodel.WhisperDims(*dataclasses.astuple(DIMS))
HEADS = ((0, 1), (1, 2))
SAMPLE_BEGIN = 3
# eight rows with different language tokens in their prompts
PROMPTS = [[SP.sot, SP.language_begin + i, SP.transcribe] for i in range(8)]


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
    """Raw and int8 cross K/V of 8 rows of random encoder output (numpy,
    N(0, 1), row r scaled by 0.1 ... 3.0, so that the rows' greedy decodes
    end at different steps) from the JAX projections, in both packages'
    layouts."""
    scales = np.linspace(0.1, 3.0, 8, dtype=np.float32)[:, None, None]
    enc = jnp.asarray(np.random.default_rng(4).standard_normal((8, 1500, 64)).astype(np.float32) * scales)
    jraw = jmodel.compute_cross_kv(jparams, enc, JDIMS)
    jq8 = jmodel.compute_cross_kv_quantized(jparams, enc, JDIMS)
    traw = tuple(_t(np.asarray(x)) for x in jraw)
    tq8 = tuple({k: _t(np.asarray(v)) for k, v in d.items()} for d in jq8)
    return {"raw": (jraw, traw), "q8": (jq8, tq8)}


# ---------------------------------------------------------------------------
# (1) the filters at a device position
# ---------------------------------------------------------------------------


def _token_buffer(rng, pos: int, kind: str) -> np.ndarray:
    """[4, 12] tokens: the prompt, then up to `pos` sampled tokens ending in
    a lone timestamp ("lone") or a timestamp pair ("paired") where room
    allows, earlier ones mixing rising timestamps and text."""
    buf = np.full((4, 12), SP.eot, np.int64)
    buf[:, :SAMPLE_BEGIN] = PROMPTS[0]
    for r in range(4):
        for p in range(SAMPLE_BEGIN, pos):
            buf[r, p] = SP.timestamp_begin + 2 * p + r if (p + r) % 2 else rng.integers(0, SP.eot)
        tail = [SP.timestamp_begin + 40 + r] if kind == "lone" else [SP.timestamp_begin + 40 + r] * 2
        for i, tok in enumerate(tail[::-1]):
            if pos - 1 - i >= SAMPLE_BEGIN:
                buf[r, pos - 1 - i] = tok
        if kind == "lone" and pos - 2 >= SAMPLE_BEGIN:
            buf[r, pos - 2] = rng.integers(0, SP.eot)
    return buf


@pytest.mark.parametrize("kind", ["lone", "paired"])
@pytest.mark.parametrize("offset", [0, 1, 2, 5])
def test_device_position_filters_match_jax(offset, kind):
    """apply_suppress_blank and apply_timestamp_rules at a 0-d tensor
    position against JAX's at the same traced position: the same -inf
    entries and equal finite values (exact: the same masks)."""
    pos = SAMPLE_BEGIN + offset
    rng = np.random.default_rng(10 * offset + len(kind))
    logits = rng.standard_normal((4, V)).astype(np.float32) * 3
    buf = _token_buffer(rng, pos, kind)
    tpos = torch.tensor(pos)
    ref = jfilters.apply_suppress_blank(jnp.asarray(logits), JSP, jnp.asarray(pos) == SAMPLE_BEGIN)
    ref = jfilters.apply_timestamp_rules(ref, jnp.asarray(buf, jnp.int32), jnp.asarray(pos), SAMPLE_BEGIN, JSP,
                                         jnp.asarray(50))
    out = filters.apply_suppress_blank(_t(logits), SP, tpos == SAMPLE_BEGIN)
    out = filters.apply_timestamp_rules(out, _t(buf), tpos, SAMPLE_BEGIN, SP, 50)
    ref, out = np.asarray(ref), out.numpy()
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    np.testing.assert_array_equal(out[np.isfinite(out)], ref[np.isfinite(ref)])
    # the int position (beam search, speculative decoding) gives the same
    same = filters.apply_timestamp_rules(
        filters.apply_suppress_blank(_t(logits), SP, pos == SAMPLE_BEGIN), _t(buf), pos, SAMPLE_BEGIN, SP, 50)
    np.testing.assert_array_equal(same.numpy(), out)


# ---------------------------------------------------------------------------
# (2) decoder_forward at a device position
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads", [None, HEADS], ids=["no_heads", "alignment_heads"])
@pytest.mark.parametrize("q8_self", [False, True], ids=["raw_cache", "int8_cache"])
def test_decoder_forward_at_a_tensor_position_is_bit_equal(tparams, cross, q8_self, heads):
    """One T == 1 step at position 5 after a 5-token prefill, over the int8
    cross-KV, once at the int position and once at a 0-d tensor position
    (the decode loop's form: pos_embed by index_select, the cache by
    index_copy_, the alignment into a staging row): logits, caches and
    alignment row bit-equal in float32; then two tokens at each kind of
    position, bit-equal too."""
    _, tc = cross["q8"]
    b = 2
    tc = tuple({k: v[:, :b] for k, v in part.items()} for part in tc)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, SP.eot, (b, 6)))
    caches = []
    for _ in range(2):
        k, v = model.init_kv_cache(DIMS, b, 8, torch.float32, "cpu", quantize=q8_self)
        model.decoder_forward(tparams, toks[:, :5], 0, k, v, *tc, DIMS)
        caches.append((k, v))
    mask = torch.full((1, 8), float("-inf"))
    mask[:, :6] = 0.0
    capture = [{}, {}]
    if heads is not None:
        capture = [{"alignment_heads": heads, "align_out": torch.zeros((1, b, len(heads), 1500))} for _ in range(2)]
    at_int = model.decoder_forward(tparams, toks[:, 5:], 5, *caches[0], *tc, DIMS, mask_row=mask, **capture[0])
    at_dev = model.decoder_forward(tparams, toks[:, 5:], torch.tensor(5), *caches[1], *tc, DIMS, mask_row=mask,
                                   **capture[1])
    assert torch.equal(at_int, at_dev)
    # the mask row a tensor position builds for itself is the int one's
    assert torch.equal(at_dev, model.decoder_forward(tparams, toks[:, 5:], torch.tensor(5), *caches[1], *tc, DIMS,
                                                     **capture[1]))
    for a, c in zip(caches[0], caches[1]):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(c)):
            assert torch.equal(x, y)
    if heads is not None:
        assert capture[1]["align_out"].abs().sum() > 0
        assert torch.equal(capture[0]["align_out"], capture[1]["align_out"])
    # T > 1 at a tensor position (speculative decoding's verify pass): the
    # slots pos + [0, T) and the causal mask over the whole cache, on the
    # device, give the int position's logits and caches
    two = model.decoder_forward(tparams, toks[:, 4:], torch.tensor(4), *caches[1], *tc, DIMS)
    assert torch.equal(two, model.decoder_forward(tparams, toks[:, 4:], 4, *caches[0], *tc, DIMS))
    for a, c in zip(caches[0], caches[1]):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(c)):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# (3) the loop against JAX's
# ---------------------------------------------------------------------------


# a positive EOT bias makes greedy rows finish at scattered steps
EOT_BIAS = np.zeros(V, np.float32)
EOT_BIAS[SP.eot] = 2.0
LOOP_KW = dict(sample_begin=SAMPLE_BEGIN, max_new_tokens=40, top_k=5, sot_index=0, use_timestamp_rules=True,
               suppress_blank=True)


@pytest.fixture(scope="module")
def jax_greedy(jparams, cross):
    """JAX's greedy decode_loop over the 8 rows with the timestamp rules,
    the EOT bias and the alignment heads."""
    scalars = jloop.DecodeScalars(jnp.float32(0.0), jnp.int32(1500), jnp.float32(float("-inf")),
                                  jax.random.PRNGKey(0))
    return jloop.decode_loop(jparams, *cross["raw"][0], jnp.asarray(PROMPTS, jnp.int32), jnp.asarray(EOT_BIAS),
                             scalars, dims=JDIMS, special=JSP, alignment_heads=HEADS, **LOOP_KW)


def _torch_loop(fn, tparams, tc, scalars=None, **kw):
    scalars = scalars or loop.DecodeScalars(0.0, 1500, float("-inf"))
    return fn(tparams, *tc, torch.tensor(PROMPTS), _t(EOT_BIAS), scalars, dims=DIMS, special=SP,
              alignment_heads=HEADS, **{**LOOP_KW, **kw})


@pytest.mark.parametrize("segmented", [False, True], ids=["decode_loop", "segmented_compacted"])
def test_greedy_loop_matches_jax(tparams, cross, jax_greedy, monkeypatch, segmented):
    """The greedy loop with timestamp rules and alignment heads gives JAX's
    tokens, and its alignment within 1e-5 over each row's decoded
    positions; segmented decode compacts (asserted) and gives them too."""
    sizes = []
    compact = loop._compact
    monkeypatch.setattr(loop, "_compact", lambda st, rows, n: (sizes.append(len(rows)), compact(st, rows, n))[1])
    if segmented:
        out = _torch_loop(loop.decode_loop_segmented, tparams, cross["raw"][1], segment_tokens=8, compact=True)
        assert sizes, "the decode never compacted"
    else:
        out = _torch_loop(loop.decode_loop, tparams, cross["raw"][1])
    ref_tokens = np.asarray(jax_greedy.tokens)
    finish = (ref_tokens[:, SAMPLE_BEGIN:] != SP.eot).sum(1)
    assert len(set(finish.tolist())) > 2, finish
    np.testing.assert_array_equal(out.tokens.numpy(), ref_tokens)
    np.testing.assert_allclose(out.token_logprobs.numpy(), np.asarray(jax_greedy.token_logprobs), rtol=1e-4,
                               atol=1e-4)
    for r in range(8):
        n = SAMPLE_BEGIN + int(finish[r]) + 1
        np.testing.assert_allclose(out.alignment[:n, r].numpy(), np.asarray(jax_greedy.alignment)[:n, r],
                                   rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# (4) launch accounting under a capture
# ---------------------------------------------------------------------------


class FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: records its calls."""

    def __init__(self):
        self.calls = []

    def capture_begin(self, capture_error_mode):
        self.calls.append(("begin", capture_error_mode))

    def capture_end(self):
        self.calls.append(("end",))

    def replay(self):
        self.calls.append(("replay",))

    def reset(self):
        self.calls.append(("reset",))


@pytest.fixture
def fake_cuda(monkeypatch):
    """The CUDA calls of _build.launch and graph.StepGraph stood in on the
    CPU, and a library whose launcher returns 0."""

    class Stream:
        cuda_stream = 0

        def __init__(self, *_):
            pass

        def wait_stream(self, _):
            pass

        def synchronize(self):
            pass

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda _: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda _: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *_: Stream())
    monkeypatch.setattr(torch.cuda, "default_stream", lambda *_: Stream())
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    _build.reset_launches()
    graph.reset_stats()
    yield
    _build.reset_launches()
    graph.reset_stats()


def test_replays_count_the_captured_launches_per_device(fake_cuda):
    """StepGraph runs the step once eagerly (counted), then captures it
    (recorded, not counted, in "thread_local" mode); each replay adds the
    record once, per device; the eager launches go on counting as before."""
    dev0, dev1 = torch.device("cuda", 0), torch.device("cuda", 1)

    def step(device):
        _build.launch("cross_attend_q8", "wk_cross_attend_q8", device)
        _build.launch("self_attend", "wk_self_attend", device)
        _build.launch("self_attend", "wk_self_attend", device)

    g0 = graph.StepGraph(lambda: step(dev0), dev0)
    g1 = graph.StepGraph(lambda: step(dev1), dev1)
    assert g0.graph.calls == [("begin", "thread_local"), ("end",)]
    assert _build.launches["self_attend"] == 4  # the two warm-up steps
    for _ in range(3):
        g0.replay()
    g1.replay()
    _build.launch("self_attend", "wk_self_attend", dev1)  # an eager launch
    assert _build.launches["cross_attend_q8"] == 2 + 4
    assert _build.launches["self_attend"] == 4 + 8 + 1
    assert _build.launches_by_device["cuda:0"]["self_attend"] == 2 + 6
    assert _build.launches_by_device["cuda:1"]["self_attend"] == 2 + 2 + 1
    assert _build.launches_by_device["cuda:1"]["cross_attend_q8"] == 1 + 1
    assert graph.stats_by_device["cuda:0"]["captures"] == 1
    assert graph.stats_by_device["cuda:0"]["replays"] == 3
    assert graph.stats_by_device["cuda:1"]["replays"] == 1
    g0.close()
    assert g0.graph.calls[-1] == ("reset",)


def test_a_capture_error_raises_and_ends_the_capture(fake_cuda):
    calls = []

    def step():
        calls.append(1)
        if len(calls) == 2:  # fails while captured
            raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        graph.StepGraph(step, torch.device("cuda", 0))
    assert _build._capture.record is None  # launches count again
    assert not graph.stats_by_device


# ---------------------------------------------------------------------------
# (5) the sampler's pre-drawn noise
# ---------------------------------------------------------------------------


@torch.inference_mode()
def _host_loop(tparams, tc, generator, temperature, top_k, steps):
    """The decode as a host loop over int positions, drawing its noise in
    sample_token from `generator`: the loop the device-position step
    replaced, for the noise's draw order."""
    prompt = torch.tensor(PROMPTS)
    b, p = prompt.shape
    pre = loop.prefill_window(tparams, *tc, prompt, dims=DIMS, special=SP, sample_begin=p, max_new_tokens=steps,
                              sot_index=0)
    tokens = torch.full((b, p + steps), SP.eot)
    tokens[:, :p] = prompt
    logits, done = pre.last_logits, torch.zeros(b, dtype=torch.bool)
    for pos in range(p, p + steps):
        f = filters.apply_suppress_blank(logits + _t(EOT_BIAS), SP, pos == p)
        f = filters.apply_timestamp_rules(f, tokens, pos, p, SP, 1500)
        token, _ = sampler.sample_token(f, temperature, generator, top_k)
        token = torch.where(done, SP.eot, token)
        tokens[:, pos] = token
        done = done | (token == SP.eot)
        if pos + 1 < p + steps:
            logits = model.decoder_forward(tparams, token[:, None], pos, pre.kv_k, pre.kv_v, *tc, DIMS)[:, -1]
    return tokens


@pytest.mark.parametrize("temperature, top_k", [(0.7, 5), (1.5, 3)])
def test_sampled_loop_draws_the_eager_samplers_noise(tparams, cross, temperature, top_k):
    """At temperature > 0 the loop draws each step's uniforms into its
    noise buffer before the step, from the same generator in the same
    order as sample_token would: the tokens equal the host loop's, in
    which sample_token draws for itself."""
    tc = cross["q8"][1]
    steps = 16
    ref = _host_loop(tparams, tc, torch.Generator().manual_seed(7), temperature, top_k, steps)
    scalars = loop.DecodeScalars(temperature, 1500, float("-inf"), torch.Generator().manual_seed(7))
    out = loop.decode_loop(tparams, *tc, torch.tensor(PROMPTS), _t(EOT_BIAS), scalars, dims=DIMS, special=SP,
                           sample_begin=SAMPLE_BEGIN, max_new_tokens=steps, top_k=top_k, sot_index=0,
                           use_timestamp_rules=True, suppress_blank=True)
    assert torch.equal(out.tokens, ref)
    # the noise made a difference: greedy picks other tokens
    greedy = loop.decode_loop(tparams, *tc, torch.tensor(PROMPTS), _t(EOT_BIAS),
                              loop.DecodeScalars(0.0, 1500, float("-inf")), dims=DIMS, special=SP,
                              sample_begin=SAMPLE_BEGIN, max_new_tokens=steps, top_k=top_k, sot_index=0,
                              use_timestamp_rules=True, suppress_blank=True)
    assert not torch.equal(out.tokens, greedy.tokens)
