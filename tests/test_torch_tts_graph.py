"""The TTS frame loop's device-side form in the PyTorch port, on the CPU:
the backbone step at a slot held in a 0-d tensor against JAX's
`code_decoder_forward` (left pads, a cached prefix), segments resumed
against one call, the noise's draw order against `parallel/mesh.uniform`
frame by frame, the state's buffers kept in place, and the graph's
capture and replays with a stand-in for `decoding/graph.StepGraph`.

On the card a frame is captured as a CUDA graph and replayed; here the
same `_frame` runs eagerly, so these tests hold the body the card
captures. Inputs are made from numpy seeds and given to both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

from whisperkit_tpu.models import qwen3_tts as jm  # noqa: E402
from whisperkit_tpu_torch.decoding import tts_loop as tloop  # noqa: E402
from whisperkit_tpu_torch.models import qwen3_tts as tm  # noqa: E402
from whisperkit_tpu_torch.parallel import mesh  # noqa: E402
from whisperkit_tpu_torch.pipelines import tts as ttts  # noqa: E402

DIMS = tm.TINY_TTS_DIMS
TOL = 1e-4  # float32 logits, hidden states, caches (tests/test_torch_tts.py's)
CPU = "cpu"
FRAMES = 16
NOISE_WIDTH = 50 + 15 * tloop.HEAD_TOP_K  # top-k 50, then the 15 heads' top 5


@pytest.fixture(scope="module")
def trees():
    """(port tree, JAX tree), float32."""
    tp = tm.init_tts_params(torch.Generator().manual_seed(0), DIMS, torch.float32, CPU)
    nt = tm.map_tree(lambda _, t: t.numpy(), tp)
    return tp, jax.tree.map(jnp.asarray, nt)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.detach().float().numpy()


# ---------------------------------------------------------------------------
# (1) the backbone step at a device slot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cached_len", [0, 4])
def test_backbone_step_at_a_device_slot_matches_jax(trees, cached_len):
    """A left-padded prompt prefilled at an int slot (after a restored
    prefix of `cached_len` slots), then two steps at a slot held in a 0-d
    int64 tensor: K/V written at the slot, the whole cache attended under
    `key_pos <= slot` and the pad mask, rotary at slot - pad. Logits,
    hidden states and both caches within TOL of JAX's at the same slots."""
    tp, jp = trees
    rng = np.random.default_rng(20 + cached_len)
    b, p, s = 2, 6, 16
    pad = np.array([2, 0])
    slot_idx = np.arange(s)[None]
    invalid = (slot_idx >= cached_len) & (slot_idx < cached_len + pad[:, None])
    shape = (DIMS.n_layer, b, DIMS.n_kv_head, s, DIMS.head_dim)
    jk, jv = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    # a restored prefix: the same K/V rows in every batch row
    jk[:, :, :, :cached_len] = rng.standard_normal((DIMS.n_layer, 1, DIMS.n_kv_head, cached_len, DIMS.head_dim))
    jv[:, :, :, :cached_len] = rng.standard_normal((DIMS.n_layer, 1, DIMS.n_kv_head, cached_len, DIMS.head_dim))
    tk, tv = torch.from_numpy(jk.copy()), torch.from_numpy(jv.copy())
    jk, jv = jnp.asarray(jk), jnp.asarray(jv)
    embeds = rng.standard_normal((b, p, DIMS.d_model)).astype(np.float32)
    jl, jh, (jk, jv) = jm.code_decoder_forward(
        jp, jnp.asarray(embeds), cached_len, jk, jv, DIMS,
        rope_offset=jnp.asarray(cached_len - pad), key_invalid=jnp.asarray(invalid))
    tl, th = tm.code_decoder_forward(
        tp, torch.from_numpy(embeds), cached_len, tk, tv, DIMS,
        rope_offset=torch.from_numpy(cached_len - pad), key_invalid=torch.from_numpy(invalid))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL)
    for i in range(2):
        slot = cached_len + p + i
        step = rng.standard_normal((b, 1, DIMS.d_model)).astype(np.float32)
        jl, jh, (jk, jv) = jm.code_decoder_forward(
            jp, jnp.asarray(step), slot, jk, jv, DIMS,
            rope_offset=jnp.asarray(slot - pad), key_invalid=jnp.asarray(invalid))
        slot_dev = torch.tensor(slot)
        tl, th = tm.code_decoder_forward(
            tp, torch.from_numpy(step), slot_dev, tk, tv, DIMS,
            rope_offset=slot_dev - torch.from_numpy(pad), key_invalid=torch.from_numpy(invalid))
        assert tl.shape == (b, 1, tm.CODEC_VOCAB) and th.shape == (b, 1, DIMS.d_model)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL)
        np.testing.assert_allclose(_np(th), _np(jh), atol=TOL)
        np.testing.assert_allclose(_np(tk), _np(jk), atol=TOL)
        np.testing.assert_allclose(_np(tv), _np(jv), atol=TOL)
        assert not tk[:, :, :, slot + 1:].any()  # nothing written past the slot


# ---------------------------------------------------------------------------
# (2) segments, noise, buffers
# ---------------------------------------------------------------------------


def _inputs(seed=8, cap=(7, 13)):
    rng = np.random.default_rng(seed)
    return dict(embeds=rng.standard_normal((2, 7, DIMS.d_model)).astype(np.float32), pad=np.array([3, 0]),
                trailing=rng.integers(0, DIMS.text_vocab, (2, 4)), cap=np.array(cap))


def _state(tp, a, generator, frames=FRAMES):
    """The prefilled state, its cache sized as `tts_generate_loop` sizes it."""
    return tloop.tts_prefill_state(
        tp, torch.from_numpy(a["embeds"]), torch.from_numpy(a["trailing"]), torch.from_numpy(a["cap"]),
        generator, dims=DIMS, max_seq=a["embeds"].shape[1] + frames + 1, prompt_pad=torch.from_numpy(a["pad"]))


def _scalars(temperature, generator):
    return tloop.TTSScalars(temperature, 1.05, generator)


def _segments(tp, st, scalars, seg, frames=FRAMES):
    parts = []
    while st.step < frames:
        codes, st = tloop.tts_generate_segment(tp, st, scalars, dims=DIMS, n_frames=min(seg, frames - st.step))
        parts.append(codes)
    return torch.cat(parts, dim=1)


@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("seg", [3, 5, 16])
def test_segments_resume_as_one_call(trees, seg, temperature):
    """FRAMES frames in segments of `seg` give one call's codes, `done`,
    counts, frame index and cache bit for bit; row 0's step cap (7) ends
    it inside a segment; `tts_generate_loop` gives the same codes, and
    the same `length` and cache up to it."""
    tp, _ = trees
    a = _inputs()
    one = _state(tp, a, torch.Generator().manual_seed(5))
    whole, _ = tloop.tts_generate_segment(
        tp, one, _scalars(temperature, one.generator), dims=DIMS, n_frames=FRAMES)
    gen = torch.Generator().manual_seed(5)
    st = _state(tp, a, gen)
    codes = _segments(tp, st, _scalars(temperature, gen), seg)
    assert torch.equal(codes, whole)
    assert (codes[0, 7:] == tm.CODEC_EOS).all() and (codes[0, :7, 0] != tm.CODEC_EOS).all()
    assert st.step == one.step == int(st.step_dev) == FRAMES
    for name in ("done", "counts", "logits", "hidden"):
        assert torch.equal(getattr(st, name), getattr(one, name)), name
    for x, y in zip(st.kv, one.kv):
        assert torch.equal(x, y)
    length = int(tloop._frames_until_done(codes[:, :, 0], st.step_cap))
    assert length == 13

    out = tloop.tts_generate_loop(
        tp, torch.from_numpy(a["embeds"]), _scalars(temperature, torch.Generator().manual_seed(5)), dims=DIMS,
        max_new_tokens=FRAMES, prompt_pad=torch.from_numpy(a["pad"]), trailing_text=torch.from_numpy(a["trailing"]),
        step_cap=torch.from_numpy(a["cap"]))
    assert torch.equal(out.codes, whole) and out.length == length
    used = st.bos_slot + 1 + length
    for x, y in zip(out.kv, st.kv):
        assert torch.equal(x[:, :, :, :used], y[:, :, :, :used]) and not x[:, :, :, used:].any()


def _record_noise(monkeypatch) -> list:
    """Each frame's noise buffer as the frame reads it."""
    seen, frame = [], tloop._frame

    def spy(params, st, *args):
        if st.noise_u is not None:
            seen.append(st.noise_u.clone())
        frame(params, st, *args)

    monkeypatch.setattr(tloop, "_frame", spy)
    return seen


def _loop(tp, a, temperature, generator, frames=12):
    return tloop.tts_generate_loop(
        tp, torch.from_numpy(a["embeds"]), _scalars(temperature, generator), dims=DIMS, max_new_tokens=frames,
        prompt_pad=torch.from_numpy(a["pad"]), trailing_text=torch.from_numpy(a["trailing"]),
        step_cap=torch.from_numpy(a["cap"]))


def test_seeded_noise_is_mesh_uniform_frame_by_frame(trees, monkeypatch):
    """At T 0.9 each frame's noise buffer holds the next
    `parallel/mesh.uniform` draw of [B, top_k + 15 · HEAD_TOP_K], drawn in
    frame order: from a torch.Generator, from a RowDraws view of the
    whole batch (the same numbers, the same codes), and from a shard's
    view (its rows of each shared draw)."""
    tp, _ = trees
    a = _inputs(cap=(12, 12))
    seen = _record_noise(monkeypatch)
    out = _loop(tp, a, 0.9, torch.Generator().manual_seed(3))
    ref_gen = torch.Generator().manual_seed(3)
    assert len(seen) == 12
    for u in seen:
        assert torch.equal(u, mesh.uniform(ref_gen, (2, NOISE_WIDTH), CPU))

    by_gen, seen[:] = list(seen), []
    shared = mesh.SharedDraws(torch.Generator().manual_seed(3), 2)
    rows = _loop(tp, a, 0.9, shared.rows(slice(0, 2)))
    assert all(torch.equal(x, y) for x, y in zip(seen, by_gen)) and len(seen) == len(by_gen)
    assert torch.equal(rows.codes, out.codes)

    seen[:] = []
    shard = mesh.SharedDraws(torch.Generator().manual_seed(3), 3)
    _loop(tp, a, 0.9, shard.rows(slice(1, 3)))
    assert len(seen) == len(shard._draws) == 12
    for u, draw in zip(seen, shard._draws):
        assert torch.equal(u, draw[1:3])
    greedy = _loop(tp, a, 0.0, torch.Generator().manual_seed(3))
    assert not torch.equal(greedy.codes, out.codes)  # the noise made a difference


def test_greedy_frames_draw_nothing(trees):
    tp, _ = trees
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()
    st = _state(tp, _inputs(), gen)
    tloop.tts_generate_segment(tp, st, _scalars(0.0, gen), dims=DIMS, n_frames=4)
    assert st.noise_u is None and torch.equal(gen.get_state(), before)


def _buffers(st) -> dict:
    out = {}
    for f in dataclasses.fields(st):
        value = getattr(st, f.name)
        for i, t in enumerate(value if isinstance(value, tuple) else (value,)):
            if isinstance(t, torch.Tensor):
                out[f"{f.name}{i}"] = t.data_ptr()
    return out


def test_frames_keep_every_state_buffer_in_place(trees):
    """A frame run twice (and in a second segment) writes every state
    tensor in place: the CPU's proxy for what a CUDA graph, which froze
    the addresses at its capture, needs."""
    tp, _ = trees
    gen = torch.Generator().manual_seed(1)
    st = _state(tp, _inputs(), gen)
    scalars = _scalars(0.9, gen)
    tloop.tts_generate_segment(tp, st, scalars, dims=DIMS, n_frames=1)  # makes the noise buffer
    ptrs = _buffers(st)
    assert {"kv0", "kv1", "codes0", "step_dev0", "noise_u0", "logits0", "hidden0", "done0", "counts0"} <= set(ptrs)
    tloop.tts_generate_segment(tp, st, scalars, dims=DIMS, n_frames=2)
    tloop.tts_generate_segment(tp, st, scalars, dims=DIMS, n_frames=1)
    assert _buffers(st) == ptrs and st.step == int(st.step_dev) == 4


def test_a_segment_past_the_cache_raises(trees):
    tp, _ = trees
    gen = torch.Generator().manual_seed(1)
    st = _state(tp, _inputs(), gen, frames=4)
    with pytest.raises(ValueError, match="exceed"):
        tloop.tts_generate_segment(tp, st, _scalars(0.0, gen), dims=DIMS, n_frames=6)
    assert st.step == 0


# ---------------------------------------------------------------------------
# (3) the graph's capture and replays, StepGraph stood in
# ---------------------------------------------------------------------------


class FakeGraph:
    """StepGraph's calls on the CPU: the constructor runs the frame once
    (the real one runs it, then captures it without running it), each
    replay runs it again."""

    def __init__(self, step, device):
        self.step, self.device, self.replays, self.closed = step, device, 0, False
        step()
        self.made.append(self)

    def replay(self):
        self.replays += 1
        self.step()

    def close(self):
        self.closed = True


@pytest.fixture
def graphs(monkeypatch):
    """The frames of every loop on the CPU run as a FakeGraph; → the
    graphs made, in order."""
    made = []
    monkeypatch.setattr(FakeGraph, "made", made, raising=False)
    monkeypatch.setattr(tloop, "StepGraph", FakeGraph)
    monkeypatch.setattr(tloop, "_graphs_on", lambda device: True)
    return made


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_the_loop_captures_once_and_replays_every_later_frame(trees, graphs, temperature):
    """A loop of two segments (row 1 runs past the first): one capture,
    a replay for every frame after the first, the graph closed at the
    end; codes, frame counts, `length` and cache equal to the eager
    loop's (`cuda_graph=False`, which makes no graph)."""
    tp, _ = trees
    a = _inputs(cap=(7, 20))

    def run(cuda_graph):
        return tloop.tts_generate_loop(
            tp, torch.from_numpy(a["embeds"]), _scalars(temperature, torch.Generator().manual_seed(2)), dims=DIMS,
            max_new_tokens=24, prompt_pad=torch.from_numpy(a["pad"]), trailing_text=torch.from_numpy(a["trailing"]),
            step_cap=torch.from_numpy(a["cap"]), cuda_graph=cuda_graph)

    eager = run(False)
    assert not graphs
    out = run(True)
    (g,) = graphs
    assert g.replays == 24 - 1 and g.closed
    assert torch.equal(out.codes, eager.codes) and torch.equal(out.n_frames, eager.n_frames)
    assert out.length == eager.length == 20
    for x, y in zip(out.kv, eager.kv):
        assert torch.equal(x, y)


def test_new_sampling_scalars_capture_anew(trees, graphs):
    """A segment at other scalars than the graph's releases it and
    captures again (with its own noise buffer, or none at T 0)."""
    tp, _ = trees
    gen = torch.Generator().manual_seed(1)
    st = _state(tp, _inputs(), gen)
    tloop.tts_generate_segment(tp, st, _scalars(0.9, gen), dims=DIMS, n_frames=3)
    tloop.tts_generate_segment(tp, st, _scalars(0.9, gen), dims=DIMS, n_frames=2)
    assert len(graphs) == 1 and graphs[0].replays == 4 and st.noise_u is not None
    tloop.tts_generate_segment(tp, st, _scalars(0.0, gen), dims=DIMS, n_frames=2)
    assert len(graphs) == 2 and graphs[0].closed and not graphs[1].closed and st.noise_u is None
    tloop.tts_release(st)
    assert graphs[1].closed and st.graph is None


def _options(**kw):
    base = dict(max_new_tokens=8, temperature=0.9, seed=1, target_chunk_size=24, min_chunk_size=5,
                use_prompt_cache=False)
    return ttts.GenerationOptions(**{**base, **kw})


TEXT = "Hello world. This is a test of the speech pipeline! Does it chunk? Yes."


def test_pipeline_paths_run_on_the_graph(trees, monkeypatch):
    """generate on one device and on a mesh of two (a graph per device
    thread), stream_blocks (one graph for the whole stream, freed when it
    ends) and a prompt-cache hit give the eager runs' audio exactly."""
    tp, _ = trees
    one = ttts.TTSPipeline(DIMS, params=tp, device=CPU)
    two = ttts.TTSPipeline(DIMS, params=tp, device=[CPU, CPU])
    hit = _options(use_prompt_cache=True, instruction="Speak slowly.")
    one.build_prompt_cache(hit)

    def runs():
        return {
            "one": one.generate(TEXT, _options()).audio,
            "mesh": two.generate(TEXT, _options()).audio,
            "stream": np.concatenate(list(one.stream_blocks("stream this", _options(max_new_tokens=40), 16))),
            "hit": one.generate(TEXT, hit).audio,
        }

    eager = runs()
    made = []
    monkeypatch.setattr(FakeGraph, "made", made, raising=False)
    monkeypatch.setattr(tloop, "StepGraph", FakeGraph)
    monkeypatch.setattr(tloop, "_graphs_on", lambda device: True)
    graphed = runs()
    for key, audio in eager.items():
        np.testing.assert_array_equal(graphed[key], audio, err_msg=key)
    # one, two mesh threads, one stream, one hit: each its own capture
    assert len(made) == 5 and all(g.closed for g in made)
    stream = made[3]
    assert stream.replays == 40 - 1  # blocks of 16, 16 and 8 frames, one graph
