"""Beam search and speculative decoding in their device-side form (the
PyTorch port), on the CPU: the beam step and the speculative round at a
0-d tensor position, looped eagerly, against the JAX package's
`lax.while_loop`s; their buffers in place and no host read inside a step
or round; and their CUDA graphs' captures, replays and launch counts, with
the graph and the CUDA calls stood in.

On the card the step (one graph per parity of the position) and the round
are captured as CUDA graphs and replayed; here the same `_step` and
`_round` run eagerly, so these tests hold the bodies the card captures.
Inputs are made from numpy seeds and given to both packages.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode_graph import fake_cuda  # noqa: F401  (the CUDA calls of _build.launch stood in)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from whisperkit_tpu.decoding import beam as jbeam
from whisperkit_tpu.decoding import loop as jloop
from whisperkit_tpu.decoding import speculative as jspec
from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.text import tokenizer as jtok
from whisperkit_tpu_torch.core.configurations import DecodingOptions, WhisperConfig
from whisperkit_tpu_torch.decoding import beam, graph, loop, speculative
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.ops import _build
from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
from whisperkit_tpu_torch.text.tokenizer import special_tokens_for_vocab

V = 207
SP = special_tokens_for_vocab(V)
JSP = jtok.special_tokens_for_vocab(V)
DIMS = model.WhisperDims(80, V, 1500, 64, 4, 2, 64, 64, 4, 2)
DRAFT_DIMS = model.WhisperDims(80, V, 1500, 32, 4, 1, 64, 32, 4, 1)
JDIMS = jmodel.WhisperDims(*dataclasses.astuple(DIMS))
JDRAFT_DIMS = jmodel.WhisperDims(*dataclasses.astuple(DRAFT_DIMS))
PROMPT = [SP.sot, SP.transcribe]
CUDA0 = torch.device("cuda", 0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(tree):
    return model.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu", torch.float32)


@pytest.fixture(scope="module")
def trees():
    """float32 target and independent draft in both packages, the raw
    cross-KV of two random windows (beam search), and of the first window
    raw and int8 for the target and raw for the draft (speculative)."""
    target = jmodel.init_params(jax.random.PRNGKey(0), JDIMS, jnp.float32)
    draft = jmodel.init_params(jax.random.PRNGKey(7), JDRAFT_DIMS, jnp.float32)
    mel = jnp.asarray((np.random.default_rng(1).standard_normal((2, 80, 3000)) * 0.5).astype(np.float32))
    enc = jmodel.encoder_forward(target, mel, JDIMS)
    denc = jmodel.encoder_forward(draft, mel[:1], JDRAFT_DIMS)
    raw = jmodel.compute_cross_kv(target, enc, JDIMS)
    q8 = jmodel.compute_cross_kv_quantized(target, enc[:1], JDIMS)
    draft_kv = jmodel.compute_cross_kv(draft, denc, JDRAFT_DIMS)
    one = tuple(x[:, :1] for x in raw)
    return {
        "jax": {"target": target, "draft": draft, "beam_kv": raw, "kv": one, "draft_kv": draft_kv},
        "port": {
            "target": _port(target), "draft": _port(draft), "beam_kv": tuple(_t(x) for x in raw),
            "kv": tuple(_t(x) for x in one), "q8": tuple({k: _t(v) for k, v in d.items()} for d in q8),
            "draft_kv": tuple(_t(x) for x in draft_kv),
        },
    }


class RunningGraph:
    """StepGraph on the CPU: runs the step where the real one runs it (the
    warm-up, at construction) and at each replay, with the real one's
    accounting: the construction's launches are recorded, as a capture
    records them, and counted once, as the warm-up counts them; each
    replay runs the step, checks that it launches what the record holds,
    and counts the record (`_build.add_launches`)."""

    def __init__(self, step, device):
        self.step, self.device, self.replays, self.closed = step, torch.device(device), 0, False
        with _build.recording() as self.record:
            step()
        _build.add_launches(self.record)
        graph._add(self.device, captures=1)
        self.made.append(self)

    def replay(self):
        with _build.recording() as record:
            self.step()
        assert record == self.record
        _build.add_launches(self.record)
        graph._add(self.device, replays=1)
        self.replays += 1

    def close(self):
        self.closed = True


@pytest.fixture
def graphs(monkeypatch, fake_cuda):  # noqa: F811
    """Beam steps and speculative rounds on the CPU run as RunningGraphs,
    and K3 and K4 count a launch on cuda:0 per call (through
    `_build.launch`, its CUDA calls stood in) before their plain version;
    → the graphs made, in order."""
    made = []
    monkeypatch.setattr(RunningGraph, "made", made, raising=False)
    for module in (beam, speculative):
        monkeypatch.setattr(module, "StepGraph", RunningGraph)
        monkeypatch.setattr(module, "_graphs_on", lambda device: True)
    for name, fn in (("self_attend", model.self_attend), ("cross_attend_q8", model.cross_attend_q8)):
        def counted(*args, _name=name, _fn=fn, **kwargs):
            _build.launch(_name, f"wk_{_name}", CUDA0)
            return _fn(*args, **kwargs)

        monkeypatch.setattr(model, name, counted)
    return made


@contextlib.contextmanager
def no_host_reads():
    """Tensor.__bool__, __int__, __float__, .item() and .tolist() raise
    inside the block: a step or round that reads a device value on the
    host would sync."""
    saved = {name: getattr(torch.Tensor, name) for name in ("__bool__", "__int__", "__float__", "item", "tolist")}

    def refuse(self, *args, **kwargs):
        raise AssertionError("a host read of a device value")

    for name in saved:
        setattr(torch.Tensor, name, refuse)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def _pointers(st) -> dict:
    """The data_ptr of every tensor field of a state (and of tuples of them)."""
    out = {}
    for f in dataclasses.fields(st):
        value = getattr(st, f.name)
        for i, t in enumerate(value if isinstance(value, tuple) else (value,)):
            if isinstance(t, torch.Tensor):
                out[f"{f.name}{i}"] = t.data_ptr()
    return out


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------


BEAM_KW = dict(sample_begin=2, max_new_tokens=30, sot_index=0)


def _beam_jax(trees, k, suppress, **kw):
    j = trees["jax"]
    return jbeam.beam_decode_loop(
        j["target"], *j["beam_kv"], jnp.asarray([PROMPT, PROMPT], jnp.int32), jnp.asarray(suppress),
        jnp.int32(50), dims=JDIMS, special=JSP, beam_size=k, **{**BEAM_KW, **kw},
    )


def _beam_port(trees, k, suppress, **kw):
    t = trees["port"]
    return beam.beam_decode_loop(
        t["target"], *t["beam_kv"], torch.tensor([PROMPT, PROMPT]), _t(suppress), 50, dims=DIMS, special=SP,
        beam_size=k, **{**BEAM_KW, **kw},
    )


def _bias(eot_bias):
    suppress = np.zeros(V, np.float32)
    suppress[SP.eot] = eot_bias
    return suppress


@pytest.mark.parametrize("interval", [1, 16])
@pytest.mark.parametrize("rules", [True, False], ids=["rules", "no_rules"])
@pytest.mark.parametrize("eot_bias", [0.0, 2.5])
@pytest.mark.parametrize("length_penalty", [None, 0.6])
@pytest.mark.parametrize("k", [2, 5])
def test_beam_step_loop_matches_jax(trees, k, length_penalty, eot_bias, rules, interval):
    """The beam step at a device position, looped eagerly, against JAX's
    beam_decode_loop: tokens and `length` equal (with an EOT bias the
    windows finish early, before the budget, so `length` is the stop's),
    log-probs, sums and no_speech_prob within 1e-4."""
    kw = dict(use_timestamp_rules=rules, suppress_blank=not rules, length_penalty=length_penalty)
    ref = _beam_jax(trees, k, _bias(eot_bias), **kw)
    out = _beam_port(trees, k, _bias(eot_bias), stop_check_interval=interval, cuda_graph=False, **kw)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    assert out.length == int(ref.length)
    np.testing.assert_allclose(out.token_logprobs.numpy(), np.asarray(ref.token_logprobs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.sum_logprob.numpy(), np.asarray(ref.sum_logprob), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob), rtol=1e-4, atol=1e-6)
    if eot_bias:  # every window finished before the budget: `length` is the stop's
        assert out.length < 2 + BEAM_KW["max_new_tokens"]


def _beam_state(trees, k=3, eot_bias=2.5):
    t = trees["port"]
    st, _ = beam._start(
        t["target"], *t["beam_kv"], torch.tensor([PROMPT, PROMPT]), _t(_bias(eot_bias)), 50, dims=DIMS, special=SP,
        beam_size=k, use_timestamp_rules=True, suppress_blank=False, length_penalty=None, cuda_graph=False,
        **BEAM_KW,
    )
    return st


@torch.inference_mode()
def test_beam_step_writes_in_place_without_host_reads(trees):
    """Steps of both parities, with and without the decoder, keep every
    state tensor at its address and read nothing on the host (what a CUDA
    graph of the step needs); the position advances on the device."""
    st = _beam_state(trees)
    ptrs = _pointers(st)
    assert {"kv_k0", "kv_k1", "tokens0", "fin_tokens0", "fin_len0", "done0", "last_logits0", "mask_row0",
            "pos_dev0", "length0", "beam_lp0"} <= set(ptrs)
    with no_host_reads():
        for i in range(5):
            beam._step(st, forward=i < 4, parity=i % 2)
    assert _pointers(st) == ptrs
    assert int(st.pos_dev) == 2 + 5
    assert (st.mask_row[0, : 2 + 4] == 0).all() and torch.isneginf(st.mask_row[0, 2 + 4 :]).all()


@pytest.mark.parametrize("max_new", [6, 30])
def test_beam_graphs_capture_per_parity_and_count_launches(trees, graphs, max_new):
    """With the graphs on: one capture per parity, a replay for every later
    step with a decoder, the graphs closed; tokens, log-probs, sums and
    `length` equal to the eager loop's, and K4's launches too, counted
    through the replays."""
    kw = dict(use_timestamp_rules=True, suppress_blank=False, max_new_tokens=max_new)
    runs = {}
    for cuda_graph in (False, True):
        _build.reset_launches()
        graph.reset_stats()
        runs[cuda_graph] = (_beam_port(trees, 3, _bias(2.5), cuda_graph=cuda_graph, **kw),
                            dict(_build.launches))
    (eager, eager_launches), (graphed, graph_launches) = runs[False], runs[True]
    assert len(graphs) == 2 and all(g.closed for g in graphs)
    # the host stops at the first check (every 16 steps) after the stop;
    # the budget's last step runs no decoder
    ran = min(-(-(graphed.length - 2) // 16) * 16, max_new)
    steps = ran - (ran == max_new)  # steps with a decoder
    assert sum(g.replays for g in graphs) == steps - 2
    (stats,) = graph.stats_by_device.values()
    assert stats["captures"] == 2 and stats["replays"] == steps - 2
    for a, b in zip(eager[:3], graphed[:3]):
        assert torch.equal(a, b)
    assert eager.length == graphed.length
    assert graph_launches == eager_launches and eager_launches["self_attend"] > 0
    assert eager_launches["self_attend"] % DIMS.n_text_layer == 0


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------


def _scalars(first_threshold=float("-inf")):
    return loop.DecodeScalars(0.0, 50, first_threshold)


def _spec_port(trees, kind, k, suppress, max_new, first_threshold=float("-inf"), rules=True, cross="kv", **kw):
    t = trees["port"]
    draft, dkv, ddims = (t["draft"], t["draft_kv"], DRAFT_DIMS) if kind == "independent" else (
        t["target"], t["kv"], DIMS)
    return speculative.speculative_decode_loop(
        t["target"], draft, *t[cross], *dkv, torch.tensor([PROMPT]), _t(suppress), _scalars(first_threshold),
        dims=DIMS, draft_dims=ddims, special=SP, sample_begin=2, max_new_tokens=max_new, draft_k=k,
        use_timestamp_rules=rules, **kw,
    )


def _spec_jax(trees, kind, k, suppress, max_new, first_threshold=float("-inf"), rules=True):
    j = trees["jax"]
    draft, dkv, ddims = (j["draft"], j["draft_kv"], JDRAFT_DIMS) if kind == "independent" else (
        j["target"], j["kv"], JDIMS)
    scalars = jloop.DecodeScalars(jnp.float32(0.0), jnp.int32(50), jnp.float32(first_threshold),
                                  jax.random.PRNGKey(0))
    return jspec.speculative_decode_loop(
        j["target"], draft, *j["kv"], *dkv, jnp.asarray([PROMPT], jnp.int32), jnp.asarray(suppress), scalars,
        dims=JDIMS, draft_dims=ddims, special=JSP, sample_begin=2, max_new_tokens=max_new, draft_k=k,
        use_timestamp_rules=rules,
    )


def _greedy_port(trees, suppress, max_new, first_threshold=float("-inf"), rules=True):
    t = trees["port"]
    return loop.decode_loop(
        t["target"], *t["kv"], torch.tensor([PROMPT]), _t(suppress), _scalars(first_threshold), dims=DIMS,
        special=SP, sample_begin=2, max_new_tokens=max_new, top_k=5, sot_index=0, use_timestamp_rules=rules,
        suppress_blank=False,
    )


def _assert_same(out, ref, greedy):
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.tokens.numpy(), greedy.tokens.numpy())
    assert out.length == int(ref.length) == greedy.length
    np.testing.assert_allclose(out.token_logprobs.numpy(), np.asarray(ref.token_logprobs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.token_logprobs.numpy(), greedy.token_logprobs.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stop", ["budget", "eot"])
@pytest.mark.parametrize("interval", [1, 4])
@pytest.mark.parametrize("draft_k", [1, 4])
@pytest.mark.parametrize("kind", ["independent", "self"])
def test_speculative_round_loop_matches_jax_and_greedy(trees, kind, draft_k, interval, stop):
    """The round at a device position, looped eagerly, against JAX's
    speculative loop and the greedy loop: tokens, log-probs and `length`,
    with the timestamp rules to the budget, or without them and with an
    EOT bias that stops the window at its tenth token."""
    suppress, rules = (_bias(0.0), True) if stop == "budget" else (_bias(2.7), False)
    out = _spec_port(trees, kind, draft_k, suppress, 24, rules=rules, stop_check_interval=interval, cuda_graph=False)
    _assert_same(out, _spec_jax(trees, kind, draft_k, suppress, 24, rules=rules),
                 _greedy_port(trees, suppress, 24, rules=rules))
    assert (out.length == 2 + 24) == (stop == "budget")


@pytest.mark.parametrize("case", ["first_token_floor", "eot_stop", "budget"])
def test_self_draft_accepts_every_draft(trees, case):
    """The target as its own draft: every round accepts its k drafts and
    commits k + 1 tokens, but the last; the first-token floor stops at
    once, an EOT bias stops mid-window, no bias runs to the budget; the
    same tokens, log-probs and `length` as JAX's loop and the greedy loop,
    and the draft cache equal to the target's at the committed positions."""
    k = 3
    threshold = 1e9 if case == "first_token_floor" else float("-inf")
    suppress = _bias(2.7 if case == "eot_stop" else 0.0)
    max_new = 16
    out, st = _spec_port(trees, "self", k, suppress, max_new, threshold, rules=False, return_state=True,
                         stop_check_interval=3)
    _assert_same(out, _spec_jax(trees, "self", k, suppress, max_new, threshold, rules=False),
                 _greedy_port(trees, suppress, max_new, threshold, rules=False))
    committed = out.length - 2
    assert st.pos == out.length and st.rounds == -(-committed // (k + 1))
    if case == "first_token_floor":
        assert committed == 1 and (out.tokens[0, 2:] == SP.eot).all()
    elif case == "eot_stop":
        assert 2 + 4 < out.length < 2 + max_new
    else:
        assert out.length == 2 + max_new
    for t_cache, d_cache in ((st.kv_t_k, st.kv_d_k), (st.kv_t_v, st.kv_d_v)):
        torch.testing.assert_close(d_cache[:, :, :, : st.pos - 1], t_cache[:, :, :, : st.pos - 1], rtol=1e-4,
                                   atol=1e-4)


@torch.inference_mode()
def test_speculative_round_writes_in_place_without_host_reads(trees):
    """Rounds, including ones after the stop, keep every state tensor at
    its address and read nothing on the host; a round after the stop
    commits nothing."""
    t = trees["port"]
    headroom = dict(special=SP, sample_begin=2, max_new_tokens=6 + 2 + 1, sot_index=0)
    prompt = torch.tensor([PROMPT])
    pre = loop.prefill_window(t["target"], *t["kv"], prompt, dims=DIMS, **headroom)
    dpre = loop.prefill_window(t["draft"], *t["draft_kv"], prompt, dims=DRAFT_DIMS, **headroom)
    width = 2 + 6 + 2 + 1
    tokens = torch.full((1, width), SP.eot)
    tokens[:, :2] = prompt
    st = speculative._Spec(
        t["target"], t["draft"], *t["kv"], *t["draft_kv"], torch.zeros(V), _scalars(), DIMS, DRAFT_DIMS, SP, 2,
        2 + 6, 2, False, False, pre.kv_k, pre.kv_v, dpre.kv_k, dpre.kv_v, tokens, torch.zeros((1, width)),
        torch.tensor(2), prompt[:, -1].clone(), torch.zeros(1, dtype=torch.bool), torch.tensor(0),
    )
    ptrs = _pointers(st)
    with no_host_reads():
        for _ in range(8):  # six tokens take at most six rounds
            speculative._round(st)
    assert _pointers(st) == ptrs
    assert int(st.pos) == 2 + 6 and 3 <= int(st.rounds) <= 6
    before = (st.tokens.clone(), st.token_logprobs.clone(), st.last_token.clone())
    speculative._round(st)
    assert int(st.pos) == 2 + 6
    for a, b in zip(before, (st.tokens, st.token_logprobs, st.last_token)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["independent", "self"])
def test_speculative_graph_captures_once_and_counts_launches(trees, graphs, kind):
    """With the graph on, over the target's int8 cross-KV (K3 in the verify
    pass): one capture, a replay for every later round, the graph closed;
    tokens, log-probs and `length` equal to the eager loop's, and K3's and
    K4's launches too, counted through the replays."""
    runs = {}
    for cuda_graph in (False, True):
        _build.reset_launches()
        graph.reset_stats()
        out, st = _spec_port(trees, kind, 3, _bias(1.5), 20, cross="q8", return_state=True, cuda_graph=cuda_graph,
                             stop_check_interval=2)
        runs[cuda_graph] = (out, st, dict(_build.launches))
    (eager, est, eager_launches), (graphed, gst, graph_launches) = runs[False], runs[True]
    (g,) = graphs
    rounds = graph_launches["cross_attend_q8"] // DIMS.n_text_layer - 1  # less the prefill's pass
    assert g.closed and g.replays == rounds - 1 and rounds >= gst.rounds
    (stats,) = graph.stats_by_device.values()
    assert stats["captures"] == 1 and stats["replays"] == rounds - 1
    assert torch.equal(eager.tokens, graphed.tokens) and torch.equal(eager.token_logprobs, graphed.token_logprobs)
    assert eager.length == graphed.length and est.rounds == gst.rounds
    assert graph_launches == eager_launches
    # the draft's K4: k + 1 T==1 steps a round on each of its layers
    draft_layers = DIMS.n_text_layer if kind == "self" else DRAFT_DIMS.n_text_layer
    assert eager_launches["self_attend"] == rounds * (3 + 1) * draft_layers


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def test_pipeline_runs_beam_and_speculative_on_the_graph(trees, graphs):
    """The pipeline's beam and speculative paths take the graph by default:
    with the graphs on, each decode captures (beam once per parity), and
    the segments equal the eager run's."""
    t = trees["port"]
    audio = (np.random.default_rng(5).standard_normal(16000 * 3) * 0.1).astype(np.float32)
    greedy = dict(language="en", temperature_fallback_count=0, logprob_threshold=None,
                  compression_ratio_threshold=None, no_speech_threshold=None, first_token_log_prob_threshold=None,
                  sample_length=8)
    pipes = {
        "beam": (WhisperPipeline(WhisperConfig(load=False), dims=DIMS, params=t["target"], device="cpu"),
                 DecodingOptions(**greedy, beam_size=2)),
        "speculative": (WhisperPipeline(WhisperConfig(load=False), dims=DIMS, params=t["target"],
                                        draft_dims=DRAFT_DIMS, draft_params=t["draft"], device="cpu"),
                        DecodingOptions(**greedy)),
    }
    for name, (pipe, options) in pipes.items():
        graphs.clear()
        graphed = pipe.transcribe(audio, options)
        assert len(graphs) == (2 if name == "beam" else 1), name
        with contextlib.ExitStack() as stack:
            mp = stack.enter_context(pytest.MonkeyPatch.context())
            mp.setattr(beam, "_graphs_on", lambda device: False)
            mp.setattr(speculative, "_graphs_on", lambda device: False)
            eager = pipe.transcribe(audio, options)
        assert [s.tokens for s in graphed.segments] == [s.tokens for s in eager.segments], name
