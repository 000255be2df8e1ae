"""Tensor-parallel decoding in its device-side form (the PyTorch port), on
the CPU: the tp group's all-reduce rule, the dispatch of a device tensor
to the hand-written all-reduce (csrc/tp_all_reduce.cu, its library stood
in), and the tp 2 greedy, segmented and beam decodes through the CUDA
graph dispatch, each rank capturing and replaying its own step (the graph
stood in by `RunningGraph`), against the JAX package's decodes on the
unsharded tree.

On the card every rank's step is captured and replayed, its all-reduces
launches of the device kernel; here the same steps run in the ranks'
threads, their all-reduces the host form, which computes the same
rank-ordered fold. Inputs are made from numpy seeds and given to both
packages; ranks run on `["cpu"] * n`.
"""

import ctypes
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode_graph import fake_cuda  # noqa: F401  (the CUDA calls of _build.launch stood in)
from test_torch_search_graph import RunningGraph
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from whisperkit_tpu.decoding import beam as jbeam
from whisperkit_tpu.decoding import loop as jloop
from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.text import tokenizer as jtok
from whisperkit_tpu_torch.decoding import beam, graph, loop
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.ops import _build
from whisperkit_tpu_torch.parallel import group as pgroup
from whisperkit_tpu_torch.parallel import mesh, sharding
from whisperkit_tpu_torch.text.tokenizer import special_tokens_for_vocab

V = 207
SP = special_tokens_for_vocab(V, whitespace_id=5)
JSP = jtok.special_tokens_for_vocab(V, whitespace_id=5)
DIMS = model.WhisperDims(80, V, 1500, 64, 4, 2, 64, 64, 4, 2)
JDIMS = jmodel.WhisperDims(*dataclasses.astuple(DIMS))
HEADS = ((0, 1), (1, 2))  # head 1 on rank 0, head 2 on rank 1
SAMPLE_BEGIN = 3
ROWS = 8
PROMPTS = [[SP.sot, SP.language_begin + i, SP.transcribe] for i in range(ROWS)]
# a positive EOT bias makes the greedy rows finish at scattered steps
EOT_BIAS = np.zeros(V, np.float32)
EOT_BIAS[SP.eot] = 2.0
LOOP_KW = dict(sample_begin=SAMPLE_BEGIN, max_new_tokens=40, top_k=5, sot_index=0, use_timestamp_rules=True,
               suppress_blank=True)
CUDA0 = torch.device("cuda", 0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


# ---------------------------------------------------------------------------
# (1) the all-reduce's rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64], ids=["bf16", "f32", "f64"])
def test_rank_ordered_fold_is_the_eager_rule_bit_for_bit(dtype, tp):
    """`plain_all_reduce` is torch.add (torch.maximum) folded in rank order,
    each step rounded to the type, bit for bit, and every rank of a group
    holds it after all_reduce_sum (all_reduce_max for float32); rank r's
    values are scaled by 4^r, so that from three ranks on the order of
    the rounded adds changes the result, which the check must see."""
    rng = np.random.default_rng(10 * tp + dtype.itemsize)
    xs = [torch.from_numpy(rng.standard_normal((3, 257)).astype(np.float32) * 4.0**r).to(dtype) for r in range(tp)]
    rule = xs[0]
    for y in xs[1:]:
        rule = torch.add(rule, y)
    fold = pgroup.plain_all_reduce(xs, "sum")
    assert fold.dtype == dtype and torch.equal(_bits(fold), _bits(rule))
    if tp > 2 and dtype != torch.float64:
        assert not torch.equal(_bits(pgroup.plain_all_reduce(xs[::-1], "sum")), _bits(fold))
    plan = mesh.make_mesh(dp=1, tp=tp, devices=["cpu"] * tp, timeout=30.0)
    ops = ["sum", "max"] if dtype == torch.float32 else ["sum"]
    outs = plan.run(lambda g, r: [getattr(plan.rank(g, r), f"all_reduce_{op}")(xs[r]) for op in ops])[0]
    maxed = xs[0]
    for y in xs[1:]:
        maxed = torch.maximum(maxed, y)
    for per_rank in outs:
        assert torch.equal(_bits(per_rank[0]), _bits(rule))
        if len(ops) == 2:
            assert torch.equal(_bits(per_rank[1]), _bits(maxed))
    assert plan.groups[0].host_waits == 3 * tp * len(ops)  # the host form: three barrier waits a call


# ---------------------------------------------------------------------------
# (2) a device tensor's all-reduce: the kernel's launches, the rendezvous of
# ranks that share a device, the failure words
# ---------------------------------------------------------------------------


class _State:
    """A stand-in for the group's device state: CPU buffers, host words."""

    def __init__(self, size: int, slot_bytes: int):
        self.slot_bytes = slot_bytes
        self.ctrl = [torch.zeros(2, dtype=torch.int64) for _ in range(size)]
        self.stages = (ctypes.c_longlong * size)(*range(1000, 1000 + size))
        self.inboxes = (ctypes.c_longlong * size)(*range(2000, 2000 + size))
        self.host = (ctypes.c_int32 * (1 + pgroup.MAX_RANKS))()
        self.host_dev = ctypes.c_void_p(3000)

    def failed(self) -> int:
        return next((w for w in self.host if w), 0)

    def clear(self) -> None:
        for i in range(len(self.host)):
            self.host[i] = 0


def test_device_all_reduce_launches_per_slot_and_raises(monkeypatch, fake_cuda):  # noqa: F811
    """A device call launches the kernel once per staging slot's worth of
    the tensor (offsets, counts, type and op codes, its rank and the
    group's buffers), counted per launch; ranks that share a device meet
    once at the host barrier before an eager call and never while a graph
    is captured; an unsupported type raises, and so does every call and
    `check` once the device state reports a failure, until `reset`."""
    calls = []

    class Lib:
        def wk_tp_all_reduce(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *_: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    group = pgroup.TPGroup(["cpu", "cpu"], timeout=20.0)
    group._state = state = _State(2, 64)  # 64-byte staging slots
    xs = [torch.arange(40, dtype=torch.float32) + 100 * r for r in range(2)]
    outs = mesh.run_threads([lambda r=r: group._device_reduce(r, xs[r], "sum") for r in range(2)], group.abort)
    assert [o.shape for o in outs] == [(40,), (40,)] and len(calls) == 6
    assert _build.launches["tp_all_reduce"] == 6 and group.host_waits == 2
    for r in range(2):
        mine = [c for c in calls if c[3] == r]
        assert [c[8] for c in mine] == [16, 16, 8]  # 64-byte slots of float32
        assert [c[6].value - xs[r].data_ptr() for c in mine] == [0, 64, 128]
        assert [c[7].value - outs[r].data_ptr() for c in mine] == [0, 64, 128]
        for c in mine:
            assert c[0] is state.stages and c[1] is state.inboxes and c[2] == 2
            assert c[4].value == state.ctrl[r].data_ptr() and c[5] is state.host_dev
            assert c[9:13] == (1, 0, 64, 20_000_000_000)  # float32, sum, slot bytes, timeout ns
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    group._device_reduce(0, xs[0][:16], "max")  # recorded by a capture: no rendezvous
    assert group.host_waits == 2 and calls[-1][10] == 1
    with pytest.raises(TypeError, match="all_reduce_max"):
        group._device_reduce(0, xs[0].to(torch.bfloat16), "max")
    with pytest.raises(TypeError, match="all_reduce_sum"):
        group._device_reduce(0, xs[0].to(torch.int32), "sum")
    state.host[2] = 1  # rank 1's kernel timed out
    with pytest.raises(pgroup.GroupAborted, match="rank 1: a peer did not arrive"):
        group._device_reduce(0, xs[0], "sum")
    with pytest.raises(pgroup.GroupAborted):
        group.rank(0).check()
    group.reset()
    assert not state.failed()
    group.rank(0).check()


def test_a_mesh_of_distinct_devices_needs_no_rendezvous():
    """Only ranks that share a device meet on the host before an eager
    launch; the group's abort sets the device state's abort word."""
    assert not pgroup.TPGroup(["cuda:0", "cuda:1"])._rendezvous
    assert pgroup.TPGroup(["cuda:0", "cuda:0"])._rendezvous
    group = pgroup.TPGroup(["cpu", "cpu"])
    group._state = _State(2, 64)
    group.abort()
    assert group._state.host[0] == 1
    with pytest.raises(pgroup.GroupAborted, match="the group was aborted"):
        group.check()


# ---------------------------------------------------------------------------
# (3) the tp 2 decodes through the graph dispatch against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(jax.random.PRNGKey(0), JDIMS, dtype=jnp.float32)


@pytest.fixture(scope="module")
def tp_setup(jparams):
    """The tp 2 plan and its rank trees, and the raw cross-KV of ROWS rows
    of random encoder output (row r scaled so that the rows finish at
    different steps) from JAX's projections: whole for JAX, each rank's
    heads for the port."""
    tparams = model.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    plan = mesh.make_mesh(dp=1, tp=2, devices=["cpu"] * 2, timeout=60.0)
    trees = sharding.shard_whisper_params(plan, tparams)[0]
    scales = np.linspace(0.1, 3.0, ROWS, dtype=np.float32)[:, None, None]
    enc = jnp.asarray(np.random.default_rng(4).standard_normal((ROWS, 1500, 64)).astype(np.float32) * scales)
    jkv = jmodel.compute_cross_kv(jparams, enc, JDIMS)
    kv = [_t(np.asarray(x)) for x in jkv]
    per = DIMS.n_text_head // 2
    rank_kv = [tuple(x[:, :, r * per : (r + 1) * per].contiguous() for x in kv) for r in range(2)]
    return {"plan": plan, "trees": trees, "jkv": jkv, "rank_kv": rank_kv}


@pytest.fixture(scope="module")
def jax_greedy(jparams, tp_setup):
    scalars = jloop.DecodeScalars(jnp.float32(0.0), jnp.int32(1500), jnp.float32(float("-inf")),
                                  jax.random.PRNGKey(0))
    return jloop.decode_loop(jparams, *tp_setup["jkv"], jnp.asarray(PROMPTS, jnp.int32), jnp.asarray(EOT_BIAS),
                             scalars, dims=JDIMS, special=JSP, alignment_heads=HEADS, **LOOP_KW)


class RankGraph(RunningGraph):
    """RunningGraph that remembers the thread that made it."""

    def __init__(self, step, device):
        self.thread = threading.get_ident()
        super().__init__(step, device)


@pytest.fixture
def tp_graphs(monkeypatch, fake_cuda):  # noqa: F811
    """The loop's and beam search's steps on the CPU as RankGraphs, and
    every all_reduce_sum counting a launch of the device kernel on cuda:0
    (its CUDA calls stood in) before the host form; → the graphs made."""
    made = []
    monkeypatch.setattr(RunningGraph, "made", made, raising=False)
    for module in (loop, beam):
        monkeypatch.setattr(module, "StepGraph", RankGraph)
        monkeypatch.setattr(module, "_graphs_on", lambda device: True)
    reduce_sum = pgroup.TPRank.all_reduce_sum

    def counted(self, x):
        _build.launch(pgroup.KERNEL, "wk_tp_all_reduce", CUDA0)
        return reduce_sum(self, x)

    monkeypatch.setattr(pgroup.TPRank, "all_reduce_sum", counted)
    return made


def _on_ranks(setup, fn):
    """fn(rank tree, rank cross-KV) on each rank's thread → (outputs, the
    threads' ranks)."""
    plan, threads = setup["plan"], {}

    def rank(g, r):
        threads[threading.get_ident()] = r
        with torch.inference_mode():
            return fn(setup["trees"][r], setup["rank_kv"][r])

    return plan.run(rank)[0], threads


def _per_rank(made, threads) -> dict:
    out = {}
    for gr in made:
        per = out.setdefault(threads[gr.thread], {"captures": 0, "replays": 0})
        per["captures"] += 1
        per["replays"] += gr.replays
    return out


def _hold_greedy(outs, ref):
    ref_tokens = np.asarray(ref.tokens)
    finish = (ref_tokens[:, SAMPLE_BEGIN:] != SP.eot).sum(1)
    assert len(set(finish.tolist())) > 2, finish
    for out in outs:
        np.testing.assert_array_equal(out.tokens.numpy(), ref_tokens)
        assert out.length == int(ref.length)
        # float32: the ranks' partial sums add in another order than one product
        np.testing.assert_allclose(out.token_logprobs.numpy(), np.asarray(ref.token_logprobs), rtol=1e-4, atol=1e-4)
        for r in range(ROWS):
            n = SAMPLE_BEGIN + int(finish[r]) + 1
            np.testing.assert_allclose(out.alignment[:n, r].numpy(), np.asarray(ref.alignment)[:n, r],
                                       rtol=0, atol=1e-5)
    for a, b in zip(outs[0], outs[1]):  # the ranks' outputs are the same bits
        assert (a == b) if not isinstance(a, torch.Tensor) else torch.equal(a, b)


def test_tp_greedy_on_the_graph_dispatch_matches_jax(tp_setup, jax_greedy, tp_graphs):
    """tp 2, greedy, timestamp rules, alignment heads on both ranks: each
    rank captures its step once and replays it for every later step (the
    host reads `done` every 16 steps), every replay launching the step's
    all-reduces (6 a step: 3 a layer); tokens and `length` are JAX's, the
    log-probs within 1e-4 and the gathered alignment within 1e-5."""
    _build.reset_launches()
    graph.reset_stats()
    outs, threads = _on_ranks(tp_setup, lambda tree, kv: loop.decode_loop(
        tree, *kv, torch.tensor(PROMPTS), _t(EOT_BIAS), loop.DecodeScalars(0.0, 1500, float("-inf")), dims=DIMS,
        special=SP, alignment_heads=HEADS, **LOOP_KW))
    _hold_greedy(outs, jax_greedy)
    ran = min(-(-(int(jax_greedy.length) - SAMPLE_BEGIN) // 16) * 16, LOOP_KW["max_new_tokens"])
    assert _per_rank(tp_graphs, threads) == {r: {"captures": 1, "replays": ran - 1} for r in range(2)}
    assert all(g.closed for g in tp_graphs)
    # per rank: the prefill's 6, a step's 6 per step, the gathered alignment
    assert _build.launches["tp_all_reduce"] == 2 * (6 + 6 * ran + 1)


def test_tp_segmented_decode_captures_anew_on_each_rank(tp_setup, jax_greedy, tp_graphs, monkeypatch):
    """Segmented decode with compaction at tp 2: both ranks compact alike,
    release their graph and capture anew after each compaction; tokens
    and `length` are JAX's."""
    compactions = []
    compact = loop._compact
    monkeypatch.setattr(loop, "_compact", lambda st, rows, n: (compactions.append(threading.get_ident()),
                                                               compact(st, rows, n))[1])
    outs, threads = _on_ranks(tp_setup, lambda tree, kv: loop.decode_loop_segmented(
        tree, *kv, torch.tensor(PROMPTS), _t(EOT_BIAS), loop.DecodeScalars(0.0, 1500, float("-inf")), dims=DIMS,
        special=SP, alignment_heads=HEADS, segment_tokens=8, compact=True, **LOOP_KW))
    _hold_greedy(outs, jax_greedy)
    per = _per_rank(tp_graphs, threads)
    n = {r: sum(threads[t] == r for t in compactions) for r in range(2)}
    assert n[0] == n[1] >= 1, n
    assert all(per[r]["captures"] == n[r] + 1 and per[r]["replays"] > 0 for r in range(2)), per


def test_tp_beam_on_the_graph_dispatch_matches_jax(jparams, tp_setup, tp_graphs):
    """Beam 5 at tp 2 on two windows: each rank captures one graph per
    parity of the position and replays them; tokens and `length` are
    JAX's beam search's on the unsharded tree, the log-probs and sums
    within 1e-4; the ranks agree bit for bit."""
    kw = dict(sample_begin=2, max_new_tokens=24, sot_index=0, use_timestamp_rules=True, suppress_blank=False)
    prompt = [SP.sot, SP.transcribe]
    bias = np.zeros(V, np.float32)
    bias[SP.eot] = 2.5
    jkv = [x[:, :2] for x in tp_setup["jkv"]]
    ref = jbeam.beam_decode_loop(jparams, *jkv, jnp.asarray([prompt] * 2, jnp.int32), jnp.asarray(bias),
                                 jnp.int32(50), dims=JDIMS, special=JSP, beam_size=5, **kw)
    outs, threads = _on_ranks(tp_setup, lambda tree, kv: beam.beam_decode_loop(
        tree, *(x[:, :2] for x in kv), torch.tensor([prompt] * 2), _t(bias), 50, dims=DIMS, special=SP,
        beam_size=5, **kw))
    for out in outs:
        np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
        assert out.length == int(ref.length)
        np.testing.assert_allclose(out.token_logprobs.numpy(), np.asarray(ref.token_logprobs), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out.sum_logprob.numpy(), np.asarray(ref.sum_logprob), rtol=1e-4, atol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(outs[0][:3], outs[1][:3]))
    per = _per_rank(tp_graphs, threads)
    assert all(per[r]["captures"] == 2 and per[r]["replays"] > 0 for r in range(2)), per
