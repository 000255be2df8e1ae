"""The port's mesh (whisperkit_tpu_torch/parallel/) against the JAX
package's, on the CPU.

Each check mirrors a JAX test of the mesh: its shape, padding and
dcn-major row placement (test_parallel_dcn.py), the tensor-parallel roles
of every leaf against JAX's NamedSharding specs (test_core_components.py),
the sharded encoder, cross-KV and decoder against JAX's unsharded
functions on the same weights (carried across with `params_from_numpy`),
W8A8 under tp, `dcn_shard`, and the sequence-parallel encoder
(test_parallel_sp.py). Repeated CPU devices stand in for the JAX tests'
eight virtual devices: `["cpu"] * n` gives n ranks, each in a thread of
its own. Then the port-only parts: K2's plain version with fewer queries
than keys, the tp group's failure handling, and the launcher's device,
stream and counts with a stand-in kernel library.
"""

import dataclasses
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.ops import quant as jquant
from whisperkit_tpu.parallel import mesh as jmesh
from whisperkit_tpu.parallel import sharding as jsharding
from whisperkit_tpu_torch.decoding import loop
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.ops import _build, attention, quant
from whisperkit_tpu_torch.parallel import group as pgroup
from whisperkit_tpu_torch.parallel import mesh, sharding
from whisperkit_tpu_torch.text.tokenizer import special_tokens_for_vocab

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

DIMS = model.WhisperDims(80, 207, 1500, 64, 4, 2, 64, 64, 4, 2)
JDIMS = jmodel.WhisperDims(*dataclasses.astuple(DIMS))
SP = special_tokens_for_vocab(DIMS.n_vocab)
PROMPT = [SP.sot, SP.language_token("en"), SP.transcribe]
# float32 on both sides: a tp rank's partial sums, and the all-reduce of
# them, add in another order than one unsharded product
TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(jax.random.PRNGKey(0), JDIMS, dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return model.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(0).standard_normal((2, 80, 3000)).astype(np.float32)


def _tp2():
    return mesh.make_mesh(dp=1, tp=2, devices=["cpu"] * 2)


def _on_ranks(plan, fn):
    """fn(tree of the rank, rank) on every rank of cell 0 → the results."""
    return plan.run(fn)[0]


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_dcn_mesh_shape_padding_and_row_placement():
    plan = mesh.make_mesh(dp=2, tp=2, dcn=2, devices=["cpu"] * 8)
    assert (plan.dcn, plan.dp, plan.tp, plan.n_cells) == (2, 2, 2, 4)
    assert plan.pad_batch(5) == 8
    jplan = jmesh.make_mesh(dp=2, tp=2, dcn=2)
    assert jplan.pad_batch(5) == plan.pad_batch(5)
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    parts = mesh.shard_batch(plan, _t(x))
    # JAX's placement: the rows on the device at grid (dcn i, dp j, tp k)
    # are the port's cell i·dp + j, on its rank k
    for shard in jmesh.shard_batch(jplan, jnp.asarray(x)).addressable_shards:
        i, j, k = np.argwhere(jplan.mesh.devices == shard.device)[0]
        np.testing.assert_array_equal(parts[i * 2 + j][k].numpy(), np.asarray(shard.data))
    back = mesh.gather_rows([cell[0] for cell in parts], "cpu")
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError, match="does not split"):
        plan.row_slices(6)
    with pytest.raises(ValueError, match="need 16 devices"):
        mesh.make_mesh(dp=4, tp=2, dcn=2, devices=["cpu"] * 8)


def test_dcn_single_slice_plan_unchanged():
    plan = mesh.make_mesh(dp=4, tp=2, devices=["cpu"] * 8)
    assert plan.dcn == 1 and len(plan.cells()) == 4
    f = mesh.dcn_shard(plan, lambda sub, x: x + 1, batch_argnums=(0,))
    assert f(torch.ones(3)).tolist() == [2.0, 2.0, 2.0]


def test_resolve_devices_and_replicas():
    assert mesh.resolve_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert mesh.resolve_devices("cpu") == [torch.device("cpu")]
    plan = mesh.make_mesh(dp=2, devices=["cpu", "cpu"])
    tree = {"a": torch.ones(2), "b": [torch.zeros(3)]}
    tree["c"] = tree["a"]
    copies = mesh.shard_params_replicated(plan, tree)
    assert list(copies) == [torch.device("cpu")]  # one copy per distinct device
    assert copies[torch.device("cpu")]["c"] is copies[torch.device("cpu")]["a"]


def test_a_bare_cuda_is_one_card(monkeypatch):
    """On a host with four cards (stood in for), a bare "cuda" stays the
    current card, so a default pipeline never spreads over a mesh; a mesh
    over every card is make_mesh's default, or asked for by a list."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert mesh.resolve_devices("cuda") == [torch.device("cuda", 0)]
    assert mesh.resolve_devices(["cuda:2", "cuda:3"]) == [torch.device("cuda", 2), torch.device("cuda", 3)]
    plan = mesh.make_mesh()
    assert (plan.dcn, plan.dp, plan.tp) == (1, 4, 1)
    assert plan.distinct_devices() == [torch.device("cuda", i) for i in range(4)]


# ---------------------------------------------------------------------------
# tensor-parallel roles and shards
# ---------------------------------------------------------------------------


def _jax_tree(jparams, scheme):
    if scheme == "bf16":
        return jparams
    return jquant.quantize_whisper_params(jparams, min_size=1, bits=4 if scheme == "w4a16" else 8)


def _spec_role(spec, ndim) -> str:
    axes = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    if "tp" not in axes:
        return "rep"
    return "col" if axes.index("tp") == ndim - 1 else "row"


@pytest.mark.parametrize("scheme", ["bf16", "w8a16", "w4a16"])
def test_roles_mirror_jax_shardings(jparams, scheme):
    """Leaf by leaf, the port's role is JAX's spec: "tp" on the last axis
    means col, on the input axis row, none rep; every layer of a stack
    takes its stacked leaf's role."""
    jtree = _jax_tree(jparams, scheme)
    jspecs = jsharding.whisper_param_shardings(jmesh.make_mesh(dp=4, tp=2), jtree)
    ttree = model.params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu", torch.float32)
    roles = sharding.whisper_param_shardings(None, ttree)
    checked = {"col": 0, "row": 0, "rep": 0}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]:
        keys = [p.key for p in path]
        leaf = jtree
        for k in keys:
            leaf = leaf[k]
        want = _spec_role(spec.spec, leaf.ndim)
        # a layer stack ("blocks") is one list entry per layer in the port
        split = keys.index("blocks") + 1 if "blocks" in keys else len(keys)
        nodes = roles
        for k in keys[:split]:
            nodes = nodes[k]
        for node in (nodes if split < len(keys) or "blocks" in keys else [nodes]):
            for k in keys[split:]:
                node = node[k]
            assert node == want, (keys, node, want)
        checked[want] += 1
    assert checked["col"] and checked["row"] and checked["rep"]
    assert roles["decoder"]["token_embed_f32"] == "rep"


@pytest.mark.parametrize("scheme", ["bf16", "w8a16", "w4a16"])
def test_shards_put_back_together_give_the_weights(tparams, scheme):
    tree = tparams if scheme == "bf16" else quant.quantize_whisper_params(
        tparams, min_size=1, bits=4 if scheme == "w4a16" else 8)
    roles = sharding.whisper_param_shardings(None, tree)
    shards = [sharding.shard_rank(tree, r, 2) for r in range(2)]

    def check(node, role, parts):
        if isinstance(node, dict):
            if "w_q4" in node and role["w_q4"] == "row":  # packed again per shard: compare dequants
                full = quant.w4_dequant(node, torch.float32)
                got = torch.cat([quant.w4_dequant(p, torch.float32) for p in parts], 0)
                torch.testing.assert_close(got, full, rtol=0, atol=0)
                for r, p in enumerate(parts):
                    n = full.shape[0] // 2
                    assert torch.equal(quant.w4_dequant(p, torch.float32), full[r * n : (r + 1) * n])
                return
            for k in node:
                check(node[k], role[k], [p[k] for p in parts])
        elif isinstance(node, list):
            for i in range(len(node)):
                check(node[i], role[i], [p[i] for p in parts])
        elif role == "rep":
            assert all(p is node for p in parts)
        else:
            assert torch.equal(torch.cat(parts, -1 if role == "col" else 0), node)

    check(tree, roles, shards)
    if scheme == "w4a16":  # a column shard's dequant is the same columns of the full one
        lin = tree["encoder"]["blocks"][0]["fc1"]
        full = quant.w4_dequant(lin, torch.float32)
        part = quant.w4_dequant(shards[1]["encoder"]["blocks"][0]["fc1"], torch.float32)
        assert torch.equal(part, full[:, full.shape[1] // 2 :])


# ---------------------------------------------------------------------------
# the model under tp = 2 against JAX's unsharded functions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tp_trees(tparams):
    plan = _tp2()
    return plan, sharding.shard_whisper_params(plan, tparams)[0]


def test_tp_encoder_and_cross_kv_match_jax(jparams, tp_trees, mel):
    plan, trees = tp_trees
    jenc = jmodel.encoder_forward(jparams, jnp.asarray(mel), JDIMS)
    encs = _on_ranks(plan, lambda g, r: model.encoder_forward(trees[r], _t(mel), DIMS))
    for enc in encs:
        np.testing.assert_allclose(_np(enc), np.asarray(jenc), rtol=TOL, atol=TOL)
    assert torch.equal(encs[0], encs[1])  # the ranks hold bit-identical activations
    enc = encs[0]
    jk, jv = jmodel.compute_cross_kv(jparams, jenc, JDIMS)
    raw = _on_ranks(plan, lambda g, r: model.compute_cross_kv(trees[r], enc, DIMS))
    for got, ref in ((torch.cat([raw[0][0], raw[1][0]], 2), jk), (torch.cat([raw[0][1], raw[1][1]], 2), jv)):
        assert got.shape[2] == DIMS.n_text_head
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=TOL, atol=TOL)
    jk8, jv8 = jmodel.compute_cross_kv_quantized(jparams, jenc, JDIMS)
    q8 = _on_ranks(plan, lambda g, r: model.compute_cross_kv_quantized(trees[r], enc, DIMS))
    for i, ref in ((0, jk8), (1, jv8)):
        # per-(head, channel) scales over frames: a head split leaves them exact
        scale = torch.cat([q8[0][i]["scale"], q8[1][i]["scale"]], 2)
        np.testing.assert_allclose(_np(scale), np.asarray(ref["scale"]), rtol=TOL, atol=1e-7)
        codes = torch.cat([q8[0][i]["q8"], q8[1][i]["q8"]], 2).numpy().astype(np.int32)
        assert np.abs(codes - np.asarray(ref["q8"], np.int32)).max() <= 1


@pytest.mark.parametrize("kind", ["raw", "q8"])
def test_tp_decoder_prefill_and_step_match_jax(jparams, tparams, tp_trees, mel, kind):
    plan, trees = tp_trees
    jenc = jmodel.encoder_forward(jparams, jnp.asarray(mel), JDIMS)
    jcross = jmodel.compute_cross_kv(jparams, jenc, JDIMS) if kind == "raw" else \
        jmodel.compute_cross_kv_quantized(jparams, jenc, JDIMS)
    enc = _t(np.asarray(jenc))
    s = 16
    shape = (DIMS.n_text_layer, 2, DIMS.n_text_head, s, DIMS.head_dim)
    prompt = np.asarray([PROMPT, PROMPT], np.int64)
    step = np.asarray([[SP.timestamp_begin], [SP.timestamp_begin + 3]], np.int64)
    jl, jkv, _ = jmodel.decoder_forward(jparams, jnp.asarray(prompt, jnp.int32), 0,
                                        jnp.zeros(shape), jnp.zeros(shape), *jcross, JDIMS)
    jl1, _, _ = jmodel.decoder_forward(jparams, jnp.asarray(step, jnp.int32), 3, *jkv, *jcross, JDIMS)

    def rank(g, r):
        tree = trees[r]
        cross = model.compute_cross_kv(tree, enc, DIMS) if kind == "raw" else \
            model.compute_cross_kv_quantized(tree, enc, DIMS)
        kk, vv = model.init_kv_cache(DIMS, 2, s, torch.float32, "cpu",
                                     n_head=model.local_heads(tree, DIMS.n_text_head))
        assert kk.shape[2] == DIMS.n_text_head // 2
        l0 = model.decoder_forward(tree, _t(prompt), 0, kk, vv, *cross, DIMS)
        l1 = model.decoder_forward(tree, _t(step), 3, kk, vv, *cross, DIMS)
        return l0, l1

    # int8: a probability at a requantization boundary may round the other way
    tol = TOL if kind == "raw" else 2e-3
    outs = _on_ranks(plan, rank)
    for l0, l1 in outs:
        np.testing.assert_allclose(_np(l0), np.asarray(jl), rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(l1), np.asarray(jl1), rtol=tol, atol=tol)
    assert torch.equal(outs[0][1], outs[1][1])


def test_tp_decode_loop_with_alignment_matches_one_device(tparams, tp_trees, mel):
    """Greedy decode with alignment heads spread over both ranks (K3's
    probs form on the rank that holds each head): the tokens of one
    device, and its alignment buffer once the ranks' are summed."""
    plan, trees = tp_trees
    heads = ((0, 0), (1, 3), (1, 1), (0, 2))  # ranks 0, 1, 0, 1
    suppress = torch.zeros(DIMS.n_vocab)
    scalars = loop.DecodeScalars(0.0, 1500, float("-inf"))
    kw = dict(dims=DIMS, special=SP, sample_begin=3, max_new_tokens=8, top_k=5, sot_index=0,
              use_timestamp_rules=True, suppress_blank=True, alignment_heads=heads)
    prompt = torch.tensor([PROMPT, PROMPT])

    def run(tree):
        _, ck, cv = loop.encode_window(tree, _t(mel), DIMS, quantize_kv=True)
        pre = loop.prefill_window(tree, ck, cv, prompt, dims=DIMS, special=SP, sample_begin=3,
                                  max_new_tokens=8, sot_index=0, alignment_heads=heads)
        return loop.decode_loop(tree, ck, cv, prompt, suppress, scalars, prefill=pre, **kw)

    ref = run(tparams)
    for out in _on_ranks(plan, lambda g, r: run(trees[r])):
        assert torch.equal(out.tokens, ref.tokens)
        # the int8 cross-attention requantizes the query: a code that the
        # ranks' other summation order rounds the other way moves a
        # probability by ~1% of itself (2e-5 here)
        np.testing.assert_allclose(_np(out.alignment), _np(ref.alignment), rtol=0, atol=1e-4)
        assert float(out.alignment.abs().amax(dim=(0, 1, 3)).min()) > 0  # every head's slot written


def test_tp_w8a8_encoder_matches_unsharded():
    """JAX's test_tp_sharded_w8a8_encoder_matches_unsharded setting (JAX's
    bf16 weights quantized with min_size 1, carried across, 8 windows):
    the port at tp = 2 against the port unsharded, within that test's
    tolerance; it is in fact bit for bit, since the ranks sum their exact
    integer accumulators. (The unsharded W8A8 encoder against JAX's is
    test_torch_quant's.) Then in float32 a control: with each rank's
    activation scale taken over its own input slice (the max not reduced
    over the ranks) the sharded encoder differs."""
    jq = jquant.quantize_whisper_params(jmodel.init_params(jax.random.PRNGKey(0), JDIMS), min_size=1)
    mel = np.random.default_rng(2).standard_normal((8, DIMS.n_mels, 3000)).astype(np.float32)
    tq = model.params_from_numpy(jax.tree.map(np.asarray, jq), "cpu", torch.bfloat16)
    ref = model.encoder_forward(tq, _t(mel), DIMS, act8=True)
    plan = _tp2()
    trees = sharding.shard_whisper_params(plan, tq)[0]
    outs = _on_ranks(plan, lambda g, r: model.encoder_forward(trees[r], _t(mel), DIMS, act8=True))
    np.testing.assert_allclose(_np(outs[0]), _np(ref), rtol=3e-2, atol=6e-2)
    assert torch.equal(outs[0], ref) and torch.equal(outs[1], ref)

    t32 = quant.quantize_whisper_params(model.init_params(0, DIMS, torch.float32, "cpu"), min_size=1)
    x = _t(mel[:2])
    one = model.encoder_forward(t32, x, DIMS, act8=True)
    trees32 = sharding.shard_whisper_params(plan, t32)[0]
    sharded = _on_ranks(plan, lambda g, r: model.encoder_forward(trees32[r], x, DIMS, act8=True))[0]
    assert torch.equal(sharded, one)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pgroup.TPRank, "all_reduce_max", lambda self, a: a)
        per_shard = _on_ranks(plan, lambda g, r: model.encoder_forward(trees32[r], x, DIMS, act8=True))[0]
    assert float((per_shard - one).abs().max()) > 1e-3


def test_dcn_shard_encode_and_decode_step_match_plain(tparams):
    """test_parallel_dcn.py's encode and language step through dcn_shard on
    a dcn=2 x dp=2 x tp=2 mesh of CPU replicas, batch-major, against the
    plain functions on one device (float32: TOL, where JAX's bf16 test
    allows 3e-2)."""
    plan = mesh.make_mesh(dp=2, tp=2, dcn=2, devices=["cpu"] * 8)
    trees = sharding.shard_whisper_params(plan, tparams)
    mel = _t(np.random.default_rng(0).standard_normal((8, DIMS.n_mels, 3000)).astype(np.float32))

    def encode(sub, trees_s, mel_s):
        parts = mesh.shard_batch(sub, mel_s)
        out = sub.run(lambda g, r: loop.encode_window(trees_s[g][r], parts[g][r], DIMS))
        return mesh.gather_rows([cell[0][0] for cell in out], sub.first_device)

    ref, ck, cv = loop.encode_window(tparams, mel, DIMS)
    got = mesh.dcn_shard(plan, encode, batch_argnums=(0, 1))(trees, mel)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=TOL, atol=TOL)

    def step(sub, trees_s, mel_s):
        parts = mesh.shard_batch(sub, mel_s)

        def cell(g, r):
            _, k, v = loop.encode_window(trees_s[g][r], parts[g][r], DIMS)
            return loop.detect_language_logits(trees_s[g][r], k, v, dims=DIMS, special=SP)

        return mesh.gather_rows([c[0] for c in sub.run(cell)], sub.first_device)

    ref_lang = loop.detect_language_logits(tparams, ck, cv, dims=DIMS, special=SP)
    got_lang = mesh.dcn_shard(plan, step, batch_argnums=(0, 1))(trees, mel)
    np.testing.assert_allclose(_np(got_lang), _np(ref_lang), rtol=TOL, atol=1e-6)


def test_seq_parallel_encode_matches_jax_replicated():
    """test_parallel_sp.py: 8 ranks split a 64-frame encoder (mel T = 128)
    over replicated weights; every rank returns JAX's replicated output
    within 2e-5."""
    dims = model.WhisperDims(80, 207, 64, 64, 4, 2, 64, 64, 4, 2)
    jdims = jmodel.WhisperDims(*dataclasses.astuple(dims))
    jp = jmodel.init_params(jax.random.PRNGKey(0), jdims, dtype=jnp.float32)
    tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    mel = np.random.default_rng(1).standard_normal((1, dims.n_mels, 128)).astype(np.float32)
    ref = np.asarray(jmodel.encoder_forward(jp, jnp.asarray(mel), jdims))
    plan = mesh.make_mesh(dp=1, tp=8, devices=["cpu"] * 8)
    seq = sharding.encoder_seq_sharding(plan)
    outs = plan.run(lambda g, r: model.encoder_forward(tp, _t(mel), dims, seq_group=seq[g][r]))[0]
    for out in outs:
        assert out.shape == (1, dims.n_audio_ctx, dims.n_audio_state)
        np.testing.assert_allclose(_np(out), ref, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="tp = 1"):
        sharding.encoder_seq_sharding(mesh.make_mesh(dp=2, devices=["cpu"] * 2))


def test_k2_plain_version_with_fewer_queries_than_keys():
    """K2's plain version, and its wrapper on the CPU, with each rank's query
    rows over all keys: the same rows of the full attention."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 3, 150, 64), generator=g) for _ in range(3))
    full = attention.mha_encoder_reference(q, k, v)
    for a, b in ((0, 75), (75, 150), (40, 50)):
        part = attention.mha_encoder_reference(q[:, :, a:b], k, v)
        torch.testing.assert_close(part, full[:, :, a:b], rtol=1e-6, atol=1e-6)
    out = attention.mha_encoder(q[:, :, 75:], k, v)
    assert out.shape == (1, 3, 75, 64) and out.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(out, full[:, :, 75:], rtol=1e-6, atol=1e-6)
    # the kernel's shape checks (the device checks stood in for): fewer
    # queries than keys pass, keys and values of other lengths do not
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "check_cuda", lambda *a, **kw: None)
        attention._check_cuda(bf[0][:, :, 75:], bf[1], bf[2])
        with pytest.raises(ValueError, match="does not match"):
            attention._check_cuda(bf[0], bf[1], bf[2][:, :, :140])


# ---------------------------------------------------------------------------
# the tp group
# ---------------------------------------------------------------------------


def _bounded(fn, limit=30.0):
    """fn() in a thread joined within `limit` seconds → (result, error)."""
    box = {}

    def body():
        try:
            box["result"] = fn()
        except BaseException as e:  # handed to the test below
            box["error"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(limit)
    assert not t.is_alive(), "the mesh did not end within its bound"
    return box.get("result"), box.get("error")


def test_a_failing_rank_makes_every_rank_raise():
    plan = mesh.make_mesh(dp=1, tp=3, devices=["cpu"] * 3, timeout=20.0)
    seen = []

    def rank(g, r):
        if r == 1:
            raise ValueError("rank 1 fails before the collective")
        try:
            return plan.rank(g, r).all_reduce_sum(torch.ones(2))
        except pgroup.GroupAborted:
            seen.append(r)
            raise

    t0 = time.perf_counter()
    _, err = _bounded(lambda: plan.run(rank))
    assert isinstance(err, ValueError) and "rank 1" in str(err)
    assert sorted(seen) == [0, 2] and time.perf_counter() - t0 < 10.0  # aborted, not timed out
    # the plan's groups are usable again on the next run
    out, err = _bounded(lambda: plan.run(lambda g, r: plan.rank(g, r).all_reduce_sum(torch.ones(2))))
    assert err is None and all(torch.equal(x, torch.full((2,), 3.0)) for x in out[0])


def test_a_rank_that_never_arrives_times_out():
    plan = mesh.make_mesh(dp=1, tp=2, devices=["cpu"] * 2, timeout=0.5)

    def rank(g, r):
        if r == 1:
            time.sleep(2.0)
            return None
        return plan.rank(g, r).all_reduce_sum(torch.ones(1))

    _, err = _bounded(lambda: plan.run(rank))
    assert isinstance(err, pgroup.GroupAborted)


def test_collectives_are_bit_identical_across_ranks_under_stress():
    """Many rounds from 4 ranks with a short switch interval: every rank
    holds the first rank's rank-order sum bit for bit, the max, the gather
    and the agreed value."""
    plan = mesh.make_mesh(dp=1, tp=4, devices=["cpu"] * 4, timeout=60.0)
    rounds = 200
    xs = [[torch.from_numpy(np.random.default_rng(100 * r + i).standard_normal(17).astype(np.float32))
           for i in range(rounds)] for r in range(4)]

    def rank(g, r):
        h = plan.rank(g, r)
        return [(h.all_reduce_sum(xs[r][i]), h.all_reduce_max(xs[r][i]), h.all_gather(xs[r][i][None], 0),
                 h.agree(lambda: i * 10 + r)) for i in range(rounds)]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs, err = _bounded(lambda: plan.run(rank), limit=120.0)
    finally:
        sys.setswitchinterval(old)
    assert err is None
    for i in range(rounds):
        want_sum = xs[0][i] + xs[1][i] + xs[2][i] + xs[3][i]
        for r in range(4):
            s, m, gathered, agreed = outs[0][r][i]
            assert torch.equal(s, want_sum)
            assert torch.equal(m, torch.stack([xs[q][i] for q in range(4)]).amax(0))
            assert torch.equal(gathered, torch.stack([xs[q][i] for q in range(4)]))
            assert agreed == i * 10


# ---------------------------------------------------------------------------
# the launcher, with a stand-in kernel library
# ---------------------------------------------------------------------------


class _FakeCuda:
    """Stand-ins for torch.cuda.device / current_stream: a thread-local
    current device, and each device's stream a distinct handle."""

    def __init__(self):
        self.local = threading.local()

    def current(self):
        return getattr(self.local, "device", 0)

    def device(self, dev):
        fake = self

        class _Ctx:
            def __enter__(self):
                self.prev = fake.current()
                fake.local.device = torch.device(dev).index
                return self

            def __exit__(self, *exc):
                fake.local.device = self.prev
                return False

        return _Ctx()

    def current_stream(self, dev=None):
        index = self.current() if dev is None else torch.device(dev).index
        return type("Stream", (), {"cuda_stream": 1000 + index})()


def test_launch_runs_on_its_tensors_device_and_stream_and_counts_exactly(monkeypatch):
    fake = _FakeCuda()
    calls = []

    class _Lib:
        def wk_log_mel(self, *args):
            calls.append((fake.current(), args[-1].value))
            return 0

    lib = _Lib()
    monkeypatch.setattr(torch.cuda, "device", fake.device)
    monkeypatch.setattr(torch.cuda, "current_stream", fake.current_stream)
    monkeypatch.setattr(_build, "library", lambda: type("L", (), {"wk_log_mel": staticmethod(lib.wk_log_mel)})())
    _build.reset_launches()
    # the calling thread has made device 0 current; the tensors lie on device 3
    with fake.device("cuda:0"):
        _build.launch("log_mel", "wk_log_mel", torch.device("cuda", 3), 7)
        assert fake.current() == 0
    assert calls == [(3, 1003)]

    threads_n, per = 8, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda i=i: [
            _build.launch("log_mel", "wk_log_mel", torch.device("cuda", i % 4)) for _ in range(per)])
            for i in range(threads_n)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert _build.launches["log_mel"] == 1 + threads_n * per
    by_device = {d: c["log_mel"] for d, c in _build.launches_by_device.items()}
    assert by_device == {"cuda:0": 2 * per, "cuda:1": 2 * per, "cuda:2": 2 * per, "cuda:3": 2 * per + 1}
    assert all(dev == stream - 1000 for dev, stream in calls)
    _build.reset_launches()
    assert _build.launches_by_device == {} and not any(_build.launches.values())
