"""The Qwen3 decode glue (ops/qwen3_decode.py) on the CPU.

Each plain version is the layer stack's former composition bit for bit;
`_qwen3_layers` through the decode path (the predicate patched to admit
the CPU, where every wrapper runs its plain version) equals the former
layer stack for the talker's step and a whole `multicode_forward`;
`qwen3_decode_takes` admits the TTS frame's stacks and refuses the rest;
the products that share an input go to one W8A16 launch and no other kind;
the card check's comparisons flag altered outputs. The kernels themselves
run on the card: tests/test_torch_qwen3_decode_card.py and
`chip_smoke.py --qwen3-decode`.
"""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F

from whisperkit_tpu_torch.models import qwen3_tts as tm
from whisperkit_tpu_torch.ops import _build, quant, qwen3_decode
from whisperkit_tpu_torch.tools import qwen3_decode_check as check

CPU = torch.device("cpu")
DIMS = tm.TINY_TTS_DIMS
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# The former layer stack, as it stood before the glue went into kernels
# ---------------------------------------------------------------------------


def _former_rms_norm(x, g, eps=1e-6):
    return F.rms_norm(x.float(), (x.shape[-1],), g.float(), eps).to(x.dtype)


def _former_rope(x, cos, sin):
    half = x.shape[-1] // 2
    x32 = x.float()
    return (x32 * cos + torch.cat([x32[..., half:], x32[..., :half]], dim=-1) * sin).to(x.dtype)


def _former_attention(q, k, v, qnorm, knorm, cos, sin, kv_k, kv_v, li, pos_offset, mask, h, kvh, dh, eps):
    """The former `_qwen3_layers`' attention block for layer `li`, from the
    projections [B, T, heads · Dh] to its output [B, T, H · Dh]."""
    b, t, _ = q.shape
    rep = h // kvh
    at_tensor = isinstance(pos_offset, torch.Tensor)
    if at_tensor:
        slots = pos_offset + torch.arange(t, device=q.device)
        end = kv_k.shape[3]
    else:
        end = pos_offset + t
    q = q.reshape(b, t, h, dh)
    k = k.reshape(b, t, kvh, dh)
    v = v.reshape(b, t, kvh, dh)
    if qnorm is not None:
        q = _former_rms_norm(q, qnorm, eps)
        k = _former_rms_norm(k, knorm, eps)
    q = _former_rope(q, cos, sin)
    k = _former_rope(k, cos, sin)
    if at_tensor:
        kv_k[li].index_copy_(2, slots, k.transpose(1, 2))
        kv_v[li].index_copy_(2, slots, v.transpose(1, 2))
    else:
        kv_k[li, :, :, pos_offset:end] = k.transpose(1, 2)
        kv_v[li, :, :, pos_offset:end] = v.transpose(1, 2)
    kfull = kv_k[li, :, :, None, :end].expand(b, kvh, rep, end, dh).reshape(b, h, end, dh)
    vfull = kv_v[li, :, :, None, :end].expand(b, kvh, rep, end, dh).reshape(b, h, end, dh)
    scores = (q.transpose(1, 2).float() @ kfull.float().transpose(-1, -2)) / math.sqrt(dh)
    probs = torch.softmax(scores + mask, dim=-1).to(vfull.dtype)
    return (probs @ vfull).transpose(1, 2).reshape(b, t, h * dh)


def _former_layers(blocks, x, positions, mask, pos_offset, kv_k, kv_v, *, n_head, n_kv_head, head_dim, rope_theta,
                   qk_norm, layer_scale, final_norm, rms_eps=1e-6):
    """The former `_qwen3_layers` (every product alone, every add and norm
    its own op), followed by its callers' last RMSNorm."""
    cos, sin = tm._rope_angles(positions, rope_theta, head_dim)
    for li in range(kv_k.shape[0]):
        bp = tm._layer(blocks, li)
        hthin = _former_rms_norm(x, bp["ln1"], rms_eps)
        q, k, v = (tm._mm(hthin, bp[key]) for key in ("wq", "wk", "wv"))
        out = _former_attention(q, k, v, bp["qnorm"] if qk_norm else None, bp["knorm"] if qk_norm else None, cos,
                                sin, kv_k, kv_v, li, pos_offset, mask, n_head, n_kv_head, head_dim, rms_eps)
        attn = tm._mm(out, bp["wo"])
        if layer_scale:
            attn = attn * bp["attn_scale"].to(attn.dtype)
        x = x + attn
        hthin = _former_rms_norm(x, bp["ln2"], rms_eps)
        mlp = tm._mm(F.silu(tm._mm(hthin, bp["w_gate"])) * tm._mm(hthin, bp["w_up"]), bp["w_down"])
        if layer_scale:
            mlp = mlp * bp["mlp_scale"].to(mlp.dtype)
        x = x + mlp
    return _former_rms_norm(x, final_norm, rms_eps)


# ---------------------------------------------------------------------------
# Each plain version against the former composition
# ---------------------------------------------------------------------------


def _bf16(g, shape, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=g) * scale + shift).to(BF16)


@pytest.mark.parametrize("with_y", [False, True], ids=["norm", "add"])
@pytest.mark.parametrize("d", [64, 1024])
def test_add_rms_norm_plain_is_the_former_composition(with_y, d):
    g = torch.Generator().manual_seed(d)
    x, y, w = _bf16(g, (4, 2, d), 2.0), _bf16(g, (4, 2, d), 2.0), _bf16(g, (d,), 0.1, 1.0)
    s, h = qwen3_decode.add_rms_norm(x, y if with_y else None, w, 1e-6)
    want_s = x + y if with_y else x
    assert torch.equal(s, want_s)
    assert torch.equal(h, _former_rms_norm(want_s, w))


def test_swiglu_plain_is_the_former_composition():
    g = torch.Generator().manual_seed(3)
    gate, up = _bf16(g, (4, 1, 3072), 3.0), _bf16(g, (4, 1, 3072), 3.0)
    assert torch.equal(qwen3_decode.swiglu(gate, up), F.silu(gate) * up)


@pytest.mark.parametrize("kind, t, slot", [("talker", 1, 205), ("talker", 1, check.TALKER_S - 1), ("cp", 2, 0),
                                           ("cp", 1, 9)])
def test_attention_plain_is_the_former_block(kind, t, slot):
    """The tensor slot with the left pads' key_invalid (the talker), the
    int slot at T = 2 and T = 1 (the code predictor), at the frame's
    widths: output and both caches bit-equal."""
    case = check.attention_case(CPU, kind, slot, t)
    out, ck, cv = check.run_attention(case, qwen3_decode.decode_attention)
    fk, fv = case["cache_k"].clone()[None], case["cache_v"].clone()[None]
    want = _former_attention(case["q"], case["k"], case["v"], case["qnorm"], case["knorm"], case["cos"],
                             case["sin"], fk, fv, 0, case["pos_offset"], case["mask"], check.N_HEAD,
                             check.N_KV_HEAD, check.HEAD_DIM, check.EPS)
    assert torch.equal(out, want)
    assert torch.equal(ck, fk[0]) and torch.equal(cv, fv[0])
    assert not torch.equal(ck, case["cache_k"])  # the slot was written


# ---------------------------------------------------------------------------
# The layer stacks through the decode path against the former stack
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree():
    return tm.init_tts_params(torch.Generator().manual_seed(5), DIMS, BF16, CPU)


def _quantized(tree, scheme):
    if scheme == "bf16":
        return tree
    return quant.quantize_tts_params(tree, min_size=1, bits=8 if scheme == "w8a16" else 4)


@pytest.fixture
def decode_path(monkeypatch):
    """Admit the CPU stacks at decode shapes into the decode path (whose
    wrappers run their plain versions here), recording each admission."""
    admitted = []
    takes = qwen3_decode.qwen3_decode_takes

    def on_cpu(device_type, *args, **kwargs):
        ok = takes("cuda", *args, **{**kwargs, "head_dim": qwen3_decode.HEAD_DIM})
        admitted.append(ok)
        return ok

    monkeypatch.setattr(qwen3_decode, "qwen3_decode_takes", on_cpu)
    return admitted


def _talker_step(params, layers, monkeypatch):
    b, s, cached, pads = 3, 24, 4, torch.tensor([0, 2, 5])
    g = torch.Generator().manual_seed(11)
    kv_k, kv_v = (_bf16(g, (DIMS.n_layer, b, DIMS.n_kv_head, s, DIMS.head_dim)) for _ in range(2))
    slot_i = torch.arange(s)[None, :]
    key_invalid = (slot_i >= cached) & (slot_i < cached + pads[:, None])
    x = _bf16(g, (b, 1, DIMS.d_model))
    slot = torch.tensor(17)
    monkeypatch.setattr(tm, "_qwen3_layers", layers)
    logits, hidden = tm.code_decoder_forward(params, x, slot, kv_k, kv_v, DIMS, rope_offset=slot - pads,
                                             key_invalid=key_invalid)
    return logits, hidden, kv_k, kv_v


@pytest.mark.parametrize("scheme", ["w8a16", "bf16", "w4a16"])
def test_talker_step_through_the_decode_path_equals_the_former_stack(tree, scheme, decode_path, monkeypatch):
    params = _quantized(tree, scheme)
    new = _talker_step(params, tm._qwen3_layers, monkeypatch)
    former = _talker_step(params, _former_layers, monkeypatch)
    assert decode_path == [True]
    for a, b in zip(new, former):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scheme", ["w8a16", "bf16"])
def test_multicode_through_the_decode_path_equals_the_former_stack(tree, scheme, decode_path, monkeypatch):
    """A whole frame of the code predictor: its T = 2 prefill and 14 T = 1
    passes, 15 sampled heads (T 0.9): codes and codec sum bit-equal."""
    params = _quantized(tree, scheme)
    g = torch.Generator().manual_seed(13)
    hidden, code0 = _bf16(g, (3, DIMS.d_model)), torch.tensor([1, 40, 900])
    noise = -torch.log(-torch.log(torch.rand((3, 15, 5), generator=g)))

    def run(layers):
        monkeypatch.setattr(tm, "_qwen3_layers", layers)
        return tm.multicode_forward(params, hidden, code0, 0.9, 5, dims=DIMS, noise=noise)

    new, former = run(tm._qwen3_layers), run(_former_layers)
    assert decode_path == [True] * 15
    assert torch.equal(new[0], former[0]) and torch.equal(new[1], former[1])


def test_prefill_and_float32_stacks_keep_the_plain_path(tree, decode_path, monkeypatch):
    """A multi-position prefill and a float32 stack are refused even where
    the device would be admitted: they run the plain versions."""
    monkeypatch.setattr(qwen3_decode, "add_rms_norm", lambda *a, **k: pytest.fail("a kernel wrapper ran"))
    kv_k, kv_v = tm.init_code_kv_cache(DIMS, 2, 16, BF16, CPU)
    tm.code_decoder_forward(tree, _bf16(torch.Generator().manual_seed(1), (2, 5, DIMS.d_model)), 0, kv_k, kv_v, DIMS)
    f32 = tm.map_tree(lambda _, t: t.float() if t.is_floating_point() else t, tree)
    kv_k, kv_v = tm.init_code_kv_cache(DIMS, 2, 16, torch.float32, CPU)
    tm.code_decoder_forward(f32, torch.zeros((2, 1, DIMS.d_model)), 3, kv_k, kv_v, DIMS)
    assert decode_path == [False, False]


@pytest.mark.parametrize("scheme, sibling_calls, w4_calls", [("w8a16", [3, 2], 0), ("w4a16", [], 7), ("bf16", [], 0)])
def test_products_that_share_an_input_share_a_launch_only_for_w8a16(tree, scheme, sibling_calls, w4_calls,
                                                                    decode_path, monkeypatch):
    """Through the decode path a W8A16 layer sends q/k/v and gate/up each
    to one `quantized_matmul_siblings` call; W4A16 and bf16 weights keep one
    product each."""
    params = _quantized(tree, scheme)
    siblings, w4 = [], []
    real_siblings, real_w4 = quant.quantized_matmul_siblings, quant.quantized_matmul_w4
    monkeypatch.setattr(quant, "quantized_matmul_siblings",
                        lambda x, qs, bs: siblings.append(len(qs)) or real_siblings(x, qs, bs))
    monkeypatch.setattr(quant, "quantized_matmul_w4", lambda x, q: w4.append(1) or real_w4(x, q))
    mc = params["mc"]
    kv_shape = (1, 2, DIMS.cp_kv_head, 17, DIMS.cp_head_dim)
    blocks = {k: ({kk: vv[:1] for kk, vv in v.items()} if isinstance(v, dict) else v[:1])
              for k, v in mc["blocks"].items()}
    x = _bf16(torch.Generator().manual_seed(2), (2, 1, DIMS.d_model))
    tm._qwen3_layers(blocks, x, torch.full((2, 1), 3), tm._causal_mask(3, 1, CPU)[None, None], 3,
                     torch.zeros(kv_shape, dtype=BF16), torch.zeros(kv_shape, dtype=BF16),
                     n_head=DIMS.cp_head, n_kv_head=DIMS.cp_kv_head, head_dim=DIMS.cp_head_dim, rope_theta=1e4,
                     qk_norm=True, layer_scale=False, final_norm=mc["ln_f"])
    # the singles (wo, down) go through quantized_matmul, itself one sibling call each
    assert [n for n in siblings if n > 1] == sibling_calls and len(w4) == w4_calls


# ---------------------------------------------------------------------------
# Where the decode path engages
# ---------------------------------------------------------------------------

_TALKER = dict(t=1, n_head=16, n_kv_head=8, head_dim=128, n_keys=450, d_model=1024, qk_norm=True, layer_scale=False)
_C2W = tm.Code2WavDims()


@pytest.mark.parametrize("device_type, dtypes, changes, takes", [
    ("cuda", (BF16,) * 3, {}, True),  # the talker's step
    ("cuda", (BF16,) * 3, {"t": 2, "n_keys": 2}, True),  # the code predictor's prefill
    ("cuda", (BF16,) * 3, {"n_keys": 17}, True),  # its steps
    ("cuda", (BF16,) * 3, {"d_model": 2048}, True),  # the 1.7b talker
    ("cpu", (BF16,) * 3, {}, False),
    ("cuda", (torch.float32, BF16, BF16), {}, False),
    ("cuda", (BF16, BF16, torch.float32), {}, False),  # float32 norm weights
    ("cuda", (BF16,) * 3, {"t": 3, "n_keys": 3}, False),
    ("cuda", (BF16,) * 3, {"t": 120}, False),  # the talker's prefill
    ("cuda", (BF16,) * 3, {"layer_scale": True}, False),
    ("cuda", (BF16,) * 3, {"qk_norm": False}, False),
    ("cuda", (BF16,) * 3, {"head_dim": 64}, False),
    ("cuda", (BF16,) * 3, {"n_head": 40}, False),  # 5 query heads a KV head
    ("cuda", (BF16,) * 3, {"n_keys": 2049}, False),
    ("cuda", (BF16,) * 3, {"d_model": 1020}, False),
    ("cuda", (torch.float32,) * 3, dict(t=_C2W.sliding_window, n_head=_C2W.n_head, n_kv_head=_C2W.n_kv_head,
                                        head_dim=_C2W.head_dim, n_keys=_C2W.sliding_window, d_model=_C2W.d_model,
                                        qk_norm=False, layer_scale=True), False),  # the vocoder's pre-transformer
])
def test_qwen3_decode_takes(device_type, dtypes, changes, takes):
    assert qwen3_decode.qwen3_decode_takes(device_type, dtypes, **{**_TALKER, **changes}) is takes


def test_kernels_are_registered_and_cpu_calls_count_no_launch():
    assert {"qwen3_add_rms_norm", "qwen3_decode_attention", "qwen3_swiglu"} <= set(_build.KERNELS)
    assert {"wk_qwen3_add_rms_norm", "wk_qwen3_decode_attention", "wk_qwen3_swiglu"} <= set(_build._SIGNATURES)
    _build.reset_launches()
    case = check.attention_case(CPU, "cp", 2)
    check.run_attention(case, qwen3_decode.decode_attention)
    x = _bf16(torch.Generator().manual_seed(0), (2, 1, 64))
    qwen3_decode.add_rms_norm(x, x, torch.ones(64, dtype=BF16), 1e-6)
    qwen3_decode.swiglu(x, x)
    assert _build.launches == dict.fromkeys(_build.KERNELS, 0)


# ---------------------------------------------------------------------------
# The card check can fail
# ---------------------------------------------------------------------------


def test_bf16_ulps_counts_steps_across_zero():
    a = torch.tensor([1.0, -1.0, 0.0, -0.0, 2.0], dtype=BF16)
    up = (a.view(torch.int16) + torch.tensor([2, 1, 1, 0, 0], dtype=torch.int16)).view(BF16)
    assert check.bf16_ulps(a, up).tolist() == [2, 1, 1, 0, 0]
    assert int(check.bf16_ulps(torch.tensor([-0.0], dtype=BF16), torch.tensor([0.0], dtype=BF16))) == 0


@pytest.mark.parametrize("fault", ["output", "value", "untouched", "key"])
def test_the_attention_check_flags_a_faulted_kernel(fault, monkeypatch):
    """A stand-in kernel that nudges its output by two bf16 steps, or
    alters the value or key it writes, or a slot it must not write: the
    check's limits fail it."""
    plain = qwen3_decode.decode_attention_reference

    def faulted(*args, **kwargs):
        out = plain(*args, **kwargs)
        ck, cv, slot = args[7], args[8], int(args[9])
        if fault == "output":
            out = (out.view(torch.int16) + 2).view(BF16)
        elif fault == "value":
            cv[:, :, slot] *= 2
        elif fault == "untouched":
            ck[:, :, slot - 1] *= 2
        else:
            ck[:, :, slot] = (ck[:, :, slot].view(torch.int16) + 1).view(BF16)
        return out

    monkeypatch.setattr(qwen3_decode, "decode_attention", faulted)
    case = check.attention_case(CPU, "talker", 205)
    results = {"attention/talker": check.check_attention(case)}
    assert check.failures(results)
    monkeypatch.setattr(qwen3_decode, "decode_attention", plain)
    assert not check.failures({"attention/talker": check.check_attention(case)})


def test_the_frame_check_compares_against_the_plain_paths_error():
    frame = {"code0": {"kernel_err": 0.02, "plain_err": 0.02}, "heads": {"kernel_err": 0.031, "plain_err": 0.02}}
    assert len(check.frame_failures(frame)) == 1

