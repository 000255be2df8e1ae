"""The port's weight quantization (`whisperkit_tpu_torch/ops/quant.py`) and
the quantized encoder against the JAX package, on the CPU.

The same numpy weights and inputs go through `whisperkit_tpu.ops.quant` and
its port at float32. Codes and scales must be equal bit for bit; products
agree to float32 summation order, except where W8A8's row quantization of
the activations meets a rounding boundary (stated at each test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.ops import quant as jquant
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.ops import quant
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

DIMS = model.WhisperDims(80, 207, 1500, 64, 4, 2, 64, 64, 4, 2)
JDIMS = jmodel.WhisperDims(*dataclasses.astuple(DIMS))


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _np32(x):
    """numpy float32 of a torch tensor or a (possibly bf16) JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(jax.random.PRNGKey(0), JDIMS, dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return model.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)


def _weight(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 128), (256, 48)])
def test_quantize_weight_equals_jax_bit_for_bit(shape):
    w = _weight(shape, 1)
    ref = jquant.quantize_weight(jnp.asarray(w))
    out = quant.quantize_weight(_t(w))
    assert out["w_q"].dtype == torch.int8 and out["scale"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w_q"].numpy(), np.asarray(ref["w_q"]))
    np.testing.assert_array_equal(_np32(out["scale"]), _np32(ref["scale"]))
    np.testing.assert_array_equal(
        _np32(quant.dequantize_weight(out, torch.float32)),
        np.asarray(jquant.dequantize_weight(ref, jnp.float32)),
    )


@pytest.mark.parametrize(
    "shape, groups",
    [((128, 96), 2), ((50, 8), 1)],  # 64-row groups; one group when 64 does not divide
    ids=["two_groups", "one_group"],
)
def test_quantize_weight_w4_equals_jax_bit_for_bit(shape, groups):
    w = _weight(shape, 2)
    ref = jquant.quantize_weight_w4(jnp.asarray(w))
    out = quant.quantize_weight_w4(_t(w))
    assert out["w_q4"].dtype == torch.uint8 and out["w_q4"].shape == (shape[0] // 2, shape[1])
    assert out["scale4"].dtype == torch.bfloat16 and out["scale4"].shape == (groups, shape[1])
    np.testing.assert_array_equal(out["w_q4"].numpy(), np.asarray(ref["w_q4"]))
    np.testing.assert_array_equal(_np32(out["scale4"]), _np32(ref["scale4"]))
    for a, b in zip(quant._unpack4_planes(out["w_q4"]), jquant._unpack4_planes(ref["w_q4"])):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        _np32(quant.w4_dequant(out, torch.float32)),
        np.asarray(jquant.dequantize_weight_w4(ref, jnp.float32)),
    )


def test_quantize_weight_w4_rejects_an_odd_input_dim():
    with pytest.raises(ValueError, match="even"):
        quant.quantize_weight_w4(torch.zeros((7, 4)))


# ---------------------------------------------------------------------------
# dense products
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["plain", "w8a16", "w4a16", "w8a8"])
def test_dense_matches_jax(scheme):
    """The same quantized weight (JAX's, carried across) through JAX's and
    the port's `dense`. Float32 throughout: equal up to summation order
    (1e-5); W8A8's integer dot is exact on both sides."""
    rng = np.random.default_rng(3)
    w = _weight((128, 48), 4)
    b = (rng.standard_normal(48) * 0.01).astype(np.float32)
    x = rng.standard_normal((3, 7, 128)).astype(np.float32)
    if scheme == "plain":
        jp = {"w": jnp.asarray(w)}
    elif scheme == "w4a16":
        jp = jquant.quantize_weight_w4(jnp.asarray(w))
    else:
        jp = jquant.quantize_weight(jnp.asarray(w))
    jp = dict(jp, b=jnp.asarray(b))
    tp = {
        k: _t(np.asarray(v)) if jnp.issubdtype(v.dtype, jnp.integer)
        else _t(_np32(v)).to(torch.bfloat16 if k in quant.SCALE_KEYS else torch.float32)
        for k, v in jp.items()
    }
    a8 = scheme == "w8a8"
    ref = np.asarray(jmodel.dense(jnp.asarray(x), jp, a8=a8))
    out = model.dense(_t(x), tp, a8=a8)
    assert out.dtype == torch.float32 and out.shape == (3, 7, 48)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_w8a8_integer_dot_is_exact():
    """W8A8 rescales an exact integer accumulator: the product equals an
    int64 numpy dot of the row-quantized activation, bit for bit."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((5, 1280)).astype(np.float32) * 3
    x[0] = 127.0  # a row of maximal codes: 1280 · 127² > 2^24
    q = quant.quantize_weight(_t(_weight((1280, 16), 6)))
    q["w_q"][:, 0] = 127
    out = quant.quantized_matmul_w8a8(_t(x), q).numpy()
    a_scale = np.maximum(np.abs(x).max(-1, keepdims=True) / np.float32(127.0), np.float32(1e-8))
    xq = np.clip(np.round(x / a_scale), -127, 127).astype(np.int64)
    acc = xq @ q["w_q"].numpy().astype(np.int64)
    assert acc[0, 0] == 1280 * 127 * 127
    ref = acc.astype(np.float32) * a_scale * q["scale"].float().numpy()
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# the W8A16 product's kernel: dispatch, registry, plain version, checks
# ---------------------------------------------------------------------------

MAX_ROWS = quant.W8A16_KERNEL_MAX_ROWS


@pytest.mark.parametrize(
    "device, dtype, rows, k, n, takes",
    [
        ("cuda", torch.bfloat16, 1, 1280, 1280, True),
        ("cuda", torch.bfloat16, 32, 1280, 5120, True),
        ("cuda", torch.bfloat16, MAX_ROWS, 5120, 1280, True),
        ("cuda", torch.bfloat16, MAX_ROWS + 1, 1280, 1280, False),  # the encoder's side
        ("cuda", torch.bfloat16, 32 * 1500, 1280, 1280, False),
        ("cuda", torch.bfloat16, 0, 1280, 1280, False),
        ("cpu", torch.bfloat16, 32, 1280, 1280, False),
        ("cuda", torch.float32, 32, 1280, 1280, False),
        ("cuda", torch.bfloat16, 32, 1280 + 32, 1280, False),  # off the kernel's tiles
        ("cuda", torch.bfloat16, 32, 1280, 1280 + 32, False),
        ("cuda", torch.bfloat16, 32, 1280, 640, True),  # a tp column slice
        ("cuda", torch.bfloat16, 32, 640, 1280, True),  # a tp row slice
    ],
)
def test_w8a16_dispatch_is_a_rule_of_shape_and_device(device, dtype, rows, k, n, takes):
    """The kernel at and below W8A16_KERNEL_MAX_ROWS rows of a CUDA bf16
    product on its tiles; the plain version above it, for every CPU
    product, and off the tiles."""
    assert quant.w8a16_kernel_takes(device, dtype, rows, k, n) is takes


def test_w8a16_kernel_is_registered_and_unlaunched_on_the_cpu():
    """`w8a16_matmul` is one of the counted kernels with a C signature; the
    CPU runs the plain version, so its count stays 0."""
    from whisperkit_tpu_torch.ops import _build

    assert "w8a16_matmul" in _build.KERNELS and "wk_w8a16_matmul" in _build._SIGNATURES
    _build.reset_launches()
    q = quant.quantize_weight(_t(_weight((128, 64), 7)))
    x = _t(np.random.default_rng(7).standard_normal((4, 128))).to(torch.bfloat16)
    quant.quantized_matmul(x, q)
    quant.w8a16_matmul(x, [q], [None])
    assert _build.launches["w8a16_matmul"] == 0 and not _build.launches_by_device


def _w8a16_case(case):
    """(x bf16, W8A16 dict, bias or None) for each layout the decoder hands
    the product: 2-d and 3-d x, a tp rank's column and row slices (contiguous
    copies, as parallel/sharding cuts them), a bias."""
    rng = np.random.default_rng(11)
    q = quant.quantize_weight(_t(_weight((256, 128), 12)))
    x_shape = {"3d": (4, 1, 256), "row_slice": (6, 128)}.get(case, (6, 256))
    x = _t(rng.standard_normal(x_shape)).to(torch.bfloat16)
    bias = None
    if case == "column_slice":
        q = {"w_q": q["w_q"][:, 64:].contiguous(), "scale": q["scale"][64:].contiguous()}
    elif case == "row_slice":
        q = {"w_q": q["w_q"][128:].contiguous(), "scale": q["scale"]}
    elif case == "bias":
        bias = _t(rng.standard_normal(128) * 0.1).to(torch.bfloat16)
    return x, q, bias


@pytest.mark.parametrize("case", ["2d", "3d", "column_slice", "row_slice", "bias"])
def test_w8a16_plain_version_is_the_dequant_product_bit_for_bit(case):
    """What the CPU runs for `quantized_matmul`, `w8a16_matmul` and `dense`
    is x @ dequantize_weight(q, x.dtype), then `+ b` on the rounded product:
    the arithmetic the kernel repeats."""
    x, q, bias = _w8a16_case(case)
    ref = x @ quant.dequantize_weight(q, x.dtype)
    if bias is not None:
        ref = ref + bias
    assert ref.dtype == torch.bfloat16
    for out in (quant.quantized_matmul(x, q, bias), quant.w8a16_matmul(x, [q], [bias])[0],
                quant.quantized_matmul_reference(x, q, bias)):
        assert out.shape == ref.shape and torch.equal(out, ref)
    p = dict(q, **({"b": bias} if bias is not None else {}))
    assert torch.equal(model.dense(x, p), ref)


def test_w8a16_siblings_equal_each_product_alone():
    """q, k and v of one input in one call (one launch on the card) give
    each product's own result; `dense_siblings` falls back to `dense` for
    float weights."""
    rng = np.random.default_rng(13)
    x = _t(rng.standard_normal((5, 1, 128))).to(torch.bfloat16)
    ps = [dict(quant.quantize_weight(_t(_weight((128, 64), 20 + i))),
               **({"b": _t(rng.standard_normal(64) * 0.1).to(torch.bfloat16)} if i != 1 else {})) for i in range(3)]
    together = model.dense_siblings(x, ps)
    assert all(torch.equal(a, model.dense(x, p)) for a, p in zip(together, ps))
    floats = [{"w": _t(_weight((128, 64), 30 + i)).to(torch.bfloat16)} for i in range(3)]
    assert all(torch.equal(a, x @ p["w"]) for a, p in zip(model.dense_siblings(x, floats), floats))


@pytest.mark.parametrize(
    "bad",
    ["codes_int16", "codes_float", "codes_3d", "features", "columns", "scale_shape", "scale_f32", "bias_shape",
     "x_f32", "four_products"],
)
def test_w8a16_wrapper_refuses_operands_it_does_not_take(bad):
    """The wrapper checks dtypes and shapes before it chooses the kernel or
    the plain version, so the CPU sees what the card would refuse."""
    x = _t(np.random.default_rng(17).standard_normal((4, 128))).to(torch.bfloat16)
    q = quant.quantize_weight(_t(_weight((128, 64), 18)))
    qs, biases = [q], [None]
    if bad == "codes_int16":
        qs = [dict(q, w_q=q["w_q"].to(torch.int16))]
    elif bad == "codes_float":
        qs = [dict(q, w_q=q["w_q"].float())]
    elif bad == "codes_3d":
        qs = [dict(q, w_q=q["w_q"][None])]
    elif bad == "features":
        x = x[:, :64]
    elif bad == "columns":
        qs = [quant.quantize_weight(_t(_weight((128, 48), 19)))]
    elif bad == "scale_shape":
        qs = [dict(q, scale=q["scale"][:32])]
    elif bad == "scale_f32":
        qs = [dict(q, scale=q["scale"].float())]
    elif bad == "bias_shape":
        biases = [torch.zeros(32, dtype=torch.bfloat16)]
    elif bad == "x_f32":
        x = x.float()
    else:
        qs, biases = [q] * 4, [None] * 4
    with pytest.raises((TypeError, ValueError)):
        quant.w8a16_matmul(x, qs, biases)


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------


def _leaves(tree):
    return jax.tree.flatten(tree)


@pytest.mark.parametrize(
    "bits, min_size",
    [(8, 1), (4, 1), (8, 1 << 14)],
    ids=["w8", "w4", "w8_stack_threshold"],
)
def test_quantize_whisper_params_has_the_jax_structure(jparams, tparams, bits, min_size):
    """Keys, dtypes, shapes and values of the port's quantized tree equal
    JAX's. At min_size 2^14 only fc1/fc2 are quantized: the threshold reads
    the layer stack's size (2 · 64 · 256), as JAX's stacked arrays do, not
    one layer's (2 · 64 · 64 < 2^14 ≤ 2 · 64 · 256)."""
    ref = jax.tree.map(np.asarray, jquant.quantize_whisper_params(jparams, min_size=min_size, bits=bits))
    ours = quant.quantize_whisper_params(tparams, min_size=min_size, bits=bits)
    assert "token_embed_f32" in ours["decoder"]
    back = model.params_to_numpy(ours)
    flat_r, tree_r = _leaves(ref)
    flat_o, tree_o = _leaves(back)
    assert tree_r == tree_o
    for a, b in zip(flat_r, flat_o):
        assert a.shape == b.shape
        if np.issubdtype(a.dtype, np.integer):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    blk = ours["encoder"]["blocks"][0]
    wkey = "w_q" if bits == 8 else "w_q4"
    assert wkey in blk["fc1"] and ("w" in blk["attn"]["q"]) == (min_size > 1)
    assert "w" in ours["encoder"]["conv1"]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_tree_round_trips(jparams, bits, dtype):
    """A quantized JAX tree comes across with its int8/uint8 codes and bf16
    scales intact whatever the float dtype asked for, and goes back to
    numpy with the same values; numpy → port → numpy → port is exact."""
    jq = jax.tree.map(np.asarray, jquant.quantize_whisper_params(jparams, min_size=1, bits=bits))
    ours = model.params_from_numpy(jq, "cpu", dtype)
    wkey, skey = ("w_q", "scale") if bits == 8 else ("w_q4", "scale4")
    fc1 = ours["decoder"]["blocks"][1]["fc1"]
    assert fc1[wkey].dtype == (torch.int8 if bits == 8 else torch.uint8)
    assert fc1[skey].dtype == torch.bfloat16
    assert fc1["b"].dtype == dtype and ours["decoder"]["token_embed"].dtype == dtype
    back = model.params_to_numpy(ours)
    for a, b in zip(_leaves(jq)[0], _leaves(back)[0]):
        if np.issubdtype(a.dtype, np.integer):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        elif dtype == torch.float32 or a.dtype != np.float32:  # f32 leaves cast to bf16 lose bits
            np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    again = model.params_from_numpy(back, "cpu", dtype)
    for a, b in zip(_leaves(ours)[0], _leaves(again)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_size_bytes_matches_jax(jparams, tparams, bits):
    ref = jquant.quantized_size_bytes(jquant.quantize_whisper_params(jparams, min_size=1, bits=bits))
    ours = quant.quantize_whisper_params(tparams, min_size=1, bits=bits)
    # token_embed_f32 is token_embed itself at float32 and counts once
    assert quant.quantized_size_bytes(ours) == ref
    assert quant.quantized_size_bytes(tparams) == jquant.quantized_size_bytes(jparams) > ref


# ---------------------------------------------------------------------------
# the quantized encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["w8a16", "w4a16"])
def test_encoder_forward_quantized_matches_jax(jparams, scheme):
    """JAX's W8A16/W4A16 tree through both encoders: equal to float32
    summation order (1e-4, as the unquantized encoder test)."""
    jq = jquant.quantize_whisper_params(jparams, min_size=1, bits=4 if scheme == "w4a16" else 8)
    tq = model.params_from_numpy(jax.tree.map(np.asarray, jq), "cpu", torch.float32)
    mel = np.random.default_rng(0).standard_normal((2, 80, 3000)).astype(np.float32)
    ref = np.asarray(jmodel.encoder_forward(jq, jnp.asarray(mel), JDIMS))
    out = model.encoder_forward(tq, _t(mel), DIMS).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_encoder_forward_act8_matches_jax(jparams):
    """W8A8 (`act8=True`) row-quantizes the input of every block linear.
    Where float32 summation order puts an activation on the other side of
    a rounding boundary its code moves by one, which moves that row's
    output by about a_scale · |w|, and attention spreads the change to the
    other rows, so single entries may differ by up to ~1% of the output
    scale (bound 0.05 of max |ref| ≈ 4). The tree as a whole must stay far
    closer to JAX's W8A8 than W8A8 is to W8A16 (a broken or skipped A8
    path would be as far as that)."""
    jq = jquant.quantize_whisper_params(jparams, min_size=1)
    tq = model.params_from_numpy(jax.tree.map(np.asarray, jq), "cpu", torch.float32)
    mel = np.random.default_rng(0).standard_normal((2, 80, 3000)).astype(np.float32)
    ref = np.asarray(jmodel.encoder_forward(jq, jnp.asarray(mel), JDIMS, act8=True))
    out = model.encoder_forward(tq, _t(mel), DIMS, act8=True).numpy()
    w8a16 = model.encoder_forward(tq, _t(mel), DIMS).numpy()
    assert out.shape == ref.shape == (2, 1500, 64)
    assert np.abs(out - ref).max() < 0.05
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    a8_effect = np.linalg.norm(w8a16 - ref) / np.linalg.norm(ref)
    assert rel < 0.25 * a8_effect, (rel, a8_effect)
