"""The PyTorch port's kernel modules against the JAX package, on the CPU.

Each wrapper in `whisperkit_tpu_torch/ops` runs its plain torch version for
a CPU tensor (its CUDA kernel is compared with that plain version on the
card by chip_smoke.py). Here the same numpy inputs go through the JAX
function — the Pallas kernel in interpret mode, or its jnp reference — and
through the port, at the tolerances the JAX package's own tests use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperkit_tpu.models.whisper import _attend_self_q8 as jax_attend_self_q8
from whisperkit_tpu.models.whisper import _q8_row_quantize as jax_q8_row_quantize
from whisperkit_tpu.models.whisper import _q8_rows as jax_q8_rows
from whisperkit_tpu.ops import attention_decode as jad
from whisperkit_tpu.ops import mel as jmel
from whisperkit_tpu.ops.attention import mha_encoder_pallas
from whisperkit_tpu_torch.models.whisper import _merge_heads, _q8_row_quantize, _split_heads
from whisperkit_tpu_torch.ops import _build, attention, attention_decode, mel
from whisperkit_tpu_torch.tools import decode_attn_check, k2_check
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# K1: log-mel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_bases_equal_jax(n_mels):
    np.testing.assert_array_equal(mel.mel_filters(n_mels), jmel.mel_filters(n_mels))
    for a, b in zip(mel._dft_window_matrices(), jmel._dft_window_matrices()):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def mel_audio():
    rng = np.random.default_rng(0)
    n = 400 * 160
    a = (rng.standard_normal((2, n)) * 0.1).astype(np.float32)
    a[1, n // 2 :] = 0.0  # a silent tail exercises the 1e-10 floor
    return a


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax_xla(mel_audio, n_mels):
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(mel_audio), n_mels=n_mels, n_frames=400))
    out = mel.log_mel_spectrogram(_t(mel_audio), n_mels=n_mels, n_frames=400).numpy()
    assert out.shape == ref.shape == (2, n_mels, 400)
    np.testing.assert_allclose(out, ref, atol=5e-5)


def test_log_mel_matches_jax_pallas_interpret(mel_audio):
    ref = np.asarray(
        jmel.log_mel_spectrogram_pallas(jnp.asarray(mel_audio), n_mels=80, n_frames=400)
    )
    out = mel.log_mel_spectrogram(_t(mel_audio), n_mels=80, n_frames=400).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-5)


def test_log_mel_single_window_and_raw_frames(mel_audio):
    """1-D input squeezes like the JAX version; `log_mel_frames` is the raw
    log10 output before the clamp and normalisation."""
    single = mel.log_mel_spectrogram(_t(mel_audio[0]), n_mels=80, n_frames=400)
    batch = mel.log_mel_spectrogram(_t(mel_audio), n_mels=80, n_frames=400)
    assert single.shape == (80, 400)
    torch.testing.assert_close(single, batch[0])
    raw = mel.log_mel_frames(_t(mel_audio), 80, 400)
    assert raw.shape == (2, 400, 80)
    assert float(raw.min()) >= -10.0


@pytest.mark.parametrize("ks, nt, lane", [(0, 0, 0), (7, 13, 22), (49, 50, 31), (49, 51, 5), (25, 1, 17)])
def test_dft_basis_fragments_hold_the_mma_b_fragments(ks, nt, lane):
    """Lane 4g + t of n-tile nt at k-step ks holds the basis at (sample
    8 ks + t, column g) and (8 ks + t + 4, g); n-tile 2G is the cos and
    2G + 1 the sin of frequencies 8G .. 8G + 7, zero past the 201st."""
    frags = mel.dft_basis_fragments()
    assert frags.shape == (50, 52, 32, 2) and frags.dtype == np.float32
    cos_m, sin_m = mel._dft_window_matrices()
    g, t = divmod(lane, 4)
    freq = 8 * (nt // 2) + g
    src = (cos_m, sin_m)[nt % 2]
    want = [src[8 * ks + t + d, freq] if freq < 201 else 0.0 for d in (0, 4)]
    np.testing.assert_array_equal(frags[ks, nt, lane], want)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_spans_cover_every_nonzero_filter_weight(n_mels):
    mel_w = mel.mel_filters(n_mels).T
    spans = mel.mel_spans(mel_w)
    rows = np.arange(mel_w.shape[0])[:, None]
    inside = (rows >= spans[:, 0]) & (rows < spans[:, 1])
    assert not mel_w[~inside].any()
    assert all(mel_w[lo, m] and mel_w[hi - 1, m] for m, (lo, hi) in enumerate(spans))
    power = np.random.default_rng(n_mels).random((5, mel_w.shape[0])).astype(np.float32)
    sparse = np.array([[p[lo:hi] @ mel_w[lo:hi, m] for m, (lo, hi) in enumerate(spans)] for p in power])
    np.testing.assert_allclose(sparse, power @ mel_w, rtol=1e-6)


def test_tf32_round_keeps_ten_mantissa_bits_ties_away_from_zero():
    ulp = 2.0**-10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 4, -(1 + ulp / 2), 1 + 3 * ulp / 4, 3.0e-30])
    r = mel.tf32_round(x)
    assert r[:5].tolist() == [1.0, 1 + ulp, 1.0, -(1 + ulp), 1 + ulp]
    assert not bool((r.view(torch.int32) & 0x1FFF).any())


@pytest.fixture(scope="module")
def k1_inputs():
    """Raw log10 mel against float64 on random and speech-like audio: the
    float32 plain version, the kernel's 3xTF32 numerics and plain TF32."""
    from whisperkit_tpu_torch.tools.workload import synth_speechlike_audio

    rng = np.random.default_rng(4)
    audio = {
        "random": _t((rng.standard_normal((2, 120_000)) * 0.1).astype(np.float32)),
        "speech-like": _t(synth_speechlike_audio(15.0, seed=2).reshape(2, 120_000)),
    }
    out = {}
    for name, a in audio.items():
        padded = mel._padded_rows(a, 750)
        exact = mel.log_mel_frames_reference(padded, 128, 750, torch.float64)
        forms = {
            "float32": mel.log_mel_frames_reference(padded, 128, 750),
            "3xtf32": mel.log_mel_frames_3xtf32(padded, 128, 750),
            "tf32": mel.log_mel_frames_3xtf32(padded, 128, 750, products=1),
        }
        out[name] = {
            k: (float((x - exact).abs().max()),
                float((mel.normalize_log_mel(x) - mel.normalize_log_mel(exact)).abs().max()))
            for k, x in forms.items()
        }
    return out


@pytest.mark.parametrize("audio", ["random", "speech-like"])
def test_log_mel_3xtf32_stays_within_the_checks_limit_and_tf32_does_not(k1_inputs, audio):
    """The precision argument of csrc/mel.cu, as chip_smoke.py checks the
    kernel: 3xTF32 within 16x the float32 plain version's error against
    float64 (raw and normalised), plain TF32 far outside it."""
    errs = k1_inputs[audio]
    assert all(e <= 16 * f for e, f in zip(errs["3xtf32"], errs["float32"])), errs
    assert all(e > 16 * f for e, f in zip(errs["tf32"], errs["float32"])), errs


def test_log_mel_3xtf32_matches_jax_xla(mel_audio):
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(mel_audio), n_mels=80, n_frames=400))
    out = mel.normalize_log_mel(mel.log_mel_frames_3xtf32(mel._padded_rows(_t(mel_audio), 400), 80, 400))
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5)


# ---------------------------------------------------------------------------
# K2: encoder attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [100, 1024, 1500])
def test_mha_encoder_matches_pallas_interpret(s):
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((1, 2, s, 64)).astype(np.float32) for _ in range(3))
    ref = np.asarray(mha_encoder_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=512))
    out = attention.mha_encoder(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_mha_encoder_bf16_keeps_rounding_points():
    """bf16: output dtype bf16, and within 1% of the f32 result (the same
    envelope the JAX bf16 kernel test allows)."""
    rng = np.random.default_rng(7)
    q, k, v = (_t(rng.standard_normal((1, 2, 160, 64)).astype(np.float32)) for _ in range(3))
    ref = attention.mha_encoder(q, k, v)
    out = attention.mha_encoder(*(t.to(torch.bfloat16) for t in (q, k, v)))
    assert out.dtype == torch.bfloat16
    rel = (out.float() - ref).abs().mean() / ref.abs().mean()
    assert float(rel) < 0.02


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_encoder_on_head_split_views_equals_contiguous(dtype):
    """The encoder passes the head-split views of its q/k/v projections,
    no copies: the same result as from contiguous copies."""
    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal((2, 150, 3 * 4 * 64)).astype(np.float32)).to(dtype)
    views = [_split_heads(x[..., i * 256 : (i + 1) * 256], 4) for i in range(3)]
    assert not views[0].is_contiguous()
    out = attention.mha_encoder(*views)
    ref = attention.mha_encoder(*(t.contiguous() for t in views))
    assert out.dtype == dtype
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_mha_encoder_returns_the_bshd_layout():
    """[B, H, S, 64] view of [B, S, H, 64] memory: merging the heads is a
    view, equal to merging the plain version's contiguous result."""
    rng = np.random.default_rng(12)
    q, k, v = (_t(rng.standard_normal((2, 3, 70, 64)).astype(np.float32)) for _ in range(3))
    out = attention.mha_encoder(q, k, v)
    assert out.shape == (2, 3, 70, 64)
    assert out.transpose(1, 2).is_contiguous()
    merged = _merge_heads(out)
    assert merged.data_ptr() == out.data_ptr() and merged.shape == (2, 70, 3 * 64)
    ref = attention.mha_encoder_reference(q, k, v)
    assert ref.is_contiguous()
    torch.testing.assert_close(merged, _merge_heads(ref), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K2's on-card check (tools/k2_check.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def k2_faults():
    g = torch.Generator().manual_seed(0)
    return k2_check.fault_table(*k2_check.check_inputs(1, 2, 1500, g, "cpu"))


def test_k2_limit_passes_the_tiled_algorithm(k2_faults):
    """The kernel's algorithm (rounding the unnormalised probability, one
    online softmax over tiles) stays within 2 bf16 ulps of each row's
    largest output of the plain version, on every row kind."""
    assert max(k2_faults["tiled"].values()) <= 1.0, k2_faults["tiled"]


@pytest.mark.parametrize(
    "fault, kind",
    [
        ("no_rescale", "peaked_last_tile"),
        ("skip_last_tile", "peaked_last_tile"),
        ("pad_scored_zero", "near_flat"),
        ("double_scale", "peaked_first_tile"),
        ("stale_stage", "peaked_last_tile"),
        ("stale_stage", "near_flat"),
    ],
)
def test_k2_limit_fails_each_fault(k2_faults, fault, kind):
    """Each altered form exceeds the limit on the row kind built to show it."""
    assert k2_faults[fault][kind] > 1.0, k2_faults[fault]


def test_k2_tiled_model_takes_the_kernels_tile_and_order():
    """The model runs the kernel's key tile (BLOCK_K) and ring depth: with
    no more key tiles than stages there is no earlier stage to read, so
    the stale-stage fault is the unaltered algorithm; with more it is not."""
    g = torch.Generator().manual_seed(2)
    q, k, v = k2_check.check_inputs(1, 2, attention.BLOCK_K * attention.STAGES - 28, g, "cpu")
    tiled = k2_check.mha_encoder_tiled(q, k, v)
    torch.testing.assert_close(tiled, k2_check.mha_encoder_tiled(q, k, v, attention.BLOCK_K), rtol=0, atol=0)
    torch.testing.assert_close(k2_check.mha_encoder_tiled(q, k, v, fault="stale_stage"), tiled, rtol=0, atol=0)
    assert float(k2_check.excess(tiled, attention.mha_encoder_reference(q, k, v)).max()) <= 1.0
    q, k, v = k2_check.check_inputs(1, 2, attention.BLOCK_K * (attention.STAGES + 1), g, "cpu")
    assert not torch.equal(k2_check.mha_encoder_tiled(q, k, v, fault="stale_stage"),
                           k2_check.mha_encoder_tiled(q, k, v))


def test_k2_check_inputs_put_the_max_where_each_row_kind_says():
    g = torch.Generator().manual_seed(1)
    q, k, _ = k2_check.check_inputs(1, 2, 1500, g, "cpu")
    scores = (q.float() / 8) @ k.float().transpose(-1, -2)
    top = scores.argmax(-1)[0]  # [H, S]
    rows = torch.arange(1500)
    assert bool((top[:, rows % 3 == 0] >= 1472).all())  # the ragged last 28 keys
    assert bool((top[:, rows % 3 == 1] < 64).all())
    assert float(scores[..., rows % 3 == 2, :].std()) < 1.0
    assert float(scores[..., rows % 3 == 0, :].std()) >= 3.0


def test_k2_row_limit_is_two_bf16_ulps():
    ref = torch.tensor([[0.75, -0.1], [1.0, 0.5], [-3.0, 2.0]])
    assert k2_check.row_limit(ref)[:, 0].tolist() == [2 * 2.0**-8, 2 * 2.0**-7, 2 * 2.0**-6]


# K2's tensor maps (ops/attention.py::tensor_map_args, the C side's encode_map)


def _projection_views(b, s, h):
    x = torch.zeros((b, s, 3 * h * 64), dtype=torch.bfloat16)
    return [_split_heads(x[..., i * h * 64 : (i + 1) * h * 64], h) for i in range(3)]


def test_tensor_map_args_of_the_head_split_views():
    """The encoder's q/k/v: head-split views of one [B, S, 3·H·64]
    projection, rows 3·H·64 elements apart, heads 64, batch rows S rows."""
    b, s, h = 2, 1500, 20
    for i, view in enumerate(_projection_views(b, s, h)):
        args = attention.tensor_map_args("q", view, attention.BLOCK_Q)
        assert args.dims == (64, s, h, b)
        assert args.strides == (3 * h * 64 * 2, 64 * 2, s * 3 * h * 64 * 2)
        assert args.box == (64, attention.BLOCK_Q, 1, 1)


def test_tensor_map_args_of_the_split_forms_query_rows_and_a_contiguous_tensor():
    """The sequence-parallel launch's q[:, :, 750:] (a base 750 rows in, one
    batch row: its stride is the packed one) and a contiguous tensor."""
    q = torch.zeros((1, 20, 1500, 64), dtype=torch.bfloat16)
    args = attention.tensor_map_args("q", q[:, :, 750:], attention.BLOCK_Q)
    assert args.dims == (64, 750, 20, 1)
    assert args.strides == (128, 1500 * 128, 20 * 1500 * 128)
    k = torch.zeros((2, 3, 70, 64), dtype=torch.bfloat16)
    args = attention.tensor_map_args("k", k, attention.BLOCK_K)
    assert args == attention.TensorMapArgs((64, 70, 3, 2), (128, 70 * 128, 3 * 70 * 128), (64, attention.BLOCK_K, 1, 1))


@pytest.mark.parametrize("layout, message", [
    ("odd_row_stride", "row stride of 130 bytes"),
    ("odd_head_stride", "head stride of 1288 bytes"),
    ("misaligned_base", "16-byte aligned"),
    ("head_dim_32", "head dimension must be 64"),
])
def test_tensor_map_args_refuse_what_tma_refuses(layout, message):
    """Strides that are not multiples of 16 bytes, a base off a 16-byte
    boundary, a head dim other than 64: TMA cannot load them, the wrapper
    raises before any launch (here through `_check_cuda` with the device
    checks stood aside, as on the card)."""
    if layout == "odd_row_stride":
        t = torch.zeros((1, 2, 10, 65), dtype=torch.bfloat16)[..., :64]
    elif layout == "odd_head_stride":
        t = torch.zeros(2000, dtype=torch.bfloat16).as_strided((1, 2, 10, 64), (0, 644, 64, 1))
    elif layout == "misaligned_base":
        t = torch.zeros(2 * 10 * 64 + 8, dtype=torch.bfloat16)[1 : 1 + 2 * 10 * 64].view(1, 2, 10, 64)
    else:
        t = torch.zeros((1, 2, 10, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=message):
        attention.tensor_map_args("k", t, attention.BLOCK_K)


def test_mha_encoder_wrapper_checks_the_tensor_maps(monkeypatch):
    """On CUDA tensors (the device checks stood aside) the bf16 wrapper
    holds q, k and v to TMA's layout rules; float32 keeps its own kernel's."""
    monkeypatch.setattr(_build, "check_cuda", lambda *_, **__: None)
    q, k, v = (torch.zeros((1, 2, 10, 64), dtype=torch.bfloat16) for _ in range(3))
    attention._check_cuda(q, k, v)
    bad = torch.zeros(2 * 10 * 64 + 8, dtype=torch.bfloat16)[1 : 1 + 2 * 10 * 64].view(1, 2, 10, 64)
    with pytest.raises(ValueError, match="v: the base must be 16-byte aligned"):
        attention._check_cuda(q, k, bad)
    f32 = [torch.zeros((1, 2, 10, 64)) for _ in range(3)]
    attention._check_cuda(*f32)


# ---------------------------------------------------------------------------
# K3: int8 cross-attention
# ---------------------------------------------------------------------------


def _q8_inputs(rng, b, h, t, s):
    qi = rng.integers(-127, 128, (b, h, t, 64), dtype=np.int8)
    q_scale = (rng.random((b, h, t, 1)) * 2e-5 + 1e-5).astype(np.float32)
    k = rng.integers(-127, 128, (b, h, s, 64), dtype=np.int8)
    v = rng.integers(-127, 128, (b, h, s, 64), dtype=np.int8)
    v_scale = (rng.random((b, h, 1, 64)) * 0.02 + 0.005).astype(np.float32)
    return qi, q_scale, k, v, v_scale


@pytest.mark.parametrize("t", [1, 3])
def test_cross_attend_q8_matches_jax_reference(t):
    rng = np.random.default_rng(10 + t)
    args = _q8_inputs(rng, 2, 3, t, 1500)
    ref = np.asarray(jad.cross_attend_q8_reference(*(jnp.asarray(a) for a in args)))
    out = attention_decode.cross_attend_q8(*(_t(a) for a in args)).numpy()
    # a ±1 flip of one requantized probability is allowed
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-4)


def test_cross_attend_q8_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    args = _q8_inputs(rng, 2, 2, 1, 300)
    ref = np.asarray(jad.cross_attend_q8_pallas(*(jnp.asarray(a) for a in args)))
    out = attention_decode.cross_attend_q8(*(_t(a) for a in args)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-4)


def test_int_dot_is_exact_past_float32():
    """The plain versions' integer dots must be exact where float32 is not
    (1500 · 127 · 127 > 2^24)."""
    a = torch.full((1, 1500), 127, dtype=torch.int8)
    b = torch.full((1500, 1), 127, dtype=torch.int8)
    b[0, 0] = 126
    exact = 1500 * 127 * 127 - 127
    assert int(attention_decode._int_dot(a, b)[0, 0]) == exact
    assert int((a.float() @ b.float())[0, 0]) != exact


# ---------------------------------------------------------------------------
# K4: T==1 self-attention over the cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 17, 39])
def test_self_attend_matches_pallas_interpret(cache_dtype, pos):
    rng = np.random.default_rng(pos)
    b, h, s = 2, 3, 40
    q = (rng.standard_normal((b, h, 1, 64)) * 0.125).astype(np.float32)
    k, v = (rng.standard_normal((b, h, s, 64)).astype(np.float32) for _ in range(2))
    mask = np.where(np.arange(s)[None, :] <= pos, 0.0, -np.inf).astype(np.float32)
    jdt = jnp.dtype(cache_dtype)
    ref = np.asarray(
        jad.self_attend_pallas(jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(mask))
    )
    tdt = getattr(torch, cache_dtype)
    out = attention_decode.self_attend(_t(q), _t(k).to(tdt), _t(v).to(tdt), _t(mask)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s, pos", [(8, 0), (8, 7), (40, 0), (40, 20), (40, 39), (227, 0), (227, 113), (227, 226)])
def test_self_attend_split_reference_matches_pallas_and_plain(cache_dtype, s, pos):
    """K4's split-key algorithm (the kernel's chunks, online softmax and
    merge) against the Pallas kernel in interpret mode and the plain
    version, at the kernel's limit of 1e-5: ragged S, S = 8 (the language
    probe), positions 0, mid and S - 1."""
    rng = np.random.default_rng(100 + s + pos)
    b, h = 2, 3
    q = (rng.standard_normal((b, h, 1, 64)) * 0.3).astype(np.float32)
    k, v = (rng.standard_normal((b, h, s, 64)).astype(np.float32) for _ in range(2))
    mask = np.where(np.arange(s)[None, :] <= pos, 0.0, -np.inf).astype(np.float32)
    jdt, tdt = jnp.dtype(cache_dtype), getattr(torch, cache_dtype)
    ref = np.asarray(
        jad.self_attend_pallas(jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(mask))
    )
    args = (_t(q), _t(k).to(tdt), _t(v).to(tdt), _t(mask))
    out = attention_decode.self_attend_split_reference(*args)
    assert out.shape == (b, h, 1, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), attention_decode.self_attend_reference(*args).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [1, 5, 32, 113, 224, 448])
def test_split_chunks_cover_the_visible_keys_in_equal_chunks(n):
    s = 448
    mask = torch.full((1, s), float("-inf"))
    mask[:, :n] = 0.0
    chunks = attention_decode.split_chunks(mask)
    assert chunks[0][0] == 0 and chunks[-1][1] == n
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(chunks, chunks[1:]))
    size = chunks[0][1] - chunks[0][0]
    assert size % 4 == 0 or len(chunks) == 1
    assert all(b - a == size for a, b in chunks[:-1]) and 0 < chunks[-1][1] - chunks[-1][0] <= size
    assert len(chunks) <= attention_decode.SPLIT_WARPS


def test_split_chunks_end_at_the_last_visible_key_of_any_mask():
    mask = torch.full((1, 64), float("-inf"))
    mask[:, [0, 9, 30]] = 0.0
    assert attention_decode.split_chunks(mask)[-1][1] == 31
    assert attention_decode.split_chunks(torch.full((1, 8), float("-inf"))) == []


def test_self_attend_split_reference_takes_any_mask_row():
    rng = np.random.default_rng(7)
    q = _t((rng.standard_normal((1, 2, 1, 64)) * 0.3).astype(np.float32))
    k, v = (_t(rng.standard_normal((1, 2, 50, 64)).astype(np.float32)) for _ in range(2))
    mask = torch.where(torch.from_numpy(rng.random((1, 50)) < 0.5), 0.0, float("-inf"))
    mask[0, 0], mask[0, 3] = 0.0, -1.5  # an additive term, not only 0 / -inf
    torch.testing.assert_close(attention_decode.self_attend_split_reference(q, k, v, mask),
                               attention_decode.self_attend_reference(q, k, v, mask), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# K4/K5's on-card check (tools/decode_attn_check.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def k4_faults():
    g = torch.Generator().manual_seed(0)
    return decode_attn_check.fault_table(
        [decode_attn_check.check_inputs(1, 6, 224, pos, g, "cpu") for pos in decode_attn_check.positions(224)]
    )


def test_k4_limit_passes_the_split_algorithm(k4_faults):
    assert decode_attn_check.worst(k4_faults["split"]) <= 1.0, k4_faults["split"]
    assert decode_attn_check.separates(k4_faults)


@pytest.mark.parametrize(
    "fault, pos, kind",
    [
        ("no_rescale", 223, "peaked_first_chunk"),
        ("no_rescale", 112, "near_flat"),
        ("drop_last_chunk", 223, "peaked_last_chunk"),
        ("drop_last_chunk", 112, "peaked_last_chunk"),
        ("masked_scored_zero", 112, "near_flat"),
        ("masked_scored_zero", 0, "near_flat"),
    ],
)
def test_k4_limit_fails_each_fault(k4_faults, fault, pos, kind):
    """Each altered form exceeds the limit where the inputs were built to
    show it (masked keys exist only before S - 1)."""
    assert k4_faults[fault][f"pos {pos}"][kind] > 1.0, k4_faults[fault]


@pytest.mark.parametrize("pos", [0, 112, 223])
def test_decode_check_inputs_put_the_max_where_each_row_kind_says(pos):
    g = torch.Generator().manual_seed(pos)
    q, k, _, mask = decode_attn_check.check_inputs(2, 6, 224, pos, g, "cpu")
    scores = (q @ k.float().transpose(-1, -2) + mask)[:, :, 0]  # [B, H, S]
    kinds = decode_attn_check.row_kinds(2, 6, "cpu")
    (first0, first1), (last0, last1) = attention_decode.split_chunks(mask)[0], attention_decode.split_chunks(mask)[-1]
    top = scores.argmax(-1)
    assert bool(((top >= last0) & (top < last1))[kinds == 0].all())
    assert bool(((top >= first0) & (top < first1))[kinds == 1].all())
    visible = scores[..., : pos + 1]
    if pos > 8:
        assert float(visible[kinds == 2].std()) < 1.0
        assert float(visible[kinds == 0].std()) >= 2.0


def test_decode_check_inputs_q8_leave_the_masked_rows_unwritten():
    g = torch.Generator().manual_seed(3)
    qi, q_scale, k8, ks, v8, vs, mask = args = decode_attn_check.check_inputs_q8(1, 3, 40, 17, g, "cpu")
    assert qi.dtype == k8.dtype == v8.dtype == torch.int8
    for t in (k8, ks, v8, vs):
        assert not bool(t[:, :, 18:].any()) and bool(t[:, :, :18].any())
    limit = decode_attn_check.q8_row_limit(args)
    assert limit.shape == (1, 3, 1, 1) and bool((limit > 0).all())
    out = attention_decode.self_attend_q8(*args)
    assert float(decode_attn_check.excess(out, attention_decode.self_attend_q8_reference(*args), limit).max()) == 0.0


def test_decode_check_excess_counts_nan_as_past_the_limit():
    out = torch.full((1, 1, 1, 4), float("nan"))
    assert decode_attn_check.excess(out, torch.zeros_like(out), 1e-5).item() == float("inf")


# ---------------------------------------------------------------------------
# K5: T==1 self-attention over the int8 cache
# ---------------------------------------------------------------------------


def _q8_cache(rng, b, h, s, pos):
    """A query and an int8 per-token-scale cache as the decode step sees
    them (the JAX test's recipe): rows after `pos` unwritten, all-zero with
    scale 0, and masked to -inf."""
    q = (rng.standard_normal((b, h, 1, 64)) * 0.3).astype(np.float32)
    written = (np.arange(s) <= pos)[None, None, :, None]
    cache = []
    for _ in range(2):
        x = (rng.standard_normal((b, h, s, 64)) * 0.5).astype(np.float32)
        q8, scale = (np.array(a) for a in jax_q8_rows(jnp.asarray(x)))
        cache += [q8 * written, (scale * written).astype(np.float32)]
    mask = np.where(np.arange(s)[None, :] <= pos, 0.0, -np.inf).astype(np.float32)
    return q, cache, mask


# K5's cache lengths and mask positions: S = 40 (ids kept from the first
# form of these tests), a length that is not a multiple of 4 (the kernel's
# scale rows are then not 16-byte aligned) and the longest the kernel
# takes, each at the on-card check's positions (0, 31, S/2, S - 1)
Q8_SHAPES = [
    pytest.param(40, 0, id="0"), pytest.param(40, 17, id="17"), pytest.param(40, 39, id="39"),
    *((s, pos) for s in (229, attention_decode.MAX_SELF_KEYS) for pos in decode_attn_check.positions(s)),
]


def _q8_seed(base, s, pos):
    return base + pos if s == 40 else [base, s, pos]


@pytest.mark.parametrize("s, pos", Q8_SHAPES)
def test_self_attend_q8_reference_matches_jax_attend_self_q8(s, pos):
    """The plain K5 on the port's row-quantized query against JAX's
    `_attend_self_q8` (which quantizes the query itself). A ±1 flip of one
    requantized probability is allowed (the JAX kernel-vs-einsum test's
    rtol 2e-2 / atol 2e-3)."""
    rng = np.random.default_rng(_q8_seed(20, s, pos))
    q, (k8, ks, v8, vs), mask = _q8_cache(rng, 2, 3, s, pos)
    ref = np.asarray(jax_attend_self_q8(
        jnp.asarray(q), {"q8": jnp.asarray(k8), "scale": jnp.asarray(ks)},
        {"q8": jnp.asarray(v8), "scale": jnp.asarray(vs)}, jnp.asarray(mask)[None, None],
    ))
    qi, q_scale = _q8_row_quantize(_t(q) * 64**-0.5)
    out = attention_decode.self_attend_q8(qi, q_scale, _t(k8), _t(ks), _t(v8), _t(vs), _t(mask))
    assert out.dtype == torch.float32 and out.shape == (2, 3, 1, 64)
    assert np.isfinite(ref).all()
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("s, pos", Q8_SHAPES)
def test_self_attend_q8_matches_pallas_interpret(s, pos):
    """The Pallas kernel in interpret mode and the port on the same int8
    inputs (tolerance as above)."""
    rng = np.random.default_rng(_q8_seed(30, s, pos))
    q, (k8, ks, v8, vs), mask = _q8_cache(rng, 2, 3, s, pos)
    qi, q_scale = (np.array(a) for a in jax_q8_row_quantize(jnp.asarray(q) * 64**-0.5))
    args = (qi, q_scale, k8, ks, v8, vs, mask)
    ref = np.asarray(jad.self_attend_q8_pallas(*(jnp.asarray(a) for a in args)))
    out = attention_decode.self_attend_q8(*(_t(a) for a in args)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("s", [224, 229])
def test_self_attend_q8_block_reference_matches_pallas_interpret(s):
    """K5's algorithm in plain torch (the exp sum in the kernel's order)
    against the Pallas kernel in interpret mode on the on-card check's
    inputs, each row within the check's limit (K5_FLIPS requantization
    flips), at every check position; NaN in the masked rows' scales
    changes nothing, as the kernel reads none of them."""
    g = torch.Generator().manual_seed(s)
    for pos in decode_attn_check.positions(s):
        args = decode_attn_check.check_inputs_q8(1, 6, s, pos, g, "cpu")
        ref = torch.from_numpy(np.array(jad.self_attend_q8_pallas(*(jnp.asarray(a.numpy()) for a in args))))
        out = attention_decode.self_attend_q8_block_reference(*args)
        ratio = decode_attn_check.excess(out, ref, decode_attn_check.q8_row_limit(args))
        assert float(ratio.max()) <= 1.0, (pos, ratio)
        qi, q_scale, k8, ks, v8, vs, mask = args
        ks, vs = ks.clone(), vs.clone()
        ks[:, :, pos + 1 :] = vs[:, :, pos + 1 :] = float("nan")
        assert torch.equal(attention_decode.self_attend_q8_block_reference(qi, q_scale, k8, ks, v8, vs, mask), out)


@pytest.fixture(scope="module")
def k5_faults():
    g = torch.Generator().manual_seed(1)
    return decode_attn_check.q8_fault_table(
        [decode_attn_check.check_inputs_q8(1, 6, 224, pos, g, "cpu") for pos in decode_attn_check.positions(224)]
    )


def test_k5_limit_passes_the_block_algorithm(k5_faults):
    assert decode_attn_check.worst(k5_faults["block"]) <= 1.0, k5_faults["block"]
    assert decode_attn_check.separates(k5_faults, "block")


@pytest.mark.parametrize(
    "fault, pos, kind",
    [
        ("drop_last_visible", 0, "near_flat"),
        ("drop_last_visible", 223, "near_flat"),
        ("masked_scored_zero", 31, "near_flat"),
        ("masked_scored_zero", 112, "near_flat"),
        ("p_scale_of_probs", 31, "peaked_first_chunk"),
        ("p_scale_of_probs", 223, "near_flat"),
    ],
)
def test_k5_limit_fails_each_fault(k5_faults, fault, pos, kind):
    """Each altered form of K5's algorithm exceeds the limit where the
    inputs were built to show it (masked keys exist only before S - 1)."""
    assert k5_faults[fault][f"pos {pos}"][kind] > 1.0, k5_faults[fault]


@pytest.mark.parametrize("s", [37, 224, 512])
def test_k5_block_sum_takes_the_kernels_order(s):
    """`_k5_block_sum` bit for bit against a scalar float32 walk of the
    kernel's reduction: thread t adds keys t, t + 256, ... in turn; the
    xor butterfly (16, 8, 4, 2, 1) over each warp's lanes; the same over
    the eight warps' sums, lanes 8-31 holding 0."""
    rng = np.random.default_rng(s)
    x = np.exp(rng.standard_normal(s) * 4).astype(np.float32)

    def butterfly(lanes):
        for off in (16, 8, 4, 2, 1):
            lanes = [np.float32(lanes[i] + lanes[i ^ off]) for i in range(32)]
        return lanes

    threads = [np.float32(0.0)] * 256
    for key in range(s):
        threads[key % 256] = np.float32(threads[key % 256] + x[key])
    warps = [butterfly(threads[32 * w : 32 * w + 32])[0] for w in range(8)]
    expected = butterfly(warps + [np.float32(0.0)] * 24)[0]
    got = attention_decode._k5_block_sum(torch.from_numpy(x)[None])
    assert got.shape == (1, 1) and got.dtype == torch.float32
    assert float(got[0, 0]) == float(expected)


@pytest.mark.parametrize("kernel", ["self_attend", "self_attend_q8"])
@pytest.mark.parametrize("fault, message", [("too_long", "at most 512 keys"), ("misaligned", "16-byte aligned")])
def test_self_attention_wrappers_raise_on_layouts_their_kernels_refuse(monkeypatch, kernel, fault, message):
    """On CUDA tensors (stood in here by objects that say so) K4's and K5's
    wrappers raise, before any launch, for a cache longer than
    MAX_SELF_KEYS and for K/V data that is not 16-byte aligned: their
    kernels stage rows in shared memory, K5's by bulk copies."""

    class Stand:
        is_cuda = True
        device = "cuda"

        def __init__(self, shape, dtype, misaligned=False):
            self.shape, self.dtype, self.misaligned = torch.Size(shape), dtype, misaligned

        def data_ptr(self):
            return 8 if self.misaligned else 256

    def launched(*_):
        raise AssertionError("launched")

    monkeypatch.setattr(_build, "check_cuda", lambda *_, **__: None)
    monkeypatch.setattr(_build, "launch", launched)
    s = attention_decode.MAX_SELF_KEYS + (4 if fault == "too_long" else 0)
    bad = fault == "misaligned"
    mask = Stand((1, s), torch.float32)
    if kernel == "self_attend":
        args = (Stand((2, 3, 1, 64), torch.float32), Stand((2, 3, s, 64), torch.bfloat16, bad),
                Stand((2, 3, s, 64), torch.bfloat16), mask)
    else:
        args = (Stand((2, 3, 1, 64), torch.int8), Stand((2, 3, 1, 1), torch.float32),
                Stand((2, 3, s, 64), torch.int8, bad), Stand((2, 3, s, 1), torch.float32),
                Stand((2, 3, s, 64), torch.int8), Stand((2, 3, s, 1), torch.float32), mask)
    with pytest.raises(ValueError, match=message):
        getattr(attention_decode, kernel)(*args)


def test_self_attend_q8_integer_dots_are_exact_in_float32():
    """The plain K5 runs its integer dots in float32: exact, since the
    largest sums (64 · 127² for the scores, 448 · 127² for P·V) stay below
    2^24. All-127 codes with unit scales and one visible key make both
    dots hit their bounds."""
    s = 448
    qi = torch.full((1, 1, 1, 64), 127, dtype=torch.int8)
    k = torch.full((1, 1, s, 64), -127, dtype=torch.int8)
    v = torch.full((1, 1, s, 64), 127, dtype=torch.int8)
    ones = torch.ones((1, 1, s, 1))
    mask = torch.zeros((1, s))  # every key visible: equal scores, equal probs
    out = attention_decode.self_attend_q8_reference(qi, torch.ones((1, 1, 1, 1)), k, ones, v, ones, mask)
    # probs 1/448 each → p_scale 1/(448·127), pi = 127 each → P·V = 448 · 127²
    assert 448 * 127 * 127 < 2**24
    expected = np.float32(448 * 127 * 127) * np.float32(max((1 / 448) / 127, 1e-8))
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-6)
    scores = qi.float() @ k.float().transpose(-1, -2)
    assert int(scores[0, 0, 0, 0]) == -64 * 127 * 127


# ---------------------------------------------------------------------------
# the shared int8 row quantization
# ---------------------------------------------------------------------------


def test_q8_row_quantize_matches_jax():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 20, 3, 64)) * 3).astype(np.float32)
    qj, sj = jax_q8_row_quantize(jnp.asarray(x))
    qt, st = _q8_row_quantize(_t(x))
    assert qt.dtype == torch.int8
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    diff = np.abs(qt.numpy().astype(np.int32) - np.asarray(qj).astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def test_q8_row_quantize_rounds_half_to_even():
    x = torch.tensor([[127.0, 2.5, -2.5, 3.5, 0.5]])
    q, scale = _q8_row_quantize(x)
    assert float(scale) == 1.0
    assert q.tolist() == [[127, 2, -2, 4, 0]]


# ---------------------------------------------------------------------------
# wrappers and the build helper
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    _build.reset_launches()
    rng = np.random.default_rng(1)
    q, k, v = (_t(rng.standard_normal((1, 1, 8, 64)).astype(np.float32)) for _ in range(3))
    attention.mha_encoder(q, k, v)
    mask = torch.zeros((1, 8))
    attention_decode.self_attend(q[:, :, :1], k, v, mask)
    args = _q8_inputs(rng, 1, 1, 1, 8)
    attention_decode.cross_attend_q8(*(_t(a) for a in args))
    _, cache, mask8 = _q8_cache(rng, 1, 1, 8, 3)
    attention_decode.self_attend_q8(_t(args[0]), _t(args[1]), *(_t(a) for a in cache), _t(mask8))
    mel.log_mel_frames(torch.zeros((1, 4000)), 80, 20)
    assert _build.launches == dict.fromkeys(_build.KERNELS, 0)


def test_check_cuda_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_cuda("x", torch.zeros(2), torch.float32, 1)


def test_library_path_follows_the_sources():
    path = _build._library_path()
    assert path.parent == _build.BUILD_DIR
    assert path == _build._library_path()
    assert {p.name for p in _build._sources()} == {
        "attention_decode.cu", "mel.cu", "mha_encoder.cu", "qwen3_decode.cu", "tp_all_reduce.cu", "w8a16_matmul.cu"}
