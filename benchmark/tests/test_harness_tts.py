"""The TTS cell's own pieces on the CPU: the configuration's vocoder block,
the paragraph runner and its sample, the check's gap and its rank-swap rule
and its test of the draws, the arithmetic of the eight metrics
that read the TTS cell (on hand-made slices, calls and spans), and what
the new modules import."""

from __future__ import annotations

import subprocess
import sys
import types

import pytest
import torch

from benchmark import harness, trace
from benchmark.checks import qwen3_tts as check
from benchmark.generators import closed_loop_paragraphs as paragraphs
from benchmark.references.qwen3_tts import Dims
from benchmark.spans import Call
from benchmark.systems.qwen3_tts import LoopCall
from test_harness_imports import imported_tops
from test_harness_spans import Ring, _slice

CELL = "qwen3-tts-0.6b-w8a16.batch4"
YARDSTICK = ("references/qwen3_tts.py", "checks/qwen3_tts.py", "generators/closed_loop_paragraphs.py",
             "metrics/tts_frame_ms.batch4.py", "metrics/vocode_ms_per_audio_s.batch4.py",
             "metrics/tts_host_idle_ms.batch4.py", "metrics/w8a16_roofline.batch4.py", "metrics/mfu.batch4.py",
             "metrics/idle_share.batch4.py", "metrics/tts_frame_idle_ms.batch4.py",
             "metrics/graph_capture_ms.batch4.py")


def test_the_vocoder_block_is_qwen3_omni_code2wav():
    """The configuration's `speech_decoder` holds transformers'
    `Qwen3OmniMoeCode2WavConfig` defaults key for key (its `vocoder_source`),
    and the port's `Code2WavDims` defaults are the same numbers."""
    omni = pytest.importorskip("transformers.models.qwen3_omni_moe.configuration_qwen3_omni_moe")
    from whisperkit_tpu_torch.models.qwen3_tts import Code2WavDims

    config = harness.cell_of(CELL).config
    block = config["model"]["speech_decoder"]
    want = omni.Qwen3OmniMoeCode2WavConfig()
    assert "Qwen3OmniMoeCode2WavConfig" in config["vocoder_source"]
    for key, value in block.items():
        if key != "output_sample_rate":
            assert value == (list(getattr(want, key)) if isinstance(value, list) else getattr(want, key)), key
    port = Code2WavDims()
    assert (port.d_model, port.n_layer, port.n_head, port.n_kv_head, port.d_ff, port.sliding_window,
            port.decoder_dim, list(port.upsampling_ratios), list(port.upsample_rates)) == (
        block["hidden_size"], block["num_hidden_layers"], block["num_attention_heads"],
        block["num_key_value_heads"], block["intermediate_size"], block["sliding_window"], block["decoder_dim"],
        block["upsampling_ratios"], block["upsample_rates"])


@pytest.fixture(scope="module")
def dims():
    return Dims.of(harness.cell_of(CELL).config["model"])


def metric(name: str):
    return harness.module_at(harness.BENCH_DIR / "metrics" / f"{name}.py")


# --- the runner -------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 3_900_000_123])
def test_paragraphs_chunk_into_one_row_a_sentence(seed):
    """Four sentences of 120-190 characters, one period each; the port's
    sentence chunker (target 200, min 40) gives them back as four chunks."""
    from whisperkit_tpu_torch.pipelines.tts import TextChunker

    traffic = harness.cell_of(CELL).traffic
    runner = paragraphs.Runner(traffic, None, seed, 1.0)
    for stream in (runner.WINDOW, runner.WARMUP, runner.TRACE):
        for i in range(5):
            p = runner.paragraph(stream, i)
            assert len(p.sentences) == 4 and all(120 <= len(s) <= 190 and s.count(".") == 1 for s in p.sentences)
            assert TextChunker().chunk(p.text, 200, 40) == p.sentences
            assert 0 <= p.seed < 2**63 and p.seed == runner.paragraph(stream, i).seed
    assert runner.paragraph(0, 1).text != runner.paragraph(0, 2).text != runner.paragraph(1, 1).text


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_the_sample_holds_the_row_with_the_most_frames(seed):
    rows = [types.SimpleNamespace(size=n) for n in (245, 245, 17, 250, 100, 245, 3, 245)]
    runner = paragraphs.Runner({"sample_rows": 3}, None, seed, 1.0)
    picked = runner.cases(None, [rows[:4], rows[4:]], seed)
    assert len(picked) == 3 and rows[3] in picked and len({id(r) for r in picked}) == 3


# --- the check's gap -----------------------------------------------------------------


def _decision(top: list[float], v: int = 64, fill: float = -3.0):
    logits = torch.full((1, v), fill)
    logits[0, :len(top)] = torch.tensor(top)
    return logits


@pytest.mark.parametrize("width", [0.03, 0.2])
def test_two_tied_logits_swapped_read_under_the_ties_width(width):
    """The reference ranks a (5.0) over b (5.0 - width); the program's own
    rounding ranked b first, so b took rank 0's noise (0) and a rank 1's
    (3), and the program served a. With the reference's order b would win
    by 3 T - width, a wide plain gap; the tie lets a take rank 1 and b
    rank 0, and the gap reads under the tie's width."""
    t, k = 0.9, 4
    logits = _decision([5.0, 5.0 - width, 1.0, 0.5])
    noise = torch.tensor([[0.0, 3.0, -4.0, -4.0]])
    gap, out = check.gaps(logits, torch.tensor([0]), noise, t, k, tie=check.TIE)
    assert not out and gap.item() <= width
    plain, _ = check.gaps(logits, torch.tensor([0]), noise, t, k, tie=width / 2)
    assert plain.item() == pytest.approx(3 * t - width, rel=1e-5) and plain.item() > check.TIE


def test_a_swap_wider_than_the_tie_reads_its_full_gap():
    t, k = 0.9, 4
    logits = _decision([5.0, 4.0, 1.0, 0.5])
    noise = torch.tensor([[0.0, 3.0, -4.0, -4.0]])
    gap, _ = check.gaps(logits, torch.tensor([0]), noise, t, k)
    assert gap.item() == pytest.approx(t * ((4.0 / t + 3.0) - 5.0 / t), rel=1e-5)
    # the reference's own choice reads 0
    assert check.gaps(logits, torch.tensor([1]), noise, t, k)[0].item() == 0.0


def test_codes_outside_the_top_k_are_unmatched_unless_tied_with_the_kth():
    t, k = 0.9, 3
    logits = _decision([5.0, 4.0, 3.0, 3.0 - check.TIE / 2, 1.0])
    noise = torch.zeros((1, k))
    assert check.gaps(logits, torch.tensor([4]), noise, t, k)[1].item()
    gap, out = check.gaps(logits, torch.tensor([3]), noise, t, k)
    assert not out.item() and gap.item() == pytest.approx(5.0 - (3.0 - check.TIE / 2), rel=1e-5)


def test_greedy_gap_and_the_code0_rules():
    logits = _decision([2.0, 1.0, -1.0], v=3072)
    assert check.gaps(logits, torch.tensor([1]), None, 0.0, 50)[0].item() == pytest.approx(1.0)
    seen = check.code0_rules(logits.expand(3, -1).clone(), torch.tensor([0, 2]), 1.05)
    assert seen[0, 0] == 2.0 and seen[1, 0] == pytest.approx(2.0 / 1.05) and seen[2, 2] == pytest.approx(-1.05)
    assert torch.isinf(seen[:, 2048]).all() and torch.isinf(seen[:, 3071]).all() and torch.isfinite(seen[:, 2150]).all()


def test_draw_faults():
    """Uniform draws [frames, rows, width] pass; a row or a frame drawn
    twice, a value of 1, numbers squeezed or shifted fail; no draws fail
    only where the temperature asks for noise."""
    u = torch.rand((245, 4, 125), generator=torch.Generator().manual_seed(7)).numpy()
    assert check.draw_faults(u, 0.9) == []
    for bad in (lambda d: d.__setitem__((3, 1), d[3, 0]), lambda d: d.__setitem__((9, 2), d[8, 2]),
                lambda d: d.__setitem__((0, 0, 0), 1.0)):
        d = u.copy()
        bad(d)
        assert len(check.draw_faults(d, 0.9)) == 1
    assert check.draw_faults(0.25 + 0.5 * u, 0.9) and check.draw_faults(u * 0.98, 0.9)
    assert check.draw_faults(u[:0], 0.9) == ["no draws"] and check.draw_faults(u[:0], 0.0) == []


def test_prepare_counts_paragraphs_with_bad_draws():
    from benchmark.generators.closed_loop_paragraphs import Paragraph

    g = torch.Generator().manual_seed(3)
    answers = []
    for reuse in (False, True):
        draws = [torch.rand((2, 125), generator=g) for _ in range(20)]
        if reuse:
            draws[5] = draws[4]
        answers.append(types.SimpleNamespace(codes=torch.zeros((2, 20, 16), dtype=torch.int32),
                                             n_frames=torch.tensor([20, 20]), draws=draws, audio=None))
    items = [types.SimpleNamespace(answer=a, request=Paragraph(["A.", "B."], 1, {"temperature": 0.9}))
             for a in answers]
    per_item, counted = check.prepare(items, {})
    assert counted == {"draws_bad": 1} and [len(p) for p in per_item] == [2, 2]
    assert "draws_bad" in harness.cell_of(CELL).limits


def test_the_tie_is_the_limit_of_gap_max():
    assert check.TIE == harness.cell_of(CELL).limits["gap_max"]


# --- the metrics -----------------------------------------------------------------


def _run(dims, kernels, calls, trace_result=None, items=(), wall_s=1.0):
    """A run whose slice holds `kernels` (name, start us, end us, launched
    at us) and the benchmark's `calls`; host clock = trace clock in s."""
    sl = trace.Slice(sync=False)
    sl.kernels = [(name, s, e, i) for i, (name, s, e, _) in enumerate(kernels)]
    sl.launch_us = {i: at for i, (_, _, _, at) in enumerate(kernels)}
    sl.t0, sl.t1, sl._offsets = 0.0, 10.0, [0.0]
    run = types.SimpleNamespace(window=types.SimpleNamespace(trace=sl, trace_result=trace_result, items=list(items),
                                                             wall_s=wall_s), dims=dims)
    run.slice_calls = lambda kind: [c for c in calls if c.kind == kind]
    return run


def test_frame_and_vocoder_ms(dims):
    calls = [LoopCall("frames", 1.0, 3.0, 4, 250, 1), Call("vocode", 4.0, 5.0, 4, 245)]
    kernels = [("a", 1_100_000.0, 1_600_000.0, 1_050_000.0), ("b", 1_500_000.0, 2_000_000.0, 1_400_000.0),
               ("c", 4_100_000.0, 4_300_000.0, 4_050_000.0), ("d", 6_000_000.0, 7_000_000.0, 3_500_000.0)]
    run = _run(dims, kernels, calls)
    assert metric("tts_frame_ms.batch4").read(run) == pytest.approx(900.0 / 250)
    # 4 rows x 245 frames x 1920 samples at 24 kHz = 78.4 s of audio
    assert metric("vocode_ms_per_audio_s.batch4").read(run) == pytest.approx(200.0 / 78.4)
    none = _run(dims, kernels, [LoopCall("frames", 1.0, 3.0, 4, 0, 1)])
    assert metric("tts_frame_ms.batch4").read(none) is None and metric("w8a16_roofline.batch4").read(none) is None
    assert metric("vocode_ms_per_audio_s.batch4").read(none) is None


def test_w8a16_bound_at_published_widths(dims):
    """4 rows: the talker's q [1024, 2048] moves 2,097,152 codes + 4,096
    scale bytes + 8,192 of x + 16,384 of y; a layer's seven products
    15,933,440 bytes; 28 layers and the code0 head [1024, 3072]."""
    m = metric("w8a16_roofline.batch4")
    assert m.product_bound_s(4, 1024, 2048) == pytest.approx(2_125_824 / 3.35e12)
    talker = 28 * 15_933_440 + (3_145_728 + 6_144 + 8_192 + 24_576)
    assert m.talker_bound_s(dims, 4) == pytest.approx(talker / 3.35e12)
    # the code predictor's layer at 4 and 8 rows: x and y bytes double
    cp4 = 15_933_440
    cp8 = cp4 + 2 * 4 * (1024 + 2048 + 2 * (1024 + 1024) + 2048 + 1024 + 2 * (1024 + 3072) + 3072 + 1024)
    assert m.frame_bound_s(dims, 4) == pytest.approx((talker + 5 * cp8 + 14 * 5 * cp4) / 3.35e12)
    calls = [LoopCall("frames", 1.0, 3.0, 4, 10, 1), Call("vocode", 4.0, 5.0, 4, 245)]
    kernels = [("void w8a16_matmul_kernel<4>(Args)", 1_100_000.0, 1_101_000.0, 1_050_000.0),
               ("void w8a16_matmul_kernel<8>(Args)", 1_200_000.0, 1_203_000.0, 1_150_000.0),
               ("gemm", 1_300_000.0, 1_400_000.0, 1_250_000.0),
               ("void w8a16_matmul_kernel<4>(Args)", 4_100_000.0, 4_900_000.0, 4_050_000.0)]
    bound = m.talker_bound_s(dims, 4) + 10 * m.frame_bound_s(dims, 4)
    assert m.read(_run(dims, kernels, calls)) == pytest.approx(100.0 * bound / 4e-3)
    assert m.read(_run(dims, kernels[2:3], calls)) is None


def test_model_flops_at_published_widths(dims):
    m = metric("mfu.batch4")
    # the talker at position 0: 28 layers of q, k, v, out, gate, up, down and one key, then the code0 head
    assert m.talker_flops(dims, 0) == 28 * (2 * 1024 * 2048 + 4 * 1024 * 1024 + 2 * 2048 * 1024
                                            + 6 * 1024 * 3072 + 4 * 2048) + 2 * 1024 * 3072
    # the vocoder over one frame: the transformer at one position, then each conv stage
    transformer = 8 * (8 * 1024 * 1024 + 6 * 1024 * 3072 + 4 * 1024)
    convs = [2 * 1 * 1024 * 1024 * 2, 2 * 2 * 1024 * 7 + 4 * 2 * 1024 * 4096,  # x2 and its ConvNeXt at 2
             2 * 2 * 1024 * 1024 * 2, 2 * 4 * 1024 * 7 + 4 * 4 * 1024 * 4096,  # x2 and its ConvNeXt at 4
             2 * 4 * 1024 * 1536 * 7,  # conv in
             2 * 4 * 1536 * 768 * 16, 3 * 16 * 24 * 768 * 768,  # x8: 24 samples
             2 * 24 * 768 * 384 * 10, 3 * 16 * 115 * 384 * 384,  # x5: 115
             2 * 115 * 384 * 192 * 8, 3 * 16 * 456 * 192 * 192,  # x4: 456
             2 * 456 * 192 * 96 * 6, 3 * 16 * 1365 * 96 * 96,  # x3: 1365
             2 * 1365 * 96 * 7]  # conv out
    assert m.vocoder_flops(dims, 1) == pytest.approx(transformer + sum(convs), rel=1e-12)
    predictor = sum(5 * (2 * 1024 * 2048 + 4 * 1024 * 1024 + 2 * 2048 * 1024 + 6 * 1024 * 3072 + 4 * (j + 1) * 2048)
                    for j in range(16)) + 15 * 2 * 1024 * 2048
    assert m.predictor_flops(dims) == predictor
    row = m.talker_flops(dims, 30) + sum(m.talker_flops(dims, 31 + f) for f in range(3)) + 3 * predictor \
        + m.vocoder_flops(dims, 3)
    assert m.row_flops(dims, 3, 31, 1) == pytest.approx(row, rel=1e-12)
    answer = types.SimpleNamespace(n_frames=torch.tensor([3, 0]), prompt_len=31, prefilled=1)
    run = _run(dims, [], [], items=[types.SimpleNamespace(answer=answer)], wall_s=2.0)
    want = 100.0 * (row + m.row_flops(dims, 0, 31, 1)) / (2.0 * 989e12)
    assert m.read(run) == pytest.approx(want, rel=1e-12)


@pytest.fixture
def ring(monkeypatch):
    from whisperkit_tpu_torch.core import signposts

    r = Ring()
    monkeypatch.setattr(signposts, "spans_between", r.between)
    return r


def test_host_idle(dims, ring):
    """A traced paragraph over [0, 10] s: the device busy in [2, 6], [6.5, 8];
    the `tts` span [0.5, 9.5] less prefill, frames and vocode."""
    root = ring.add("tts", 0.5, 9.5, request=3)
    for name, a, b in (("tts.tokenize", 0.5, 1.5), ("tts.prefill", 1.5, 2.0), ("tts.frames", 2.0, 6.2),
                       ("readback", 6.2, 6.3), ("tts.vocode", 6.3, 6.6), ("readback", 6.6, 8.0),
                       ("tts.crossfade", 8.0, 9.0)):
        ring.add(name, a, b, parent=root, request=3)
    ring.add("tts.frames", 8.5, 9.0, request=4)  # another request's span leaves this paragraph's idle
    run = _run(dims, [], [])
    run.window.trace = _slice(0.0, 10.0, [(2.0, 6.0), (6.5, 8.0)])
    # idle inside [0.5, 1.5] (the prefill [1.5, 2] left out), [6.2, 6.3] (frames' [6, 6.2] left out), [8, 9.5]
    assert metric("tts_host_idle_ms.batch4").read(run) == pytest.approx(1e3 * (1.0 + 0.1 + 1.5))
    run.window.trace = None
    assert metric("tts_host_idle_ms.batch4").read(run) is None


def _answer(steps, t0=0.0, t1=0.0):
    return types.SimpleNamespace(answer=types.SimpleNamespace(steps=steps, t0=t0, t1=t1))


def test_idle_share_scales_the_traced_busy_to_the_window(dims):
    """The traced loop's busy [1.1, 2.0] s over 250 frames is 3.6 ms a
    frame; the rest of the slice's busy ([4.1, 4.3], [6, 7]) 1.2 s a
    paragraph; a window of 10 s held two paragraphs of 245 and 100 frames."""
    calls = [LoopCall("frames", 1.0, 3.0, 4, 250, 1), Call("vocode", 4.0, 5.0, 4, 245)]
    kernels = [("a", 1_100_000.0, 1_600_000.0, 1_050_000.0), ("b", 1_500_000.0, 2_000_000.0, 1_400_000.0),
               ("c", 4_100_000.0, 4_300_000.0, 4_050_000.0), ("d", 6_000_000.0, 7_000_000.0, 3_500_000.0)]
    run = _run(dims, kernels, calls, items=[_answer(245), _answer(100)], wall_s=10.0)
    assert metric("idle_share.batch4").read(run) == pytest.approx(100.0 * (1 - (0.0036 * 345 + 1.2 * 2) / 10.0))
    assert metric("idle_share.batch4").read(_run(dims, kernels, calls, items=[_answer(0)])) is None
    run.window.trace = None
    assert metric("idle_share.batch4").read(run) is None


def test_frame_idle_reads_the_untraced_wall_less_the_traced_busy(dims, ring):
    """Two window paragraphs: frame loops of 2.0 and 1.5 s, each with 0.3 s
    of eager first frame and capture, 101 and 61 frames: 2.9 s over 160
    replayed frames. The traced loop [2, 6.2] s, its set-up [2, 2.3], 401
    frames, the device busy in [2, 6], [6.5, 8]: 3.7 s over 400."""
    for t0, t1, frames in ((-20.0, -18.0, 101), (-15.0, -13.5, 61), (2.0, 6.2, 401)):
        f = ring.add("tts.frames", t0, t1, rows=4, frames=frames)
        ring.add("graph.warmup", t0, t0 + 0.1, parent=f)
        ring.add("graph.capture", t0 + 0.1, t0 + 0.3, parent=f)
        ring.add("tts.stop_check", t0 + 0.5, t0 + 0.6, parent=f, frame=16)
    run = _run(dims, [], [], items=[_answer(101, -21.0, -17.0), _answer(61, -16.0, -13.0)])
    run.window.trace = _slice(0.0, 10.0, [(2.0, 6.0), (6.5, 8.0)])
    m = metric("tts_frame_idle_ms.batch4")
    assert m.read(run) == pytest.approx(1e3 * (2.9 / 160 - 3.7 / 400))
    run.window.items = []
    assert m.read(run) is None


def test_graph_capture_ms_a_paragraph():
    m = metric("graph_capture_ms.batch4")
    run = types.SimpleNamespace(counters={"capture_s": 0.3, "instantiate_s": 0.06, "captures": 12})
    assert m.read(run) == pytest.approx(30.0)
    run.counters["captures"] = 0
    assert m.read(run) is None


# --- imports ------------------------------------------------------------------------


@pytest.mark.parametrize("path", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert not imported_tops(harness.BENCH_DIR / path) & {"whisperkit_tpu_torch", *harness.FORBIDDEN}


def test_a_tts_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.harness, benchmark.checks.qwen3_tts, benchmark.generators.closed_loop_paragraphs\n"
        "import benchmark.systems.qwen3_tts, benchmark.references.qwen3_tts\n"
        "import whisperkit_tpu_torch.pipelines.tts, whisperkit_tpu_torch.ops.quant\n"
        "print(benchmark.harness.forbidden_modules())\n" % str(harness.ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
