#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`whisperkit_tpu_torch`) once on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

  1. the card: name, count, and `nvidia-smi` name + power limit
  2. build the hand-written kernels (csrc/*.cu) with nvcc for sm_90a
  3. each kernel against its plain torch version at the main path's
     shapes: max abs error, tolerance, CUDA-event times
  4. the main path: WhisperPipeline.transcribe on large-v3 (random bf16
     weights from the port's init_params(seed=0)), ComputeOptions.serving()
     (int8 cross-KV), bench.pipeline_options(32), 10 minutes of synthetic
     speech-like audio; launch counts, wall time, RTF, tokens/s, peak memory
  5. one decoder step after prefill at large-v3 width, through the kernels
     and through the plain versions, on the same weights and inputs

The line before last is a JSON object with one entry per kernel; the last
line is the JSON result {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
AUDIO_SECONDS = 600.0
GROUP = 32


def fail(message: str) -> None:
    print(f"FAIL: {message}", flush=True)
    sys.exit(1)


def say(line: str) -> None:
    print(line, flush=True)


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean CUDA-event time of `fn(i)` over `iters` launches, after one
    warm-up call."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_card(torch) -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"phase 1 card: {name} | count {count} | cuda {torch.version.cuda} | torch {torch.__version__}")
    return name, card


def phase_build() -> None:
    from whisperkit_tpu_torch.ops import _build

    res = _build.build(force=True)
    _build.library()
    say(f"phase 2 build: {len(_build._sources())} sources -> {res.path.name} in {res.seconds:.1f} s")
    for line in res.log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            say(f"  {line.strip()}")


def phase_kernels(torch, card: str) -> dict:
    """Kernel vs plain version at the main path's shapes."""
    from whisperkit_tpu_torch.ops import attention, attention_decode, mel

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    results = {}

    def record(key, err, tol, ms, plain_ms, extra=""):
        if not err <= tol:
            fail(f"{key}: max abs error {err:.3e} > tolerance {tol:.3e}")
        results[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        say(
            f"phase 3 {key}: max_abs_err {err:.3e} (tol {tol:.1e}) | kernel {ms:.4f} ms"
            f" | plain {plain_ms:.4f} ms{extra} | {card}"
        )

    # K1: log-mel, 32 windows of 30 s, n_mels 128 (large-v3)
    audio = [torch.randn((GROUP, 480_000), generator=g, device=dev) * 0.1 for _ in range(2)]
    padded = [mel._padded_rows(a, mel.N_FRAMES) for a in audio]
    out = mel.log_mel_frames(audio[0], 128)
    ref = mel.log_mel_frames_reference(padded[0], 128, mel.N_FRAMES)
    # both float32 with another summation order; 2e-4 in log10 units is
    # the JAX kernel-vs-XLA test's 5e-5 after the (x + 4) / 4 normalisation
    err = max_abs(torch, out, ref)
    ms = cuda_ms(torch, lambda i: mel.log_mel_frames(audio[i % 2], 128), 20)
    plain = cuda_ms(torch, lambda i: mel.log_mel_frames_reference(padded[i % 2], 128, mel.N_FRAMES), 20)
    record("log_mel", err, 2e-4, ms, plain, " | B=32 n_mels=128")

    # K2: encoder attention, B=2 H=20 S=1500 Dh=64, f32 and bf16
    shape = (2, 20, 1500, 64)
    qkv = [torch.randn(shape, generator=g, device=dev) for _ in range(3)]
    out = attention.mha_encoder(*qkv)
    ref = attention.mha_encoder_reference(*qkv)
    err32 = max_abs(torch, out, ref)
    ms = cuda_ms(torch, lambda i: attention.mha_encoder(*qkv), 10)
    plain = cuda_ms(torch, lambda i: attention.mha_encoder_reference(*qkv), 10)
    say(f"phase 3 mha_encoder f32: max_abs_err {err32:.3e} (tol 2.0e-05) | kernel {ms:.4f} ms"
        f" | plain {plain:.4f} ms | f32 B=2 | {card}")
    if not err32 <= 2e-5:
        fail(f"mha_encoder f32: max abs error {err32:.3e} > 2e-5")
    qkv16 = [t.to(torch.bfloat16) for t in qkv]
    out = attention.mha_encoder(*qkv16)
    ref = attention.mha_encoder_reference(*qkv16)
    err = max_abs(torch, out, ref)
    # bf16 output: two bf16 ulps at the largest output magnitude
    tol = 2.0 ** -7 * float(ref.float().abs().max())
    ms = cuda_ms(torch, lambda i: attention.mha_encoder(*qkv16), 10)
    plain = cuda_ms(torch, lambda i: attention.mha_encoder_reference(*qkv16), 10)
    big = [torch.randn((GROUP, 20, 1500, 64), generator=g, device=dev).to(torch.bfloat16) for _ in range(3)]
    ms32 = cuda_ms(torch, lambda i: attention.mha_encoder(*big), 3)
    del big
    record("mha_encoder", err, tol, ms, plain, f" | bf16 B=2 (kernel at B=32: {ms32:.3f} ms)")

    # K3: int8 cross-attention, B=32 H=20 S=1500, one query row; two
    # K/V sets (246 MB) so every launch reads from device memory, not L2
    b, h, s = GROUP, 20, 1500

    def q8_inputs(t):
        qi = torch.randint(-127, 128, (b, h, t, 64), generator=g, device=dev, dtype=torch.int8)
        # scores ~ N(0, 1): |qi . k| ~ 8 * 127 * 73
        q_scale = torch.rand((b, h, t, 1), generator=g, device=dev) * 2e-5 + 1e-5
        return qi, q_scale

    kv = [
        tuple(torch.randint(-127, 128, (b, h, s, 64), generator=g, device=dev, dtype=torch.int8) for _ in range(2))
        for _ in range(2)
    ]
    v_scale = torch.rand((b, h, 1, 64), generator=g, device=dev) * 0.02 + 0.005
    # ±1 flips of the probability requantization (another exp and sum
    # order) are allowed, as in the CPU parity test
    errs = []
    for t in (1, 3):
        qi, q_scale = q8_inputs(t)
        out = attention_decode.cross_attend_q8(qi, q_scale, *kv[0], v_scale)
        ref = attention_decode.cross_attend_q8_reference(qi, q_scale, *kv[0], v_scale)
        if not torch.allclose(out, ref, rtol=2e-3, atol=2e-4):
            fail(f"cross_attend_q8 T={t}: not within rtol 2e-3 / atol 2e-4 (max abs {max_abs(torch, out, ref):.3e})")
        errs.append(max_abs(torch, out, ref))
    qi, q_scale = q8_inputs(1)
    ms = cuda_ms(torch, lambda i: attention_decode.cross_attend_q8(qi, q_scale, *kv[i % 2], v_scale), 20)
    plain = cuda_ms(torch, lambda i: attention_decode.cross_attend_q8_reference(qi, q_scale, *kv[i % 2], v_scale), 5)
    del kv
    record("cross_attend_q8", max(errs), 2e-4 + 2e-3 * float(ref.abs().max()), ms, plain,
           " | B=32 S=1500 T=1 (T=3 checked too)")

    # K4: self-attention over the bf16 cache, B=32 H=20, S = prompt (3) +
    # 224; four cache sets (149 MB) rotate so launches read device memory
    s = 3 + 224
    caches = [
        tuple(torch.randn((b, h, s, 64), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
        for _ in range(4)
    ]
    q = torch.randn((b, h, 1, 64), generator=g, device=dev) * 0.125
    errs = []
    for pos in (s // 2, s - 1):
        mask_row = torch.zeros((1, s), device=dev)
        mask_row[:, pos + 1 :] = float("-inf")
        out = attention_decode.self_attend(q, *caches[0], mask_row)
        ref = attention_decode.self_attend_reference(q, *caches[0], mask_row)
        errs.append(max_abs(torch, out, ref))
    # float32 throughout, another summation order
    ms = cuda_ms(torch, lambda i: attention_decode.self_attend(q, *caches[i % 4], mask_row), 50)
    plain = cuda_ms(torch, lambda i: attention_decode.self_attend_reference(q, *caches[i % 4], mask_row), 50)
    record("self_attend", max(errs), 1e-5, ms, plain, f" | bf16 cache B=32 S={s} pos {s // 2} and {s - 1}")
    return results


def phase_main_path(torch, card: str) -> dict:
    import bench
    from whisperkit_tpu.core.configurations import ComputeOptions, WhisperConfig
    from whisperkit_tpu_torch.models.whisper import VARIANT_DIMS, init_params
    from whisperkit_tpu_torch.ops import _build
    from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline

    dims = VARIANT_DIMS["large-v3"]
    t0 = time.perf_counter()
    params = init_params(SEED, dims, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    pipe = WhisperPipeline(
        WhisperConfig(compute_options=ComputeOptions.serving(), load=False),
        dims=dims, params=params, device="cuda",
    )
    audio = bench.synth_speechlike_audio(AUDIO_SECONDS)
    options = bench.pipeline_options(GROUP)

    windows = []

    def on_window(progress):
        windows.append(list(progress.tokens))

    warm = time.perf_counter()
    pipe.transcribe(audio, options)
    torch.cuda.synchronize()
    warm = time.perf_counter() - warm

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    result = pipe.transcribe(audio, options, callback=on_window)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()

    n_chunks = len(pipe._vad_chunks(audio, options))
    if any(counts[k] <= 0 for k in counts):
        fail(f"main path skipped a kernel: launches {counts}")
    for k in ("cross_attend_q8", "self_attend"):
        if counts[k] % dims.n_text_layer:
            fail(f"{k} launched {counts[k]} times, not a multiple of {dims.n_text_layer} layers")
    if len(windows) != n_chunks or not all(windows):
        fail(f"{n_chunks} VAD chunks but {len(windows)} decoded windows, "
             f"{sum(1 for w in windows if not w)} without tokens")
    segs = result.segments
    if not segs:
        fail("no segments")
    # windows come in time order (by seek); inside a window, timestamps
    # increase and lie within its 30 s (random-init text may run past the
    # chunk's speech into the next chunk's time)
    keys = [(s.seek, s.start) for s in segs]
    if keys != sorted(keys) or any(
        not (s.seek / 100.0 <= s.start <= s.end <= s.seek / 100.0 + 30.0) for s in segs
    ):
        fail("segment timestamps are not increasing and in range")
    timings = result.timings
    say(
        f"phase 4 main path: large-v3 bf16 serving, {AUDIO_SECONDS:.0f} s audio, {n_chunks} VAD chunks, "
        f"{len(segs)} segments | wall {wall:.3f} s (first run {warm:.3f} s, init_params {t_init:.1f} s) "
        f"| RTF {wall / AUDIO_SECONDS:.6f} | {timings.tokens_per_second:.1f} tok/s "
        f"| peak {peak / 2**30:.2f} GiB | launches {json.dumps(counts)} | {card}"
    )
    say(
        f"  stages (host clock, no stage sync): mel {timings.log_mels:.3f} s, encode "
        f"{timings.encoding:.3f} s, prefill {timings.prefill:.3f} s, decode loop "
        f"{timings.decoding_loop:.3f} s, windowing {timings.decoding_windowing:.3f} s"
    )
    return {"counts": counts, "pipe": pipe, "audio": audio}


def phase_step_parity(torch, pipe, audio) -> None:
    """One decoder step after prefill at large-v3 width: kernels vs plain."""
    from unittest import mock

    from whisperkit_tpu_torch.decoding.loop import encode_window, prefill_window
    from whisperkit_tpu_torch.models import whisper as model
    from whisperkit_tpu_torch.ops import attention_decode as ad

    dims, params, sp = pipe.dims, pipe.params, pipe.tokenizer.special
    mel = pipe._mel_batch([audio[i * 480_000 : (i + 1) * 480_000] for i in range(4)])
    _, ck, cv = encode_window(params, mel, dims, quantize_kv=True)
    prompt = torch.tensor([[sp.sot, sp.language_token("en"), sp.transcribe]] * 4, device=pipe.device)
    token = torch.full((4, 1), sp.timestamp_begin, device=pipe.device)

    def step():
        pre = prefill_window(params, ck, cv, prompt, dims=dims, special=sp, sample_begin=3,
                             max_new_tokens=224, sot_index=0)
        with torch.inference_mode():
            return model.decoder_forward(params, token, 3, pre.kv_k, pre.kv_v, ck, cv, dims)[:, -1]

    kernel_logits = step()
    with mock.patch.object(model, "self_attend", ad.self_attend_reference), \
            mock.patch.object(model, "cross_attend_q8", ad.cross_attend_q8_reference):
        plain_logits = step()
    err = max_abs(torch, kernel_logits, plain_logits)
    scale = float(plain_logits.abs().max())
    # bf16 activations through 32 layers: the two runs round at different
    # points (f32 vs bf16 scores, ±1 int8 requantization flips)
    tol = 2.0 ** -4 * scale
    # a row may pick another token only where the plain top-2 gap is within
    # what the two runs' logits can differ by
    top2 = plain_logits.float().topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    same = (kernel_logits.argmax(-1) == plain_logits.argmax(-1)).tolist()
    say(f"phase 5 decoder step: max |Δlogit| {err:.3e} (tol {tol:.3e}, max |logit| {scale:.3f}) "
        f"| argmax equal per row {same}, plain top-2 gaps {[round(g, 4) for g in gaps]}")
    if not err <= tol:
        fail(f"decoder step logits differ by {err:.3e} > {tol:.3e}")
    if any(not eq and gap > 2 * err for eq, gap in zip(same, gaps)):
        fail("a decoder step picked another token where the top-2 gap exceeds the logit error")


KERNEL_TABLE = (
    ("log_mel", "whisperkit_tpu_torch/csrc/mel.cu", "whisperkit_tpu/ops/mel.py:227"),
    ("mha_encoder", "whisperkit_tpu_torch/csrc/mha_encoder.cu", "whisperkit_tpu/ops/attention.py:85"),
    ("cross_attend_q8", "whisperkit_tpu_torch/csrc/attention_decode.cu", "whisperkit_tpu/ops/attention_decode.py:81"),
    ("self_attend", "whisperkit_tpu_torch/csrc/attention_decode.cu", "whisperkit_tpu/ops/attention_decode.py:191"),
)


def main() -> None:
    if not (REPO / "whisperkit_tpu_torch").is_dir():
        fail("whisperkit_tpu_torch/ is not beside chip_smoke.py; run from a checkout of the repo")
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, card = phase_card(torch)
    phase_build()
    kernel_results = phase_kernels(torch, card)
    main_path = phase_main_path(torch, card)
    phase_step_parity(torch, main_path["pipe"], main_path["audio"])

    kernels = [
        {
            "name": key, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_path["counts"][key], **kernel_results[key],
        }
        for key, source, replaces in KERNEL_TABLE
    ]
    say(f"card: {card}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        print("FAIL: unhandled exception", flush=True)
        sys.exit(1)
