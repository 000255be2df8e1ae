#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`whisperkit_tpu_torch`) once on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

  1. the card: name, count, and `nvidia-smi` name + power limit
  2. build the hand-written kernels (csrc/*.cu) with nvcc for sm_90a, one
     nvcc per source, all started together
  3. each kernel against its plain torch version at the main paths'
     shapes: max abs error, tolerance, CUDA-event times of the kernel, its
     plain version and, where one PyTorch call computes the same function,
     that call (K2 and K4: F.scaled_dot_product_attention, never called by
     the port), and the least time the card could take (`bound_ms`); K1
     also against its plain version in float64 on random and speech-like
     audio; K4/K5 per row on the check inputs of
     tools/decode_attn_check.py. In a process of its own (this script run
     with TIMES_ARG): K4, K5 and SDPA timed at the main path's cache length
     S = 224 with the mask open to S/2 and to S - 1, by CUDA events with
     the host's time per call, then K1, K4, K5 and SDPA by device time
     from `torch.profiler` traces. Once a profiler session has run, every
     later launch of its process costs the host more
     (whisperkit_tpu_torch/tools/launch_cost.py), which moved phases 4-8's
     walls by seconds when the traces ran in this process
  4. the bf16 path: WhisperPipeline.transcribe on large-v3 (random bf16
     weights from the port's init_params(seed=0)), ComputeOptions.serving()
     (int8 cross-KV), tools.workload.pipeline_options(32), 10 minutes of
     synthetic speech-like audio (tools.workload.synth_speechlike_audio);
     launch counts, wall time, RTF, tokens/s, peak memory
  5. one decoder step after prefill at large-v3 width over the bf16 cache,
     through the kernels and through the plain versions
  6. the int8 path: the phase-4 weights quantized to W8A16 on the card,
     ComputeOptions.serving(quantization="w8a16", quantize_self_kv=True),
     the same audio and options; the same figures, and the weight bytes
  7. phase 5 over the int8 self-KV cache with the W8A16 weights
  8. W4A16 and W8A8: one transcribe each on 60 s of the audio, and the
     encoder of 4 windows timed with W8A16 and with W8A8 (int8 activations)

Each path's kernels must all launch between the counts' reset just before
it and their reading just after it. The line before last is a JSON object
with one entry per kernel; the last line is the JSON result
{"ok": true, "device": {...}}.
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
# published dense peaks of one H100 SXM (the bound of each kernel)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12}
AUDIO_SECONDS = 600.0
GROUP = 32
# the argument that runs phase 3's timing process (`traced_times`)
TIMES_ARG = "--traced-times"


def fail(message: str) -> None:
    print(f"FAIL: {message}", flush=True)
    sys.exit(1)


def say(line: str) -> None:
    print(line, flush=True)


def _timed_loop(torch, fn, iters: int) -> tuple[float, float]:
    """(mean CUDA-event ms, mean host seconds to issue) of `fn(i)` over
    `iters` back-to-back calls after one warm-up call; the host clock stops
    before the closing sync."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host / iters


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean CUDA-event time of `fn(i)` over `iters` launches, after one
    warm-up call."""
    return _timed_loop(torch, fn, iters)[0]


def device_ms(torch, fn, iters: int, kernel: str | None = None) -> float:
    """Mean device time per call of `fn(i)` over `iters` calls, from the
    device activities of a `torch.profiler` (CUPTI) trace: those whose name
    holds `kernel`, which must run once per call, or with no `kernel` every
    device activity of the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    for _ in range(3):  # a trace may come back short of activities: take another
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kernel is not None:
            events = [e for e in events if kernel in e.name]
        if events and (kernel is None or len(events) == iters):
            return sum(e.time_range.end - e.time_range.start for e in events) / 1e3 / iters
    fail(f"three traces of {iters} calls held {len(events)} device activities"
         + (f" named {kernel!r}" if kernel else ""))


def launch_times(torch, fn, iters: int, traces: list, kernel: str | None = None) -> dict:
    """A call's CUDA-event time (`ms`) and the host's time to issue it
    (`host_us`) over `iters` back-to-back calls (`_timed_loop`); its device
    time (`device_ms`) joins the dict once `traced_times` has run the trace
    queued in `traces`."""
    ms, host = _timed_loop(torch, fn, iters)
    times = {"ms": ms, "host_us": host * 1e6}
    traces.append((times, fn, iters, kernel))
    return times


def max_abs(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(bytes_moved: float, ops: float | dict = 0.0, kind: str = "bf16") -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type
    (`ops` may map each type to its count)."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_FLOPS[k] for k, n in (ops if isinstance(ops, dict) else {kind: ops}).items()) * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
    say(f"phase 2 build: {len(_build._sources())} sources, one nvcc each, -> {res.path.name} "
        f"in {res.seconds:.1f} s")
    for line in res.log.splitlines():
        if ("ptxas info" in line and ("Used" in line or "Compiling" in line)) or "spill" in line:
            say(f"  {line.strip()}")


def record(results: dict, card: str, key, err, tol, ms, plain_ms, bound_info, library_ms=None, extra="",
           **more) -> None:
    """Fail unless `err` is within `tol`; keep and print the kernel's figures."""
    if not err <= tol:
        fail(f"{key}: max abs error {err:.3e} > tolerance {tol:.3e}")
    results[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound_info,
                    "library_ms": library_ms, **more}
    lib = f" | library {library_ms:.4f} ms" if library_ms is not None else ""
    say(
        f"phase 3 {key}: max_abs_err {err:.3e} (tol {tol:.1e}) | kernel {ms:.4f} ms"
        f" | plain {plain_ms:.4f} ms{lib} | bound {bound_info['bound_ms']:.4f} ms"
        f" ({bound_info['bound_by']}, {100 * bound_info['bound_ms'] / ms:.1f}% of it){extra} | {card}"
    )


def phase_kernels(torch, card: str) -> dict:
    """Kernel vs plain version at the main path's shapes; K4's and K5's
    times, and every device time, come from `phase_traced_times`."""
    from whisperkit_tpu_torch.ops import attention_decode, mel

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    results = {}

    # K1: log-mel, 32 windows of 30 s, n_mels 128 (large-v3)
    audio = [torch.randn((GROUP, 480_000), generator=g, device=dev) * 0.1 for _ in range(2)]
    err, tol, extra = check_log_mel(torch, audio[0], dev, card)
    padded = [mel._padded_rows(a, mel.N_FRAMES) for a in audio]
    ms = cuda_ms(torch, lambda i: mel.log_mel_frames(audio[i % 2], 128), 20)
    plain = cuda_ms(torch, lambda i: mel.log_mel_frames_reference(padded[i % 2], 128, mel.N_FRAMES), 20)
    # per frame: the windowed DFT (cos and sin, 400 x 201) as the kernel
    # runs it, three TF32 products on the tensor cores per float32 one; the
    # power, and the mel sums over the filters' nonzero spans in float32
    frames = GROUP * mel.N_FRAMES
    n_freq = mel.N_FFT // 2 + 1
    spans = mel.mel_spans(mel.mel_filters(128).T)
    nnz = int((spans[:, 1] - spans[:, 0]).sum())
    ops = {"tf32": 3 * frames * 2 * 2 * mel.N_FFT * n_freq, "f32": frames * (3 * n_freq + 2 * nnz)}
    record(results, card, "log_mel", err, tol, ms, plain, bound(audio[0].numel() * 4 + frames * 128 * 4, ops),
           extra=f" | B=32 n_mels=128{extra}")
    del audio, padded

    results["mha_encoder"] = check_mha_encoder(torch, g, dev, card)

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
    k3_bytes = 2 * b * h * s * 64 + qi.numel() + 4 * (q_scale.numel() + v_scale.numel() + b * h * 64)
    del kv
    record(results, card, "cross_attend_q8", max(errs), 2e-4 + 2e-3 * float(ref.abs().max()), ms, plain,
           bound(k3_bytes, 4 * b * h * s * 64, "int8"), extra=" | B=32 S=1500 T=1 (T=3 checked too)")

    # K4 and K5: self-attention over the bf16 and the int8 cache, B=32 H=20
    # S=224; their figures are recorded with their times
    phase_traced_times(card, results, {
        "self_attend": (*check_self_attend(torch, g, dev, card), 1e-5),
        "self_attend_q8": check_self_attend_q8(torch, g, dev, card),
    })
    return results


def phase_traced_times(card: str, results: dict, checks: dict) -> None:
    """Run `traced_times` in a process of its own, so that its profiler
    sessions leave this process's launches, and phases 4-8, as they were.
    Adds K1's device time to `results` and records K4 and K5 with their
    `checks` (max abs error, a note, the tolerance)."""
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), TIMES_ARG],
                          capture_output=True, text=True, timeout=900, cwd=REPO)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f"the timing process exited {proc.returncode}:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    timed = json.loads(lines[-1])
    t = results["log_mel"]
    t["device_ms"] = timed["log_mel_device_ms"]
    say(f"phase 3 log_mel by device time: {t['device_ms']:.4f} ms | bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}, {100 * t['bound_ms'] / t['device_ms']:.1f}% of it) | {card}")
    for key, (err, extra, tol) in checks.items():
        times = {int(pos): v for pos, v in timed[key]["times"].items()}
        say_self_times(key, times, card)
        full = times[S_SELF - 1]
        record(results, card, key, err, tol, full["kernel"]["ms"], timed[key]["plain_ms"], bound_of(full),
               full.get("library", {}).get("ms"), extra, **self_fields(times, S_SELF))


def traced_times(torch) -> dict:
    """Phase 3's timing process: K4, K5 and SDPA at S = 224 by CUDA events
    and host time per call, then the device-time traces of these and of K1,
    on inputs made here from the seed. One JSON-ready dict."""
    from whisperkit_tpu_torch.ops import mel

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    traces = []
    out = {"self_attend": time_self_attend(torch, g, dev, traces),
           "self_attend_q8": time_self_attend_q8(torch, g, dev, traces)}
    audio = [torch.randn((GROUP, 480_000), generator=g, device=dev) * 0.1 for _ in range(2)]
    k1 = {}
    traces.append((k1, lambda i: mel.log_mel_frames(audio[i % 2], 128), 20, "log_mel_kernel"))
    for times, fn, iters, kernel in traces:
        times["device_ms"] = device_ms(torch, fn, iters, kernel)
    out["log_mel_device_ms"] = k1["device_ms"]
    return out


# the main path's self-KV cache length: the 3-token prompt and
# min(224, MAX_TOKEN_CONTEXT - 3) = 221 new tokens
S_SELF = 224


def bound_of(t: dict) -> dict:
    return {"bound_ms": t["bound_ms"], "bound_by": t["bound_by"]}


def self_fields(times: dict, s: int) -> dict:
    """K4/K5's extra fields of the kernels line: device and host times at
    S - 1 (every key visible) and the figures at S/2."""
    full, half = times[s - 1], times[s // 2]
    fields = {"device_ms": full["kernel"]["device_ms"], "host_us": full["kernel"]["host_us"],
              "at_half": {"pos": s // 2, **half["kernel"], **bound_of(half)}}
    if "library" in full:
        fields["library_device_ms"] = full["library"]["device_ms"]
        fields["at_half"]["library_ms"] = half["library"]["ms"]
        fields["at_half"]["library_device_ms"] = half["library"]["device_ms"]
    return fields


def say_self_times(key: str, times: dict, card: str) -> None:
    for pos, t in times.items():
        k = t["kernel"]
        lib = ""
        if "library" in t:
            lib = (f" | SDPA event {t['library']['ms']:.4f} ms, device {t['library']['device_ms']:.4f} ms, "
                   f"host {t['library']['host_us']:.1f} µs/call")
        say(f"phase 3 {key} S={S_SELF} pos {pos}: kernel event {k['ms']:.4f} ms, device {k['device_ms']:.4f} ms, "
            f"host {k['host_us']:.1f} µs/call{lib} | bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{100 * t['bound_ms'] / k['device_ms']:.1f}% of it by device time) | {card}")


# K1's limit, in units of the float32 plain version's own error against
# float64: 3xTF32 keeps 22 of float32's 24 bits of each operand, and its
# dropped terms (the two residuals and lo·lo) come to ≤ 3 · 2^-22 of a
# product against float32's 2^-24 rounding: 12x, rounded up
K1_ERR_FACTOR = 16


def check_log_mel(torch, randn_audio, dev, card):
    """K1 against its plain version computed in float64, on the timing's
    random audio (B=32) and on 32 windows of tools.workload's speech-like
    audio (bursts and pauses: quiet frames put mel bins near the 1e-10
    floor, where float32 itself errs by ~1e-3 in log10): the raw log10 mel
    and the model's input (clamped, normalised) each within K1_ERR_FACTOR
    times the error of the float32 plain version. Plain TF32 (one product,
    emulated in torch: ~2^-11 of a product) must exceed that limit.
    Returns (the kernel's raw error on speech-like audio, its limit, a
    note)."""
    from whisperkit_tpu_torch.ops import mel
    from whisperkit_tpu_torch.tools.workload import synth_speechlike_audio

    speech = synth_speechlike_audio(GROUP * mel.WINDOW_SAMPLES / mel.SAMPLE_RATE)
    inputs = {"random": randn_audio,
              "speech-like": torch.from_numpy(speech.reshape(GROUP, mel.WINDOW_SAMPLES)).to(dev)}
    notes, result = [], None
    for name, audio in inputs.items():
        padded = mel._padded_rows(audio, mel.N_FRAMES)
        exact = mel.log_mel_frames_reference(padded, 128, mel.N_FRAMES, torch.float64)
        exact_n = mel.normalize_log_mel(exact)
        forms = {
            "kernel": mel.log_mel_frames(audio, 128),
            "float32": mel.log_mel_frames_reference(padded, 128, mel.N_FRAMES),
            "tf32": mel.log_mel_frames_3xtf32(padded, 128, mel.N_FRAMES, products=1),
        }
        errs = {k: (max_abs(torch, x, exact), max_abs(torch, mel.normalize_log_mel(x), exact_n))
                for k, x in forms.items()}
        limit = [K1_ERR_FACTOR * e for e in errs["float32"]]
        vs_plain = max_abs(torch, forms["kernel"], forms["float32"])
        del forms, exact, exact_n, padded
        notes.append(f"{name}: raw / normalised error vs float64: kernel {errs['kernel'][0]:.3e} / "
                     f"{errs['kernel'][1]:.3e}, float32 {errs['float32'][0]:.3e} / {errs['float32'][1]:.3e}, "
                     f"plain TF32 {errs['tf32'][0]:.3e} / {errs['tf32'][1]:.3e}; kernel vs float32 {vs_plain:.3e}")
        if not all(k <= lim for k, lim in zip(errs["kernel"], limit)):
            fail(f"log_mel {name}: error vs float64 {errs['kernel']} beyond {K1_ERR_FACTOR}x float32's {errs['float32']}")
        if not any(t > lim for t, lim in zip(errs["tf32"], limit)):
            fail(f"log_mel {name}: plain TF32 {errs['tf32']} stays within the limit {limit}")
        result = (errs["kernel"][0], limit[0])
    say(f"phase 3 log_mel check (limit: {K1_ERR_FACTOR}x the float32 plain version's error): {'; '.join(notes)}"
        f" | {card}")
    return (*result, " | checked against float64 on random and speech-like audio")


def check_mha_encoder(torch, g, dev, card) -> dict:
    """K2 at H=20 S=1500. bf16: the tensor-core kernel against the plain
    version on inputs with peaked rows (max score in the ragged last tile,
    or in the first) and near-flat rows (tools/k2_check.py), at B=2 and at
    B=32, each row within 2 bf16 ulps of its largest output; the same
    result from the head-split views of one projection as from contiguous
    copies; the plain tiled algorithm with each of four faults must exceed
    that limit on these inputs. f32: the scalar kernel within 2e-5. Times
    at B=2 and B=32 (the main path's group) on the head-split views, as the
    encoder passes them (contiguous inputs timed beside them), with SDPA on
    the same views as the library yardstick and the bound from the work:
    4·B·H·S²·64 bf16 FLOPs, Q, K, V and O each moved once."""
    import torch.nn.functional as F

    from whisperkit_tpu_torch.models.whisper import _split_heads
    from whisperkit_tpu_torch.ops import attention
    from whisperkit_tpu_torch.tools import k2_check

    h, s = 20, 1500
    kinds = torch.arange(s, device=dev) % 3
    worst, times = {}, {}
    for b in (2, GROUP):
        qkv = k2_check.check_inputs(b, h, s, g, dev)
        out = attention.mha_encoder(*qkv)
        ref = attention.mha_encoder_reference(*qkv)
        ratio = k2_check.excess(out, ref)
        worst[b] = [float(ratio[..., kinds == i].max()) for i in range(3)]
        if not max(worst[b]) <= 1.0 or not bool(torch.isfinite(out.float()).all()):
            fail(f"mha_encoder bf16 B={b}: worst row at {worst[b]} of its limit (2 bf16 ulps of the "
                 f"row's largest output) for {k2_check.ROW_KINDS}")
        if b == 2:
            err = max_abs(torch, out, ref)
            faults = k2_check.fault_table(*qkv)
            missed = [f for f in k2_check.FAULTS if max(faults[f].values()) <= 1.0]
            if missed or max(faults["tiled"].values()) > 1.0:
                fail(f"mha_encoder: the limit does not separate the tiled algorithm from its faults {faults}")
        del out, ref
        contiguous_ms = cuda_ms(torch, lambda i: attention.mha_encoder(*qkv), 10)
        del qkv
        # head-split views of one [B, S, 3·H·64] projection, as encoder_forward
        # passes them (row stride H·64): the main path's layout, which is timed
        x = torch.randn((b, s, 3 * h * 64), generator=g, device=dev).to(torch.bfloat16)
        views = [_split_heads(x[..., i * h * 64 : (i + 1) * h * 64], h) for i in range(3)]
        if not torch.equal(attention.mha_encoder(*views), attention.mha_encoder(*(t.contiguous() for t in views))):
            fail(f"mha_encoder bf16 B={b}: strided views give another result than contiguous copies")
        times[b] = {
            "ms": cuda_ms(torch, lambda i: attention.mha_encoder(*views), 10),
            "contiguous_ms": contiguous_ms,
            "plain_ms": cuda_ms(torch, lambda i: attention.mha_encoder_reference(*views), 3),
            "library_ms": cuda_ms(torch, lambda i: F.scaled_dot_product_attention(*views), 10),
            **bound(4 * b * h * s * 64 * 2, 4 * b * h * s * s * 64, "bf16"),
        }
        del x, views
    qkv = [torch.randn((2, h, s, 64), generator=g, device=dev) for _ in range(3)]
    err32 = max_abs(torch, attention.mha_encoder(*qkv), attention.mha_encoder_reference(*qkv))
    ms32 = cuda_ms(torch, lambda i: attention.mha_encoder(*qkv), 10)
    plain32 = cuda_ms(torch, lambda i: attention.mha_encoder_reference(*qkv), 10)
    say(f"phase 3 mha_encoder f32: max_abs_err {err32:.3e} (tol 2.0e-05) | kernel {ms32:.4f} ms"
        f" | plain {plain32:.4f} ms | f32 B=2 | {card}")
    if not err32 <= 2e-5:
        fail(f"mha_encoder f32: max abs error {err32:.3e} > 2e-5")
    for b, t in times.items():
        tflops = 4 * b * h * s * s * 64 / (t["ms"] * 1e-3) / 1e12
        say(f"phase 3 mha_encoder bf16 B={b}: worst row {max(worst[b]):.3f} of its limit (per kind "
            f"{[round(w, 3) for w in worst[b]]}) | kernel {t['ms']:.4f} ms ({tflops:.1f} TFLOP/s)"
            f" (contiguous q/k/v {t['contiguous_ms']:.4f} ms) | plain {t['plain_ms']:.4f} ms"
            f" | library (SDPA) {t['library_ms']:.4f} ms"
            f" | bound {t['bound_ms']:.4f} ms ({t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.1f}% of it)"
            f" | {card}")
    say(f"phase 3 mha_encoder faults at B=2 (worst row / limit per kind): {json.dumps(faults)}")
    return {"max_abs_err": err, **times[GROUP]}


def check_self_attend(torch, g, dev, card) -> tuple[float, str]:
    """K4 against its plain version at S=224 on the check inputs of
    tools/decode_attn_check.py (peaked rows with the max in the last, ragged
    chunk of the kernel's split or in the first, near-flat rows), at B=4 and
    B=32, the mask open to 0, S/2 and S-1: each row within 1e-5 (float32
    throughout, another summation order). Masked rows filled with NaN must
    leave the output unchanged (the kernel never reads them). The plain
    split-key algorithm with each of its faults must exceed the limit on
    the B=4 inputs. Returns (max abs err, a note)."""
    from whisperkit_tpu_torch.ops import attention_decode
    from whisperkit_tpu_torch.tools import decode_attn_check as dc

    b, h, s = GROUP, 20, S_SELF
    errs, worst, small = [], {}, []
    for batch in (4, b):
        for pos in dc.positions(s):
            q, k, v, mask_row = args = dc.check_inputs(batch, h, s, pos, g, dev)
            out = attention_decode.self_attend(*args)
            ref = attention_decode.self_attend_reference(*args)
            ratio = dc.excess(out, ref, dc.K4_LIMIT)
            worst[f"B={batch} pos {pos}"] = dc.worst_by_kind(ratio)
            if not float(ratio.max()) <= 1.0 or not bool(torch.isfinite(out).all()):
                fail(f"self_attend B={batch} pos {pos}: worst row at {worst[f'B={batch} pos {pos}']} of its "
                     f"limit ({dc.K4_LIMIT} absolute) for {dc.ROW_KINDS}")
            errs.append(max_abs(torch, out, ref))
            if pos < s - 1:
                k_nan, v_nan = k.clone(), v.clone()
                k_nan[:, :, pos + 1 :] = float("nan")
                v_nan[:, :, pos + 1 :] = float("nan")
                if not torch.equal(attention_decode.self_attend(q, k_nan, v_nan, mask_row), out):
                    fail(f"self_attend B={batch} pos {pos}: NaN in the masked rows changed the output")
            if batch == 4:
                small.append(args)
    faults = dc.fault_table(small)
    if not dc.separates(faults):
        fail(f"self_attend: the limit does not separate the split-key algorithm from its faults {faults}")
    say(f"phase 3 self_attend check, worst row / limit ({dc.K4_LIMIT} absolute) per kind {dc.ROW_KINDS}: "
        + "; ".join(f"{key} {[round(x, 3) for x in w.values()]}" for key, w in worst.items())
        + f"; NaN in the masked rows leaves the output unchanged | {card}")
    say(f"phase 3 self_attend faults at B=4 (worst row / limit per position and kind): {json.dumps(faults)}")
    return max(errs), f" | bf16 cache S={s}, checked at B=4 and 32, pos 0, {s // 2}, {s - 1}; timed at B=32"


def time_self_attend(torch, g, dev, traces) -> dict:
    """K4 and SDPA at S=224, the mask open to S/2 and to S-1, on four random
    cache sets (147 MB) that rotate so launches read device memory, and the
    plain version's CUDA-event ms at S-1; the device-time traces join
    `traces`. Returns {"plain_ms", "times": {position: figures}}."""
    import torch.nn.functional as F

    from whisperkit_tpu_torch.ops import attention_decode
    from whisperkit_tpu_torch.tools import decode_attn_check as dc

    b, h, s = GROUP, 20, S_SELF
    caches = [
        tuple(torch.randn((b, h, s, 64), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
        for _ in range(4)
    ]
    q = torch.randn((b, h, 1, 64), generator=g, device=dev) * 0.125
    times = {}
    for pos in (s // 2, s - 1):
        mask_row = dc.mask_upto(s, pos, dev)
        # the library yardstick: one SDPA call on the same cache, its query
        # and mask cast to the cache's dtype beforehand, the scale folded
        # into q; it reads every key, visible or not
        q16, mask16 = q.to(torch.bfloat16), mask_row.to(torch.bfloat16)
        n = pos + 1  # visible keys: the bytes and operations the function needs
        # each call binds this position's mask: the traces run after the loop
        times[pos] = {
            "kernel": launch_times(
                torch, lambda i, m=mask_row: attention_decode.self_attend(q, *caches[i % 4], m), 50, traces,
                "self_attend_kernel"),
            "library": launch_times(torch, lambda i, m=mask16: F.scaled_dot_product_attention(
                q16, *caches[i % 4], attn_mask=m, scale=1.0), 50, traces),
            **bound(2 * b * h * n * 64 * 2 + 4 * (q.numel() + s + b * h * 64), 4 * b * h * n * 64, "f32"),
        }
    plain = cuda_ms(torch, lambda i: attention_decode.self_attend_reference(q, *caches[i % 4], mask_row), 50)
    return {"plain_ms": plain, "times": times}


def check_self_attend_q8(torch, g, dev, card) -> tuple[float, str, float]:
    """K5 against its plain version at S=224 on the check inputs of
    tools/decode_attn_check.py (peaked rows with the max near the end of the
    visible keys or near the start, near-flat rows; query and cache
    quantized per row, the rows after the position unwritten: zero codes
    and scales), at B=4 and B=32, the mask open to 0, S/2 and S-1: each
    row's error within K5_FLIPS · 127 · p_scale of that row (K5_FLIPS
    requantization flips). NaN in the masked rows' scales must leave the
    output unchanged (the kernel never reads them). Rows built to round at
    exact ties must give the exact half-to-even output. Returns (max abs
    err, a note, the largest row limit)."""
    from whisperkit_tpu_torch.ops import attention_decode
    from whisperkit_tpu_torch.tools import decode_attn_check as dc

    b, h, s = GROUP, 20, S_SELF
    errs, tols, worst = [], [], {}
    for batch in (4, b):
        for pos in dc.positions(s):
            args = dc.check_inputs_q8(batch, h, s, pos, g, dev)
            out = attention_decode.self_attend_q8(*args)
            ref = attention_decode.self_attend_q8_reference(*args)
            limit = dc.q8_row_limit(args)
            ratio = dc.excess(out, ref, limit)
            worst[f"B={batch} pos {pos}"] = dc.worst_by_kind(ratio)
            if not float(ratio.max()) <= 1.0 or not bool(torch.isfinite(out).all()):
                fail(f"self_attend_q8 B={batch} pos {pos}: worst row at {worst[f'B={batch} pos {pos}']} of its "
                     f"limit of {dc.K5_FLIPS} requantization flips for {dc.ROW_KINDS}")
            errs.append(max_abs(torch, out, ref))
            tols.append(limit.flatten())
            if pos < s - 1:
                qi, q_scale, k8, ks, v8, vs, mask_row = args
                ks_nan, vs_nan = ks.clone(), vs.clone()
                ks_nan[:, :, pos + 1 :] = float("nan")
                vs_nan[:, :, pos + 1 :] = float("nan")
                if not torch.equal(attention_decode.self_attend_q8(qi, q_scale, k8, ks_nan, v8, vs_nan, mask_row),
                                   out):
                    fail(f"self_attend_q8 B={batch} pos {pos}: NaN in the masked rows' scales changed the output")
    tol_row = torch.cat(tols)
    say(f"phase 3 self_attend_q8 check, worst row / limit ({dc.K5_FLIPS} flips × 127 × p_scale) per kind "
        f"{dc.ROW_KINDS}: " + "; ".join(f"{key} {[float(f'{x:.3g}') for x in w.values()]}" for key, w in worst.items())
        + f"; NaN in the masked rows' scales leaves the output unchanged | {card}")

    # round half to even: keys 0 and 1 alike (probabilities 1/2 each), with
    # v_scale 127 at key 0 and 2j + 1/2 at key 1 (j = row mod 64), so that
    # p_scale is 1/2 and key 1's code is the tie 2j + 1/2: rintf gives 2j,
    # roundf 2j + 1. The output is exact, 0.5 · (127 · v[0] + 2j · v[1]).
    qi, q_scale, k8, ks, v8, vs = _q8_timing_inputs(torch, g, dev, 1)[0]
    tie_mask = torch.zeros((1, s), device=dev)
    tie_mask[:, 2:] = float("-inf")
    for t in (k8, ks, v8, vs):
        t[:, :, 2:] = 0
    k8[:, :, 1], ks[:, :, 1] = k8[:, :, 0], ks[:, :, 0]
    j = (torch.arange(b * h, device=dev) % 64).view(b, h, 1).float()
    vs[:, :, 0], vs[:, :, 1] = 127.0, 2 * j + 0.5
    exact = 0.5 * (127 * v8[:, :, :1].float() + 2 * j[..., None] * v8[:, :, 1:2].float())
    out = attention_decode.self_attend_q8(qi, q_scale, k8, ks, v8, vs, tie_mask)
    ref = attention_decode.self_attend_q8_reference(qi, q_scale, k8, ks, v8, vs, tie_mask)
    if not (torch.equal(out, exact) and torch.equal(ref, exact)):
        fail(f"self_attend_q8 ties: not rounded half to even (kernel max abs {max_abs(torch, out, exact):.3e}, "
             f"plain {max_abs(torch, ref, exact):.3e} from the exact output)")
    extra = (f" | int8 cache S={s}, checked at B=4 and 32, pos 0, {s // 2}, {s - 1}; limit per row "
             f"{dc.K5_FLIPS} flips × 127 × p_scale, {float(tol_row.min()):.3e} to {float(tol_row.max()):.3e}; "
             "ties at 2j + 1/2 exact; timed at B=32")
    return max(errs), extra, float(tol_row.max())


def _q8_timing_inputs(torch, g, dev, sets: int) -> list:
    """`sets` random (qi, q_scale, k8, k_scale, v8, v_scale) at B=32 H=20
    S=224: cache rows quantized per row from std 0.5, the query from std
    2 / sqrt(64), so scores have std ~1."""
    from whisperkit_tpu_torch.models.whisper import _q8_row_quantize

    def q8_rows(shape, std):
        return _q8_row_quantize(torch.randn(shape, generator=g, device=dev) * std)

    shape = (GROUP, 20, S_SELF, 64)
    return [(*q8_rows(shape[:2] + (1, 64), 2 * 64**-0.5), *q8_rows(shape, 0.5), *q8_rows(shape, 0.5))
            for _ in range(sets)]


def time_self_attend_q8(torch, g, dev, traces) -> dict:
    """K5 at S=224, the mask open to S/2 and to S-1, on four random cache
    sets (codes and per-token scales, 79 MB) that rotate so launches read
    device memory, and the plain version's CUDA-event ms at S-1; the
    device-time traces join `traces`. Returns {"plain_ms", "times":
    {position: figures}}."""
    from whisperkit_tpu_torch.ops import attention_decode
    from whisperkit_tpu_torch.tools import decode_attn_check as dc

    b, h, s = GROUP, 20, S_SELF
    sets = _q8_timing_inputs(torch, g, dev, 4)
    qi, q_scale = sets[0][:2]
    caches = [c[2:] for c in sets]
    times = {}
    for pos in (s // 2, s - 1):
        mask_row = dc.mask_upto(s, pos, dev)
        n = pos + 1
        times[pos] = {
            "kernel": launch_times(
                torch, lambda i, m=mask_row: attention_decode.self_attend_q8(qi, q_scale, *caches[i % 4], m), 50,
                traces, "self_attend_q8_kernel"),
            # the visible keys' int8 codes and f32 scales of K and V, the
            # query, the mask row and the f32 output
            **bound(2 * b * h * n * (64 + 4) + qi.numel() + 4 * (q_scale.numel() + s + b * h * 64),
                    4 * b * h * n * 64, "int8"),
        }
    plain = cuda_ms(torch, lambda i: attention_decode.self_attend_q8_reference(qi, q_scale, *caches[i % 4], mask_row),
                    50)
    return {"plain_ms": plain, "times": times}


def transcribe_twice(torch, pipe, audio, options) -> dict:
    """One warm pass, then one timed pass with the launch counts set to 0
    just before it and read just after it."""
    from whisperkit_tpu_torch.ops import _build

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
    return {"result": result, "wall": wall, "warm": warm, "counts": dict(_build.launches),
            "peak": torch.cuda.max_memory_allocated(), "windows": windows}


def check_launches(label, counts, launched, per_layer, idle, n_layer) -> None:
    """Fail unless every kernel of the path launched, those launched once
    per decoder layer a multiple of the layer count, and none of `idle`."""
    missing = [k for k in launched if counts[k] <= 0]
    if missing:
        fail(f"{label} skipped kernels {missing}: launches {counts}")
    for k in per_layer:
        if counts[k] % n_layer:
            fail(f"{label}: {k} launched {counts[k]} times, not a multiple of {n_layer} layers")
    stray = [k for k in idle if counts[k]]
    if stray:
        fail(f"{label} launched {stray}, which it does not run: launches {counts}")


def check_segments(label, segs) -> None:
    if not segs:
        fail(f"{label}: no segments")
    # windows come in time order (by seek); inside a window, timestamps
    # increase and lie within its 30 s (random-init text may run past the
    # chunk's speech into the next chunk's time)
    keys = [(s.seek, s.start) for s in segs]
    if keys != sorted(keys) or any(
        not (s.seek / 100.0 <= s.start <= s.end <= s.seek / 100.0 + 30.0) for s in segs
    ):
        fail(f"{label}: segment timestamps are not increasing and in range")
    import math

    if not all(math.isfinite(s.avg_logprob) for s in segs):
        fail(f"{label}: a segment's avg log-prob is not finite")


def report_path(label, run, n_chunks, card, extra="") -> None:
    timings = run["result"].timings
    say(
        f"{label}: {AUDIO_SECONDS:.0f} s audio, {n_chunks} VAD chunks, {len(run['result'].segments)} segments "
        f"| wall {run['wall']:.3f} s (first run {run['warm']:.3f} s{extra}) "
        f"| RTF {run['wall'] / AUDIO_SECONDS:.6f} | {timings.tokens_per_second:.1f} tok/s "
        f"| peak {run['peak'] / 2**30:.2f} GiB | launches {json.dumps(run['counts'])} | {card}"
    )
    say(
        f"  stages (host clock, no stage sync): mel {timings.log_mels:.3f} s, encode "
        f"{timings.encoding:.3f} s, prefill {timings.prefill:.3f} s, decode loop "
        f"{timings.decoding_loop:.3f} s, windowing {timings.decoding_windowing:.3f} s"
    )


def run_path(torch, label, pipe, audio, card, launched, per_layer, idle, extra="") -> dict:
    from whisperkit_tpu_torch.tools.workload import pipeline_options

    options = pipeline_options(GROUP)
    run = transcribe_twice(torch, pipe, audio, options)
    n_chunks = len(pipe._vad_chunks(audio, options))
    check_launches(label, run["counts"], launched, per_layer, idle, pipe.dims.n_text_layer)
    windows = run["windows"]
    if len(windows) != n_chunks or not all(windows):
        fail(f"{label}: {n_chunks} VAD chunks but {len(windows)} decoded windows, "
             f"{sum(1 for w in windows if not w)} without tokens")
    check_segments(label, run["result"].segments)
    report_path(label, run, n_chunks, card, extra)
    return run


def phase_main_path(torch, card: str) -> dict:
    from whisperkit_tpu_torch.core.configurations import ComputeOptions, WhisperConfig
    from whisperkit_tpu_torch.models.whisper import VARIANT_DIMS, init_params
    from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
    from whisperkit_tpu_torch.tools.workload import synth_speechlike_audio

    dims = VARIANT_DIMS["large-v3"]
    t0 = time.perf_counter()
    # no device given: the entry points place everything on the card
    params = init_params(SEED, dims, torch.bfloat16)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    pipe = WhisperPipeline(
        WhisperConfig(compute_options=ComputeOptions.serving(), load=False), dims=dims, params=params,
    )
    if pipe.device.type != "cuda" or params["encoder"]["conv1"]["w"].device.type != "cuda":
        fail(f"the default device is {pipe.device}, not the card")
    audio = synth_speechlike_audio(AUDIO_SECONDS)
    run = run_path(
        torch, "phase 4 bf16 path: large-v3 bf16 serving", pipe, audio, card,
        launched=("log_mel", "mha_encoder", "cross_attend_q8", "self_attend"),
        per_layer=("cross_attend_q8", "self_attend"), idle=("self_attend_q8",),
        extra=f", init_params {t_init:.1f} s",
    )
    return {"counts": run["counts"], "pipe": pipe, "audio": audio}


def phase_int8_path(torch, card: str, bf16_pipe, audio) -> dict:
    """The int8 serving configuration: W8A16 weights, int8 cross-KV and the
    int8 self-KV cache, on the phase-4 weights quantized on the card."""
    from whisperkit_tpu_torch.core.configurations import ComputeOptions, WhisperConfig
    from whisperkit_tpu_torch.ops.quant import quantize_whisper_params, quantized_size_bytes
    from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline

    dims = bf16_pipe.dims
    t0 = time.perf_counter()
    qparams = quantize_whisper_params(bf16_pipe.params)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    q_bytes, bf16_bytes = quantized_size_bytes(qparams), quantized_size_bytes(bf16_pipe.params)
    pipe = WhisperPipeline(
        WhisperConfig(
            compute_options=ComputeOptions.serving(quantization="w8a16", quantize_self_kv=True),
            load=False,
        ),
        dims=dims, params=qparams, device="cuda",
    )
    run = run_path(
        torch, "phase 6 int8 path: large-v3 W8A16 + int8 cross-KV + int8 self-KV", pipe, audio, card,
        launched=("log_mel", "mha_encoder", "cross_attend_q8", "self_attend_q8"),
        per_layer=("cross_attend_q8", "self_attend_q8"), idle=("self_attend",),
        extra=f", quantize {t_quant:.3f} s",
    )
    say(f"  weights: W8A16 {q_bytes} bytes ({q_bytes / 2**30:.3f} GiB) vs bf16 {bf16_bytes} bytes "
        f"({bf16_bytes / 2**30:.3f} GiB); peak counts both trees resident")
    return {"counts": run["counts"], "pipe": pipe}


def phase_step_parity(torch, label, pipe, audio, card) -> None:
    """One decoder step after prefill at large-v3 width: kernels vs plain,
    over the cache form the pipe's ComputeOptions select."""
    from unittest import mock

    from whisperkit_tpu_torch.decoding.loop import encode_window, prefill_window
    from whisperkit_tpu_torch.models import whisper as model
    from whisperkit_tpu_torch.ops import attention_decode as ad

    dims, params, sp = pipe.dims, pipe.params, pipe.tokenizer.special
    q8_self = pipe.config.compute_options.quantize_self_kv
    mel = pipe._mel_batch([audio[i * 480_000 : (i + 1) * 480_000] for i in range(4)])
    _, ck, cv = encode_window(params, mel, dims, quantize_kv=True)
    prompt = torch.tensor([[sp.sot, sp.language_token("en"), sp.transcribe]] * 4, device=pipe.device)
    token = torch.full((4, 1), sp.timestamp_begin, device=pipe.device)

    def step():
        pre = prefill_window(params, ck, cv, prompt, dims=dims, special=sp, sample_begin=3,
                             max_new_tokens=224, sot_index=0, quantize_self_kv=q8_self)
        with torch.inference_mode():
            return model.decoder_forward(params, token, 3, pre.kv_k, pre.kv_v, ck, cv, dims)[:, -1]

    kernel_logits = step()
    with mock.patch.object(model, "self_attend", ad.self_attend_reference), \
            mock.patch.object(model, "self_attend_q8", ad.self_attend_q8_reference), \
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
    say(f"{label}: max |Δlogit| {err:.3e} (tol {tol:.3e}, max |logit| {scale:.3f}) "
        f"| argmax equal per row {same}, plain top-2 gaps {[round(g, 4) for g in gaps]} | {card}")
    if not err <= tol:
        fail(f"{label}: logits differ by {err:.3e} > {tol:.3e}")
    if any(not eq and gap > 2 * err for eq, gap in zip(same, gaps)):
        fail(f"{label}: picked another token where the top-2 gap exceeds the logit error")


def phase_w4_w8a8(torch, card: str, bf16_pipe, int8_pipe, audio) -> None:
    """W4A16 and W8A8 transcribe 60 s of the audio once each (serving
    preset, stage syncs on); the encoder of 4 windows is timed with W8A16
    and with W8A8, whose int8-activation dots run in float64."""
    from whisperkit_tpu_torch.core.configurations import ComputeOptions, WhisperConfig
    from whisperkit_tpu_torch.decoding.loop import encode_window
    from whisperkit_tpu_torch.ops import _build
    from whisperkit_tpu_torch.ops.quant import quantize_whisper_params, quantized_size_bytes
    from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
    from whisperkit_tpu_torch.tools.workload import pipeline_options

    dims = bf16_pipe.dims
    clip = audio[: 60 * 16_000]
    options = pipeline_options(GROUP)
    trees = {"w4a16": quantize_whisper_params(bf16_pipe.params, bits=4), "w8a8": int8_pipe.params}
    for scheme, tree in trees.items():
        pipe = WhisperPipeline(
            WhisperConfig(
                compute_options=ComputeOptions.serving(quantization=scheme, sync_timings=True),
                load=False,
            ),
            dims=dims, params=tree, device="cuda",
        )
        label = f"phase 8 {scheme}"
        _build.reset_launches()
        t0 = time.perf_counter()
        result = pipe.transcribe(clip, options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launches)
        check_launches(label, counts, ("log_mel", "mha_encoder", "cross_attend_q8", "self_attend"),
                       ("cross_attend_q8", "self_attend"), ("self_attend_q8",), dims.n_text_layer)
        check_segments(label, result.segments)
        t = result.timings
        say(f"{label}: 60 s audio, one pass (first run), {len(result.segments)} segments, "
            f"{quantized_size_bytes(tree)} weight bytes | wall {wall:.3f} s | encode {t.encoding:.3f} s, "
            f"decode loop {t.decoding_loop:.3f} s (stage syncs on) | {t.tokens_per_second:.1f} tok/s "
            f"| launches {json.dumps(counts)} | {card}")
        del pipe

    mel = int8_pipe._mel_batch([audio[i * 480_000 : (i + 1) * 480_000] for i in range(4)])
    times = {}
    for scheme, act8 in (("w8a16", False), ("w8a8", True), ("w8a8 again", True), ("w8a16 again", False)):
        with torch.inference_mode():
            times[scheme] = cuda_ms(
                torch, lambda i: encode_window(int8_pipe.params, mel, dims, quantize_kv=True, act8=act8), 2
            )
    say("phase 8 encoder, 4 windows, int8 cross-KV (CUDA events, mean of 2 after a warm-up): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items()) + f" | {card}")


# (kernel, source, TPU kernel it replaces, the path whose launch count it reports)
KERNEL_TABLE = (
    ("log_mel", "whisperkit_tpu_torch/csrc/mel.cu", "whisperkit_tpu/ops/mel.py:227", "int8"),
    ("mha_encoder", "whisperkit_tpu_torch/csrc/mha_encoder.cu", "whisperkit_tpu/ops/attention.py:85", "int8"),
    ("cross_attend_q8", "whisperkit_tpu_torch/csrc/attention_decode.cu",
     "whisperkit_tpu/ops/attention_decode.py:81", "int8"),
    ("self_attend", "whisperkit_tpu_torch/csrc/attention_decode.cu",
     "whisperkit_tpu/ops/attention_decode.py:191", "bf16"),
    ("self_attend_q8", "whisperkit_tpu_torch/csrc/attention_decode.cu",
     "whisperkit_tpu/ops/attention_decode.py:216", "int8"),
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
    if sys.argv[1:] == [TIMES_ARG]:
        say(json.dumps(traced_times(torch)))
        return

    name, card = phase_card(torch)
    phase_build()
    kernel_results = phase_kernels(torch, card)
    bf16 = phase_main_path(torch, card)
    phase_step_parity(torch, "phase 5 decoder step, bf16 cache", bf16["pipe"], bf16["audio"], card)
    int8 = phase_int8_path(torch, card, bf16["pipe"], bf16["audio"])
    phase_step_parity(torch, "phase 7 decoder step, W8A16 + int8 self-KV cache", int8["pipe"], bf16["audio"],
                      card)
    phase_w4_w8a8(torch, card, bf16["pipe"], int8["pipe"], bf16["audio"])

    counts = {"bf16": bf16["counts"], "int8": int8["counts"]}
    kernels = [
        {
            "name": key, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[path][key], "path": path, **kernel_results[key],
        }
        for key, source, replaces, path in KERNEL_TABLE
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
