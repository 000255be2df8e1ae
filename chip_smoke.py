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
     tools/decode_attn_check.py (K5 also at S = 229 and 448). In a process
     of its own (this script run with TIMES_ARG): K4 and SDPA timed at the
     main path's cache length S = 224 with the mask open to S/2 and to
     S - 1, K5 with it open to 0, 31, S/2 and S - 1, eager and as a CUDA
     graph of 50 launches, by CUDA events with the host's time per call,
     K2 and SDPA on the head-split views at B = 32 and B = 2 and in the
     split form, then K1, K2, K4, K5 and SDPA by device time from
     `torch.profiler` traces.
     Once a profiler session has run, every
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
  9. word timestamps: phase 4's pipeline with ALIGNMENT_HEADS on the 600 s
     run, one pass: every K3 launch on a layer that holds an alignment
     head takes the probs form (launch counts), and each segment's words
     are in order and inside it; the alignment buffer's transfer timed
 10. beam search, beam 5, on 60 s of the audio under the serving preset
     (the raw bf16 cross-KV, K4 over B·K rows): tokens and scores printed;
     the steps replay two CUDA graphs (one per parity of the position)
 11. segmented decode on the 600 s run's 32-row group, with an EOT bias
     chosen from an unbiased run's margins so that rows end at different
     steps: the decode must compact; its tokens against the uncompacted
     decode's with the same bias; then an early-stop flag, set before the
     run, stops every window after its first segment
 12. speculative decoding at batch 1 on 30 s of the audio, a random
     distil-large-v3 draft, the rounds replaying a CUDA graph of one
     round: its tokens against the same pipeline's without the draft
 13. the checkpoint: phase 4's tree written as an HF folder
     (tools/checkpoint.py) with ALIGNMENT_HEADS and a byte-level vocab in
     a temporary directory, loaded by WhisperPipeline(WhisperConfig(
     model_folder=...)) as W8A16 serving; every leaf equal to
     quantize_whisper_params of phase 4's tree; write and load seconds
 14. the server: create_app on 127.0.0.1 over phase 13's pipeline, nine
     concurrent requests from threads (json 120/90/60/30 s WAVs cut from
     phase 4's audio, verbose_json with word timestamps, SSE, the latency
     class, /health, a post with no file); every response through
     server/schema.py; every batched window against the pipeline on its
     request alone under the top-2-gap rule; K1-K4 and K3's probs form
     must launch; latencies and the batcher's stats
 15. the CLI: `python -m whisperkit_tpu_torch.cli transcribe` on the folder
     and the 60 s WAV in a child process, exit 0, its JSON report against
     an in-process pipeline with the CLI's options under the same rule
 16. diarization with the published speaker models at their published
     shapes (PyanNet, WeSpeaker ResNet34), random weights written under the
     published names (tools/checkpoint.write_pyannote_checkpoint) and
     loaded by DiarizePipeline.from_pretrained in each variant (w32a32,
     w16a16, w8a16): the first 60 s against the same pipeline on this
     machine's CPU (segmenter log-probs, fbank, L2-normalised embeddings,
     RTTM; limits at LOGPROB_LIMIT, each of which the same models run in
     TF32 must fail), then the 600 s audio timed: stage seconds, chunks,
     embeddings, speakers, RTTM lines, peak memory. Phases 16-18 run under
     torch's default TF32 flags, as a user's process does
 17. DiarizePipeline() (the random-init conv models) on the 600 s audio,
     its embedder's mel through K1 at n_mels = 80 (the launch counts' path
     `diarize_conv`); then `transcribe --diarization` in a child process on
     phase 15's folder and WAV, its speaker labels against the in-process
     diarization merged by merge_with_transcript
 18. streaming: AudioStreamTranscriber (eager, no VAD) over simulate_stream
     of 12 s in 1 s slices on the CLI's pipeline and options, each pass
     equal to pipe.transcribe of its buffer, K1, K2 and K4 launched (the
     counts' path `streaming`); `--stream-simulated` in a child process
     prints the same final text; `--stream` exits 2 (no capture backend)
 19. text-to-speech, Qwen3-TTS 0.6b at full width (TTS_VARIANTS["0.6b"],
     random weights from the port's init with SEED): in float32, 8 frames
     at temperature 0 on the card (the vocoder guards its own IEEE
     float32, core.device.ieee_float32) against the same pipeline on this
     machine's CPU (codes under the top-2-gap rule, logits within
     TTS_LOGIT_LIMIT, the vocoder within TTS_WAVE_LIMIT, each limit
     failing the same run in TF32), then
     stream_blocks against generate and a prompt-cache hit against a miss;
     generate of a four-sentence paragraph (four chunks, one batch) with
     the CLI's defaults in bf16, W8A16 and W4A16, one warm pass then one
     timed: frames, ms_per_step, real-time ratio, stage seconds, peak
     memory, weight bytes, the frame graph's captures and replays;
     stream_blocks' first block; the prompt cache; device and host
     launches, device busy and idle per frame, eager and as the frame's
     graph, from `python -m whisperkit_tpu_torch.tools.profile_tts` in a
     child process; the 1.7b variant on one generate with an instruction.
     The runs whose sampling logits are recorded (against the CPU, the
     prompt-cache miss) run their frames eagerly; the others replay the
     frame's CUDA graph
 20. the TTS entry points: phase 19's bf16 tree written as a Qwen3-TTS
     folder (tools/checkpoint.write_qwen3_tts_checkpoint), loaded through
     TTSPipeline.from_pretrained with every leaf equal, and
     `python -m whisperkit_tpu_torch.cli tts` on it in a child process (a
     24 kHz WAV of frames x 1920 samples). No Whisper kernel of the port
     runs in phases 19-20: their launch counts (the path `tts`) must all be
     0 but the W8A16 product's, which the W8A16 frames must launch
 21. quantization divergence (eval/quant_delta.py) at large-v3 on phase
     4's tree: teacher_forced_divergence on the first 30 s window, 96
     tokens, every scheme of DEFAULT_SCHEMES (agreement, flips, bf16
     margins, mean |logit delta|), then quant_divergence on the 600 s
     audio for every scheme and a bf16 control that must not diverge
     (WER and token divergence against bf16); the counts' path `eval`
 22. the load generator (eval/loadgen.run_load) over a BatchScheduler on
     phase 13's W8A16 pipeline: a burst of 16 x 30 s clips, then Poisson
     arrivals of 12 clips of 30/60/90 s at 1x the burst's audio-seconds per
     second: latency percentiles, tokens/s, serving RTF, batches, batch
     fill, queue depth; the burst must batch; the counts' path `loadgen`
 23. operations on phase 13's folder: `python -m
     whisperkit_tpu_torch.eval.regression` in a child process on three WAVs
     with transcripts; the loader's caches written, hit (every leaf equal
     to the quantized phase-4 tree) and rebuilt after os.utime, each load
     timed; `cli transcribe --profile-dir` in a child process, its trace
     read back and its kernels counted (the path `profile`); a
     ModelManager asked from four threads loads once
 24. the mesh (whisperkit_tpu_torch/parallel/) over every visible card from
     two on, else over two replicas of cuda:0 (correctness and overhead,
     not scaling), each run against the same tree on one device in this
     process: (0) the tp group's device all-reduce (csrc/tp_all_reduce.cu,
     tools/tp_collective_check.py) bit-equal to the rank-ordered fold at
     tp 2 and 4 on every type and shape the port reduces, 1,000 eager
     calls, 100 replays of a graph of 96 calls (timed: the kernels line's
     figures), a peer that never arrives and a peer that fails each
     raising GroupAborted, a collective after reset; (a) dp 2,
     serving(quantization="w8a16") on the 600 s audio (from four cards also
     dp 2 x tp 2), every chunk's tokens under the top-2-gap rule, wall,
     peak and launches per device; (b) tp 2, bf16 serving with
     ALIGNMENT_HEADS and word timestamps on 60 s, every rank's decode on
     its own CUDA graph: tokens under the gap rule, the one-device tokens'
     word timings teacher-forced through both within MESH_WORD_TOL, one
     decoder step's logits within phase 5's limit; the same run with the
     ranks' steps eager, bit-equal (tokens, log-probs, length, the
     gathered alignment, launches), a capture on each rank and a replay
     for every later step, no host barrier wait between replays; beam 5 at
     tp 2 on the clip, graph against eager the same way; a decode step at
     B = 32 on one device and on each rank (wall, busy per stream); (c)
     the W8A8 encoder at tp 2 against the unsharded one; (d) the
     sequence-parallel encoder at tp 2 (K2 with 750 queries over 1500
     keys) against the replicated one; (e) diarization with phase 16's
     published models and TTS 0.6b (MESH_TTS_FRAMES frames, T 0 and 0.9)
     at dp 2: the RTTM and embeddings, the codes under a gap rule; then
     TTS at dp 2, TTS_GRAPH_FRAMES frames, T 0 and 0.9: the frame's graph
     (a capture per device thread) bit-equal to the mesh's eager frames.
     The mesh runs' launches are the path `mesh`, per device too; (a)
     prints the decode graph's captures and replays per device (each mesh
     thread captures its own).
     `python3 chip_smoke.py --mesh-only` runs phases 1, 2 and 24 alone
 25. the decode loop's CUDA graph (decoding/graph.py) against the eager
     loop (`cuda_graph=False`) on phase 4's 32-window group, encoded and
     prefilled once per case: bf16; W8A16 + int8 self-KV; ALIGNMENT_HEADS;
     T 0.5 top-k 5 from one seed; segmented with phase 11's EOT bias,
     which must compact and capture once more per compaction. Tokens,
     log-probabilities, `done` and the alignment buffer bit-equal, the
     kernels' launches equal (the graph's counted through its replays)
 26. the TTS frame's CUDA graph (decoding/tts_loop.py) against the eager
     frames (`cuda_graph=False`), TTS_GRAPH_FRAMES frames a run, T 0 and
     0.9 from one seed: tts_generate_loop on the paragraph's four rows
     (two left-padded) with phase 19's bf16, W8A16 and W4A16 trees; bf16
     stream_blocks (batch 1, blocks of 25); a bf16 prompt-cache hit.
     Codes, n_frames, length and the final KV cache bit-equal, one
     capture a loop or stream and a replay for every later frame
 27. beam search's and speculative decoding's CUDA graphs against their
     eager loops (`cuda_graph=False`): beam 5 on phase 10's group with no
     bias and with phase 11's EOT bias; speculative on phase 12's first
     window with its random draft and with the target as its own draft
     (the accept path: more than one token a target pass). Tokens,
     log-probs, sums, `length` bit-equal, launches equal, captures (two
     for beam, one for speculative) and a replay per later step or round
 28. the W8A16 product's kernel (csrc/w8a16_matmul.cu), right after phase
     3: at the decode step's shapes ([1280, 1280], [1280, 5120],
     [5120, 1280] at rows 1, 8, 16, 32, 64, 128, 160; a tp column slice
     [1280, 640] and row slice [2560, 1280] at 32 rows; a 3-d x) against
     the float64 product of the same bf16 operands, within twice the plain
     version's error; the folded bias, three products in one launch and two
     replays of a captured graph bit-equal; a two-layer large-v3-wide
     decoder launching it 6 times a layer for its 8 products in the prompt
     pass and a step (none for the cross-KV projection), its step logits
     against the plain version's; ptxas's registers and spills; in a
     process of its own (W8A16_TIMES_ARG), device times of the kernel, the
     plain version and torch.matmul on the dequantized weight (the
     library), the bound, the row crossover (timed up to the kernel's 256
     rows), and one large-v3 decode step's launches at 32 rows.
     `python3 chip_smoke.py --w8a16` runs phases 1, 2 and 28 alone
Phases 21-23 run after phase 15, while phase 4's tree and phase 13's
pipeline are on the card (and TF32 is off, as in phases 1-15), then phases
16-20 run; phases 25, 27 and 24's Whisper part run after phase 12, on
phase 4's and phase 6's trees, 26 after phase 19 on its trees, 24's part
(e) after phase 20. The line before the card's prints the script's
seconds.

The pipelines' greedy and sampled decode loops replay a CUDA graph of the
step on the card (phases 4, 6, 9, 11, 14, 21-24), beam search and
speculative decoding theirs (10, 12); a launch inside the
graph is counted once per replay, so every path's counts are the eager
loop's. Runs that record each step's logits (phases 11, 12, 14, 15, 24's
references: `StepLogits`) decode eagerly.

Phase 3 also holds K2's split form (B=1, the second 750 query rows over
all 1500 keys: the sequence-parallel encoder's launch) against its plain
version on the same row kinds and limit, and K1 at n_mels = 80 over 39 windows (the conv embedder's
launch in phase 17) and K3's probs form against its plain version (B=4 and
B=32, one and three query rows, peaked and near-flat rows): the
probabilities within 1e-6, the output bit for bit the plain launch's; it
times the form by events here and by device time in the timing process.
Where phases 11, 12, 14 and 15 hold one decode's tokens against another's, bf16
GEMMs at other batch sizes or query counts may round otherwise: they print
the rows that match exactly and fail only where a row's first divergence
sits at a top-2 gap of the reference's filtered logits above BF16_GAP_TOL.

Each path's kernels must all launch between the counts' reset just before
it and their reading just after it. The line before last is a JSON object
with one entry per kernel; the last line is the JSON result
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
START = time.perf_counter()
SEED = 0
# published dense peaks of one H100 SXM (the bound of each kernel)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12}
# the special function units' exp2 rate: 16 per SM per clock (132 SMs) at
# the 1.83 GHz that the 989 TFLOP/s bf16 peak implies; K2's second bound
PEAK_EXP_PER_S = 132 * 16 * 1.83e9
AUDIO_SECONDS = 600.0
GROUP = 32
# the conv diarization's 30 s chunks at a 15 s stride over AUDIO_SECONDS,
# the trailing chunk that the one before covers dropped (phases 3 and 17)
DIARIZE_CONV_CHUNKS = 39
# the argument that runs phase 3's timing process (`traced_times`)
TIMES_ARG = "--traced-times"
# the argument that runs phases 1, 2 and 24 alone (`mesh_only`)
MESH_ARG = "--mesh-only"
# phase 9's alignment heads: ten (layer, head) pairs of large-v3, one in
# each of ten layers from 7 to 25 (on random weights any list serves)
ALIGNMENT_HEADS = ((7, 0), (10, 17), (12, 18), (13, 12), (16, 1), (17, 14), (19, 11), (21, 4), (24, 1), (25, 6))
# phases 11 and 12: the largest top-2 gap of the reference's filtered
# logits at which a bf16 decode may pick the other token (the logits of
# two bf16 runs through 32 layers differ by up to ~0.07, phase 5)
BF16_GAP_TOL = 0.25


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


def device_ms(torch, fn, iters: int, kernel: str | None = None, per_call: int = 1) -> float:
    """Mean device time per launch of `fn(i)` over `iters` calls, from the
    device activities of a `torch.profiler` (CUPTI) trace: those whose name
    holds `kernel`, which must run `per_call` times per call (a graph's
    replay: its launches), or with no `kernel` every device activity of the
    calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    for _ in range(5):  # a trace may come back short of activities: take another
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kernel is not None:
            events = [e for e in events if kernel in e.name]
        if events and (kernel is None or len(events) == iters * per_call):
            return sum(e.time_range.end - e.time_range.start for e in events) / 1e3 / (iters * per_call)
    fail(f"five traces of {iters} calls held {len(events)} device activities"
         + (f" named {kernel!r}" if kernel else ""))


def launch_times(torch, fn, iters: int, traces: list, kernel: str | None = None, per_call: int = 1) -> dict:
    """A launch's CUDA-event time (`ms`) and the host's time to issue it
    (`host_us`) over `iters` back-to-back calls (`_timed_loop`) of `per_call`
    launches each; its device time (`device_ms`) joins the dict once
    `traced_times` has run the trace queued in `traces`."""
    ms, host = _timed_loop(torch, fn, iters)
    times = {"ms": ms / per_call, "host_us": host * 1e6 / per_call}
    traces.append((times, fn, iters, kernel, per_call))
    return times


def captured(torch, fn, launches: int):
    """A CUDA graph of the calls fn(0) .. fn(launches - 1), captured after
    one uncaptured pass on the capture's side stream."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for i in range(launches):
            fn(i)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fn(i)
    return graph


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


def phase_build() -> str:
    """Build the kernels; print and return nvcc's `-Xptxas -v` report."""
    from whisperkit_tpu_torch.ops import _build

    res = _build.build(force=True)
    _build.library()
    say(f"phase 2 build: {len(_build._sources())} sources, one nvcc each, -> {res.path.name} "
        f"in {res.seconds:.1f} s")
    for line in res.log.splitlines():
        if ("ptxas info" in line and ("Used" in line or "Compiling" in line)) or "spill" in line:
            say(f"  {line.strip()}")
    return res.log


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
    # K1 at the conv embedder's shape (phase 17): n_mels 80, the 600 s run's
    # 39 chunks of 30 s in one launch
    audio = [torch.randn((DIARIZE_CONV_CHUNKS, 480_000), generator=g, device=dev) * 0.1 for _ in range(2)]
    err, tol, extra = check_log_mel(torch, audio[0], dev, card, n_mels=80)
    padded = [mel._padded_rows(a, mel.N_FRAMES) for a in audio]
    ms = cuda_ms(torch, lambda i: mel.log_mel_frames(audio[i % 2], 80), 20)
    plain = cuda_ms(torch, lambda i: mel.log_mel_frames_reference(padded[i % 2], 80, mel.N_FRAMES), 20)
    frames = DIARIZE_CONV_CHUNKS * mel.N_FRAMES
    spans = mel.mel_spans(mel.mel_filters(80).T)
    nnz = int((spans[:, 1] - spans[:, 0]).sum())
    ops = {"tf32": 3 * frames * 2 * 2 * mel.N_FFT * n_freq, "f32": frames * (3 * n_freq + 2 * nnz)}
    record(results, card, "log_mel_80", err, tol, ms, plain, bound(audio[0].numel() * 4 + frames * 80 * 4, ops),
           extra=f" | B={DIARIZE_CONV_CHUNKS} n_mels=80{extra}")
    results["log_mel"]["n_mels_80"] = results.pop("log_mel_80")
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
    record(results, card, "cross_attend_q8", max(errs), 2e-4 + 2e-3 * float(ref.abs().max()), ms, plain,
           bound(k3_bytes(b, h, s, 1), 4 * b * h * s * 64, "int8"), extra=" | B=32 S=1500 T=1 (T=3 checked too)")
    results["cross_attend_q8_probs"] = check_cross_probs(torch, g, dev, card, qi, q_scale, kv, v_scale)
    del kv

    # K4 and K5: self-attention over the bf16 and the int8 cache, B=32 H=20
    # S=224; their figures are recorded with their times
    phase_traced_times(card, results, {
        "self_attend": (*check_self_attend(torch, g, dev, card), 1e-5),
        "self_attend_q8": check_self_attend_q8(torch, g, dev, card),
    })
    return results


def k3_bytes(b: int, h: int, s: int, t: int, probs_heads: int = 0) -> int:
    """Bytes K3 must move: int8 K and V once, the int8 query, the f32
    query and V scales and output, and, in the probs form, the f32
    probabilities of `probs_heads` heads."""
    return 2 * b * h * s * 64 + b * h * t * 64 + 4 * (b * h * t + b * h * 64 + b * h * t * 64) + 4 * b * probs_heads * t * s


def check_cross_probs(torch, g, dev, card, qi, q_scale, kv, v_scale) -> dict:
    """K3's probs form against its plain version on the check inputs of
    tools/decode_attn_check.py (peaked rows at the last or the first frames,
    near-flat rows) at B=4 and B=32, one and three query rows (the step;
    the prefill and the speculative verify): every head's probabilities
    within K3_PROBS_LIMIT of the plain version's, the output bit for bit
    the plain launch's, and the heads without a slot not written (a
    strided view of an alignment buffer [T, B, 3, S] NaN-filled, two heads
    given slots). Then the form's CUDA-event times at B=32 T=1 for one
    head (the main path: one alignment head per layer) and for all 20,
    beside plain K3's on the same inputs; device times come from the
    timing process."""
    from whisperkit_tpu_torch.ops import attention_decode as ad
    from whisperkit_tpu_torch.tools import decode_attn_check as dc

    h, s = 20, 1500
    errs, worst = [], {}
    for b in (4, GROUP):
        for t in (1, 3):
            args = dc.check_inputs_cross_q8(b, h, s, t, g, dev)
            plain_out = ad.cross_attend_q8(*args)
            probs = torch.full((b, h, t, s), float("nan"), device=dev)
            out = ad.cross_attend_q8(*args, probs_out=probs, probs_slots=list(range(h)))
            ref_out, ref_probs = ad.cross_attend_q8_reference(*args, return_probs=True)
            if not torch.equal(out, plain_out):
                fail(f"cross_attend_q8_probs B={b} T={t}: the output differs from the plain launch's")
            if not torch.allclose(out, ref_out, rtol=2e-3, atol=2e-4):
                fail(f"cross_attend_q8_probs B={b} T={t}: output not within rtol 2e-3 / atol 2e-4 of the plain version")
            ratio = torch.nan_to_num((probs - ref_probs).abs().amax(dim=(-1, -2)) / dc.K3_PROBS_LIMIT, nan=float("inf"))
            worst[f"B={b} T={t}"] = dc.worst_by_kind(ratio)
            if not float(ratio.max()) <= 1.0:
                fail(f"cross_attend_q8_probs B={b} T={t}: probabilities off by {worst[f'B={b} T={t}']} of "
                     f"{dc.K3_PROBS_LIMIT} per kind {dc.ROW_KINDS}")
            errs.append(float((probs - ref_probs).abs().max()))
            buf = torch.full((t, b, 3, s), float("nan"), device=dev)
            slots = [-1] * h
            slots[7], slots[0] = 2, 0
            again = ad.cross_attend_q8(*args, probs_out=buf.permute(1, 2, 0, 3), probs_slots=slots)
            if not (torch.equal(again, plain_out) and torch.equal(buf[:, :, 2], probs[:, 7].transpose(0, 1))
                    and torch.equal(buf[:, :, 0], probs[:, 0].transpose(0, 1)) and bool(buf[:, :, 1].isnan().all())):
                fail(f"cross_attend_q8_probs B={b} T={t}: the slots of a strided buffer were not written as named")
            del args, probs, ref_probs, buf
    say(f"phase 3 cross_attend_q8_probs check, worst row / limit ({dc.K3_PROBS_LIMIT} absolute) per kind "
        f"{dc.ROW_KINDS}: " + "; ".join(f"{k} {[float(f'{x:.3g}') for x in w.values()]}" for k, w in worst.items())
        + f"; output bit for bit the plain launch's; strided slots written as named | {card}")

    b = GROUP
    one = [torch.empty((b, 1, 1, s), device=dev) for _ in range(2)]
    every = [torch.empty((b, h, 1, s), device=dev) for _ in range(2)]
    one_slot = [0] + [-1] * (h - 1)
    times = {
        "k3": cuda_ms(torch, lambda i: ad.cross_attend_q8(qi, q_scale, *kv[i % 2], v_scale), 20),
        "one": cuda_ms(torch, lambda i: ad.cross_attend_q8(qi, q_scale, *kv[i % 2], v_scale, probs_out=one[i % 2],
                                                           probs_slots=one_slot), 20),
        "all": cuda_ms(torch, lambda i: ad.cross_attend_q8(qi, q_scale, *kv[i % 2], v_scale, probs_out=every[i % 2],
                                                           probs_slots=list(range(h))), 20),
    }

    def plain_probs(i):
        out, probs = ad.cross_attend_q8_reference(qi, q_scale, *kv[i % 2], v_scale, return_probs=True)
        ad.write_head_probs(probs, one[i % 2], one_slot)

    plain = cuda_ms(torch, plain_probs, 5)
    ops = 4 * b * h * s * 64
    all_heads = {"ms": times["all"], **bound(k3_bytes(b, h, s, 1, h), ops, "int8")}
    say(f"phase 3 cross_attend_q8_probs B=32 T=1 events: one head {times['one']:.4f} ms, all 20 heads "
        f"{times['all']:.4f} ms, plain K3 {times['k3']:.4f} ms, plain version (one head) {plain:.4f} ms | {card}")
    return {"max_abs_err": max(errs), "tolerance": dc.K3_PROBS_LIMIT, "ms": times["one"], "plain_ms": plain,
            **bound(k3_bytes(b, h, s, 1, 1), ops, "int8"), "library_ms": None, "k3_event_ms": times["k3"],
            "all_heads": all_heads}


def phase_traced_times(card: str, results: dict, checks: dict) -> None:
    """Run `traced_times` in a process of its own, so that its profiler
    sessions leave this process's launches, and phases 4-8, as they were.
    Adds K1's, K2's (with SDPA's beside it, at B = 32, B = 2 and in the
    split form) and K3's device times to `results`, and the probs form's
    beside plain K3's, and records K4 and K5 with their `checks` (max abs
    error, a note, the tolerance)."""
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
    k3, probs = results["cross_attend_q8"], results["cross_attend_q8_probs"]
    k3["device_ms"] = timed["k3"]["plain"]
    probs["device_ms"], probs["all_heads"]["device_ms"] = timed["k3"]["one"], timed["k3"]["all"]
    probs["k3_device_ms"] = timed["k3"]["plain"]
    say(f"phase 3 cross_attend_q8 B=32 T=1 by device time: plain {k3['device_ms']:.4f} ms (bound "
        f"{k3['bound_ms']:.4f}, {100 * k3['bound_ms'] / k3['device_ms']:.1f}% of it); probs form, one head "
        f"{probs['device_ms']:.4f} ms (bound {probs['bound_ms']:.4f}, {100 * probs['bound_ms'] / probs['device_ms']:.1f}%), "
        f"all 20 heads {probs['all_heads']['device_ms']:.4f} ms (bound {probs['all_heads']['bound_ms']:.4f}, "
        f"{100 * probs['all_heads']['bound_ms'] / probs['all_heads']['device_ms']:.1f}%) | {card}")
    k2 = results["mha_encoder"]
    for shape, t in timed["k2"].items():
        into = k2 if shape == f"b{GROUP}" else k2[shape]
        into.update({"device_ms": t["kernel"]["device_ms"], "host_us": t["kernel"]["host_us"],
                     "library_device_ms": t["library"]["device_ms"]})
        say(f"phase 3 mha_encoder {shape} by device time: kernel {into['device_ms']:.4f} ms (event "
            f"{t['kernel']['ms']:.4f}, host {into['host_us']:.1f} µs/call) | SDPA {into['library_device_ms']:.4f} ms "
            f"(event {t['library']['ms']:.4f}) | bound {into['bound_ms']:.4f} ms ({into['bound_by']}, "
            f"{100 * into['bound_ms'] / into['device_ms']:.1f}% of it), exp bound {into['exp_bound_ms']:.4f} ms"
            f" | {card}")
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
           "self_attend_q8": time_self_attend_q8(torch, g, dev, traces),
           "k3": time_cross_attend_q8(torch, g, dev, traces),
           "k2": time_mha_encoder(torch, g, dev, traces)}
    audio = [torch.randn((GROUP, 480_000), generator=g, device=dev) * 0.1 for _ in range(2)]
    k1 = {}
    traces.append((k1, lambda i: mel.log_mel_frames(audio[i % 2], 128), 20, "log_mel_kernel", 1))
    for times, fn, iters, kernel, per_call in traces:
        times["device_ms"] = device_ms(torch, fn, iters, kernel, per_call)
    out["log_mel_device_ms"] = k1["device_ms"]
    out["k3"] = {form: t["device_ms"] for form, t in out["k3"].items()}
    return out


def time_mha_encoder(torch, g, dev, traces) -> dict:
    """K2 and SDPA on the same inputs: the head-split views of one
    [B, 1500, 3·20·64] projection at B = 32 (the main path's group) and
    B = 2, and the split form (B = 1, the last 750 query rows over all 1500
    keys); event time and host µs per call now, device time from the traces
    queued in `traces`. Returns {shape: {"kernel": figures, "library": ...}}."""
    import torch.nn.functional as F

    from whisperkit_tpu_torch.models.whisper import _split_heads
    from whisperkit_tpu_torch.ops import attention

    h, s = 20, 1500
    inputs = {}
    for b in (GROUP, 2):
        x = torch.randn((b, s, 3 * h * 64), generator=g, device=dev).to(torch.bfloat16)
        inputs[f"b{b}"] = [_split_heads(x[..., i * h * 64 : (i + 1) * h * 64], h) for i in range(3)]
    q, k, v = (torch.randn((1, h, s, 64), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    inputs["split"] = [q[:, :, s // 2 :], k, v]
    out = {}
    for shape, qkv in inputs.items():
        iters = 20 if shape == f"b{GROUP}" else 50
        out[shape] = {
            "kernel": launch_times(torch, lambda i, t=qkv: attention.mha_encoder(*t), iters, traces,
                                   "mha_encoder_bf16_kernel"),
            "library": launch_times(torch, lambda i, t=qkv: F.scaled_dot_product_attention(*t), iters, traces),
        }
    return out


def time_cross_attend_q8(torch, g, dev, traces) -> dict:
    """Plain K3 and its probs form (one head, all 20) at B=32 T=1 S=1500 on
    two random K/V sets that alternate (246 MB: launches read device
    memory); queues their device-time traces. Returns {form: figures}."""
    from whisperkit_tpu_torch.ops import attention_decode as ad

    b, h, s = GROUP, 20, 1500
    kv = [tuple(torch.randint(-127, 128, (b, h, s, 64), generator=g, device=dev, dtype=torch.int8) for _ in range(2))
          for _ in range(2)]
    qi = torch.randint(-127, 128, (b, h, 1, 64), generator=g, device=dev, dtype=torch.int8)
    q_scale = torch.rand((b, h, 1, 1), generator=g, device=dev) * 2e-5 + 1e-5
    v_scale = torch.rand((b, h, 1, 64), generator=g, device=dev) * 0.02 + 0.005
    one = torch.empty((b, 1, 1, s), device=dev)
    every = torch.empty((b, h, 1, s), device=dev)
    forms = {
        "plain": lambda i: ad.cross_attend_q8(qi, q_scale, *kv[i % 2], v_scale),
        "one": lambda i: ad.cross_attend_q8(qi, q_scale, *kv[i % 2], v_scale, probs_out=one,
                                            probs_slots=[0] + [-1] * (h - 1)),
        "all": lambda i: ad.cross_attend_q8(qi, q_scale, *kv[i % 2], v_scale, probs_out=every,
                                            probs_slots=list(range(h))),
    }
    out = {}
    for form, fn in forms.items():
        out[form] = {}
        traces.append((out[form], fn, 50, "cross_attend_q8_kernel", 1))
    return out


# the main path's self-KV cache length: the 3-token prompt and
# min(224, MAX_TOKEN_CONTEXT - 3) = 221 new tokens
S_SELF = 224
# K5's launches per CUDA graph in its in-graph timing (the decode step
# replays it from a graph)
GRAPH_LAUNCHES = 50


def bound_of(t: dict) -> dict:
    return {"bound_ms": t["bound_ms"], "bound_by": t["bound_by"]}


def self_fields(times: dict, s: int) -> dict:
    """K4/K5's extra fields of the kernels line: device and host times at
    S - 1 (every key visible) and the figures at S/2; K5's at every timed
    position, eager and in a graph, with the share of the bound."""
    full, half = times[s - 1], times[s // 2]
    fields = {"device_ms": full["kernel"]["device_ms"], "host_us": full["kernel"]["host_us"],
              "at_half": {"pos": s // 2, **half["kernel"], **bound_of(half)}}
    if "graph" in full:
        fields["by_position"] = {
            pos: {"device_ms": t["kernel"]["device_ms"], "graph_device_ms": t["graph"]["device_ms"],
                  "graph_ms": t["graph"]["ms"], **bound_of(t),
                  "share": t["bound_ms"] / t["kernel"]["device_ms"],
                  "graph_share": t["bound_ms"] / t["graph"]["device_ms"]}
            for pos, t in times.items()
        }
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
        graph = ""
        if "graph" in t:
            graph = (f" | in a graph of {GRAPH_LAUNCHES} launches: event {t['graph']['ms']:.4f} ms, device "
                     f"{t['graph']['device_ms']:.4f} ms ({100 * t['bound_ms'] / t['graph']['device_ms']:.1f}% "
                     "of the bound)")
        say(f"phase 3 {key} S={S_SELF} pos {pos}: kernel event {k['ms']:.4f} ms, device {k['device_ms']:.4f} ms, "
            f"host {k['host_us']:.1f} µs/call{lib}{graph} | bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{100 * t['bound_ms'] / k['device_ms']:.1f}% of it by device time) | {card}")


# K1's limit, in units of the float32 plain version's own error against
# float64: 3xTF32 keeps 22 of float32's 24 bits of each operand, and its
# dropped terms (the two residuals and lo·lo) come to ≤ 3 · 2^-22 of a
# product against float32's 2^-24 rounding: 12x, rounded up
K1_ERR_FACTOR = 16


def check_log_mel(torch, randn_audio, dev, card, n_mels: int = 128):
    """K1 against its plain version computed in float64, on the timing's
    random audio (B windows) and on B windows of tools.workload's speech-like
    audio (bursts and pauses: quiet frames put mel bins near the 1e-10
    floor, where float32 itself errs by ~1e-3 in log10): the raw log10 mel
    and the model's input (clamped, normalised) each within K1_ERR_FACTOR
    times the error of the float32 plain version. Plain TF32 (one product,
    emulated in torch: ~2^-11 of a product) must exceed that limit.
    Returns (the kernel's raw error on speech-like audio, its limit, a
    note)."""
    from whisperkit_tpu_torch.ops import mel
    from whisperkit_tpu_torch.tools.workload import synth_speechlike_audio

    b = randn_audio.shape[0]
    speech = synth_speechlike_audio(b * mel.WINDOW_SAMPLES / mel.SAMPLE_RATE)
    inputs = {"random": randn_audio,
              "speech-like": torch.from_numpy(speech.reshape(b, mel.WINDOW_SAMPLES)).to(dev)}
    notes, result = [], None
    for name, audio in inputs.items():
        padded = mel._padded_rows(audio, mel.N_FRAMES)
        exact = mel.log_mel_frames_reference(padded, n_mels, mel.N_FRAMES, torch.float64)
        exact_n = mel.normalize_log_mel(exact)
        forms = {
            "kernel": mel.log_mel_frames(audio, n_mels),
            "float32": mel.log_mel_frames_reference(padded, n_mels, mel.N_FRAMES),
            "tf32": mel.log_mel_frames_3xtf32(padded, n_mels, mel.N_FRAMES, products=1),
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
    say(f"phase 3 log_mel check at B={b} n_mels={n_mels} (limit: {K1_ERR_FACTOR}x the float32 plain version's "
        f"error): {'; '.join(notes)} | {card}")
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
            "exp_bound_ms": b * h * s * s / PEAK_EXP_PER_S * 1e3,
        }
        del x, views
    # the split form (the sequence-parallel encoder at tp = 2): B=1, the
    # second half of the query rows over all 1500 keys, the same row kinds
    # and limit; its own plain version over the same rows
    q, k, v = k2_check.check_inputs(1, h, s, g, dev)
    sq = s // 2
    q_half = q[:, :, s - sq :]
    out = attention.mha_encoder(q_half, k, v)
    ref = attention.mha_encoder_reference(q_half, k, v)
    ratio = k2_check.excess(out, ref)
    half_kinds = kinds[s - sq :]
    worst_split = [float(ratio[..., half_kinds == i].max()) for i in range(3)]
    if not max(worst_split) <= 1.0 or not bool(torch.isfinite(out.float()).all()):
        fail(f"mha_encoder split form (queries {sq}, keys {s}): worst row at {worst_split} of its limit")
    if not torch.equal(out, attention.mha_encoder(q, k, v)[:, :, s - sq :]):
        fail("mha_encoder split form: its rows are not bit-equal to the same rows of the full launch")
    split = {
        "max_abs_err": max_abs(torch, out, ref), "worst_row": max(worst_split), "queries": sq, "keys": s,
        "ms": cuda_ms(torch, lambda i: attention.mha_encoder(q_half, k, v), 10),
        "plain_ms": cuda_ms(torch, lambda i: attention.mha_encoder_reference(q_half, k, v), 3),
        "library_ms": cuda_ms(torch, lambda i: F.scaled_dot_product_attention(q_half, k, v), 10),
        **bound((2 * sq + 2 * s) * h * 64 * 2, 4 * h * sq * s * 64, "bf16"),
        "exp_bound_ms": h * sq * s / PEAK_EXP_PER_S * 1e3,
    }
    say(f"phase 3 mha_encoder bf16 split form B=1 queries {sq} keys {s}: worst row {max(worst_split):.3f} of its "
        f"limit (per kind {[round(w, 3) for w in worst_split]}), max_abs_err {split['max_abs_err']:.3e} | kernel "
        f"{split['ms']:.4f} ms | plain {split['plain_ms']:.4f} ms | library (SDPA) {split['library_ms']:.4f} ms | "
        f"bound {split['bound_ms']:.4f} ms ({split['bound_by']}, {100 * split['bound_ms'] / split['ms']:.1f}% of it)"
        f" | {card}")
    del q, k, v, q_half, out, ref
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
    return {"max_abs_err": err, **times[GROUP], "b2": times[2], "split": split}


def check_self_attend(torch, g, dev, card) -> tuple[float, str]:
    """K4 against its plain version at S=224 on the check inputs of
    tools/decode_attn_check.py (peaked rows with the max in the last, ragged
    chunk of the kernel's split or in the first, near-flat rows), at B=4 and
    B=32, the mask open to 0, 31, S/2 and S-1: each row within 1e-5 (float32
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
    return max(errs), f" | bf16 cache S={s}, checked at B=4 and 32, pos {list(dc.positions(s))}; timed at B=32"


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


# K5's check shapes beside the main path's (B=4 and 32 at S=224): a
# cache length that is not a multiple of 4 (its scale rows are not 16-byte
# aligned), and the decode loop's longest (2 · 224)
Q8_CHECK_SHAPES = ((4, S_SELF), (GROUP, S_SELF), (4, 229), (GROUP, 448))


def check_self_attend_q8(torch, g, dev, card) -> tuple[float, str, float]:
    """K5 against its plain version on the check inputs of
    tools/decode_attn_check.py (peaked rows with the max near the end of the
    visible keys or near the start, near-flat rows; query and cache
    quantized per row, the rows after the position unwritten: zero codes
    and scales) at Q8_CHECK_SHAPES, the mask open to 0, 31, S/2 and S-1:
    each row's error within K5_FLIPS · 127 · p_scale of that row (K5_FLIPS
    requantization flips). NaN in the masked rows' scales must leave the
    output unchanged (the kernel never reads them). The plain model of the
    kernel's algorithm with each of its faults must exceed the limit on the
    B=4 S=224 inputs. Rows built to round at exact ties must give the exact
    half-to-even output. Returns (max abs err, a note, the largest row
    limit)."""
    from whisperkit_tpu_torch.ops import attention_decode
    from whisperkit_tpu_torch.tools import decode_attn_check as dc

    b, h = GROUP, 20
    errs, tols, worst, small = [], [], {}, []
    for batch, s in Q8_CHECK_SHAPES:
        for pos in dc.positions(s):
            args = dc.check_inputs_q8(batch, h, s, pos, g, dev)
            out = attention_decode.self_attend_q8(*args)
            ref = attention_decode.self_attend_q8_reference(*args)
            limit = dc.q8_row_limit(args)
            ratio = dc.excess(out, ref, limit)
            key = f"B={batch} S={s} pos {pos}"
            worst[key] = dc.worst_by_kind(ratio)
            if not float(ratio.max()) <= 1.0 or not bool(torch.isfinite(out).all()):
                fail(f"self_attend_q8 {key}: worst row at {worst[key]} of its "
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
                    fail(f"self_attend_q8 {key}: NaN in the masked rows' scales changed the output")
            if (batch, s) == (4, S_SELF):
                small.append(args)
    tol_row = torch.cat(tols)
    say(f"phase 3 self_attend_q8 check, worst row / limit ({dc.K5_FLIPS} flips × 127 × p_scale) per kind "
        f"{dc.ROW_KINDS}: " + "; ".join(f"{key} {[float(f'{x:.3g}') for x in w.values()]}" for key, w in worst.items())
        + f"; NaN in the masked rows' scales leaves the output unchanged | {card}")
    faults = dc.q8_fault_table(small)
    if not dc.separates(faults, "block"):
        fail(f"self_attend_q8: the limit does not separate the kernel's algorithm from its faults {faults}")
    say(f"phase 3 self_attend_q8 faults at B=4 (worst row / limit per position and kind): {json.dumps(faults)}")
    s = S_SELF  # the tie rows and the timing: the main path's length

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
    shapes = ", ".join(f"B={batch} S={n} pos {list(dc.positions(n))}" for batch, n in Q8_CHECK_SHAPES)
    extra = (f" | int8 cache S={s}, checked at {shapes}; limit per row "
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
    """K5 at S=224, the mask open to 0, 31, S/2 and S-1, on four random
    cache sets (codes and per-token scales, 79 MB) that rotate so launches
    read device memory: eager, and replayed from a CUDA graph of
    GRAPH_LAUNCHES launches (as the decode step runs it), and the plain
    version's CUDA-event ms at S-1; the device-time traces join `traces`.
    Returns {"plain_ms", "times": {position: figures}}."""
    from whisperkit_tpu_torch.ops import attention_decode
    from whisperkit_tpu_torch.tools import decode_attn_check as dc

    b, h, s = GROUP, 20, S_SELF
    sets = _q8_timing_inputs(torch, g, dev, 4)
    qi, q_scale = sets[0][:2]
    caches = [c[2:] for c in sets]
    times = {}
    for pos in dc.positions(s):
        mask_row = dc.mask_upto(s, pos, dev)
        n = pos + 1

        def launch(i, m=mask_row):
            return attention_decode.self_attend_q8(qi, q_scale, *caches[i % 4], m)

        graph = captured(torch, launch, GRAPH_LAUNCHES)
        times[pos] = {
            "kernel": launch_times(torch, launch, 50, traces, "self_attend_q8_kernel"),
            "graph": launch_times(torch, lambda i, gr=graph: gr.replay(), 4, traces, "self_attend_q8_kernel",
                                  GRAPH_LAUNCHES),
            # the visible keys' int8 codes and f32 scales of K and V, the
            # query, the mask row and the f32 output
            **bound(2 * b * h * n * (64 + 4) + qi.numel() + 4 * (q_scale.numel() + s + b * h * 64),
                    4 * b * h * n * 64, "int8"),
        }
    plain = cuda_ms(torch, lambda i: attention_decode.self_attend_q8_reference(qi, q_scale, *caches[i % 4], mask_row),
                    50)
    return {"plain_ms": plain, "times": times}


def graph_stats(by_device: bool = False) -> dict:
    """The CUDA graphs of decoding/graph.py (the decode step's, the TTS
    frame's) since the last reset: captures, replays and the captures'
    host seconds, summed over the devices, or per device."""
    from whisperkit_tpu_torch.decoding import graph

    if by_device:
        return {d: dict(v) for d, v in graph.stats_by_device.items()}
    total = dict.fromkeys(graph.STATS, 0)
    for per in graph.stats_by_device.values():
        for k, v in per.items():
            total[k] += v
    return total


def say_graph(stats: dict) -> str:
    return (f"graph: {stats['captures']} captures ({stats['capture_s']:.3f} s captured, {stats['instantiate_s']:.3f} s "
            f"instantiated), {stats['replays']} replays")


def transcribe_twice(torch, pipe, audio, options) -> dict:
    """One warm pass, then one timed pass with the launch counts (and the
    decode graph's counts) set to 0 just before it and read just after it."""
    from whisperkit_tpu_torch.decoding import graph
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
    graph.reset_stats()
    t0 = time.perf_counter()
    result = pipe.transcribe(audio, options, callback=on_window)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"result": result, "wall": wall, "warm": warm, "counts": dict(_build.launches),
            "peak": torch.cuda.max_memory_allocated(), "windows": windows, "graph": graph_stats()}


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
        f"| peak {run['peak'] / 2**30:.2f} GiB | launches {json.dumps(run['counts'])} | {say_graph(run['graph'])} "
        f"| {card}"
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
    if not run["graph"]["replays"]:
        fail(f"{label}: the decode loop replayed no CUDA graph: {run['graph']}")
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
        per_layer=("cross_attend_q8", "self_attend"), idle=("self_attend_q8", "w8a16_matmul"),
        extra=f", init_params {t_init:.1f} s",
    )
    return {"counts": run["counts"], "pipe": pipe, "audio": audio, "graph": run["graph"], "wall": run["wall"]}


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
        launched=("log_mel", "mha_encoder", "cross_attend_q8", "self_attend_q8", "w8a16_matmul"),
        per_layer=("cross_attend_q8", "self_attend_q8", "w8a16_matmul"), idle=("self_attend",),
        extra=f", quantize {t_quant:.3f} s",
    )
    say(f"  weights: W8A16 {q_bytes} bytes ({q_bytes / 2**30:.3f} GiB) vs bf16 {bf16_bytes} bytes "
        f"({bf16_bytes / 2**30:.3f} GiB); peak counts both trees resident")
    return {"counts": run["counts"], "pipe": pipe, "graph": run["graph"], "wall": run["wall"]}


def phase_step_parity(torch, label, pipe, audio, card) -> None:
    """One decoder step after prefill at large-v3 width: kernels vs plain,
    over the cache form the pipe's ComputeOptions select."""
    from unittest import mock

    from whisperkit_tpu_torch.decoding.loop import encode_window, prefill_window
    from whisperkit_tpu_torch.models import whisper as model
    from whisperkit_tpu_torch.ops import attention_decode as ad
    from whisperkit_tpu_torch.ops import quant

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
            mock.patch.object(model, "cross_attend_q8", ad.cross_attend_q8_reference), \
            mock.patch.object(quant, "w8a16_matmul", lambda x, qs, biases: [
                quant.quantized_matmul_reference(x, q, b) for q, b in zip(qs, biases)]):
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


class Spy:
    """Within the `with` block, `module.name` is wrapped: `before` sees each
    call's arguments, and each call's result joins `calls`."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []

    def before(self, *args, **kwargs) -> None:
        pass

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            self.before(*args, **kwargs)
            out = self.orig(*args, **kwargs)
            self.calls.append(out)
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class StepLogits(Spy):
    """Spy on the decode loop's sampler: for each step, the filtered
    logits' top-2 gap and the margin of the best token other than EOT over
    EOT, [B] device tensors each (three small launches a step). A replay
    of the step's CUDA graph makes no Python call, so the loops it records
    run eagerly (`cuda_graph=False`): the recorded runs are references."""

    def __init__(self, eot: int):
        from whisperkit_tpu_torch.decoding import loop

        super().__init__(loop, "sample_token")
        self.loop, self.eot, self.gaps, self.margins = loop, eot, [], []

    def __enter__(self):
        self.start = self.loop._start
        self.loop._start = lambda *args, **kwargs: self.start(*args, **{**kwargs, "cuda_graph": False})
        return super().__enter__()

    def __exit__(self, *exc):
        self.loop._start = self.start
        super().__exit__(*exc)

    def before(self, logits, *args, **kwargs) -> None:
        top2 = logits.topk(2, dim=-1).values
        self.gaps.append(top2[:, 0] - top2[:, 1])
        others = logits.clone()
        others[:, self.eot] = float("-inf")
        self.margins.append(others.amax(dim=-1) - logits[:, self.eot])


def divergences(label, ours, ref, gaps, sample_begin: int) -> int:
    """Rows of `ours` and `ref` ([B, TOTAL] tokens) that match exactly;
    fail where a row's first divergence sits at a top-2 gap of the
    reference's filtered logits (`gaps`, one [B] tensor per step) above
    BF16_GAP_TOL."""
    ours, ref = ours.tolist(), ref.tolist()
    same, report = 0, []
    for r, (a, b) in enumerate(zip(ours, ref)):
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if first is None:
            same += 1
            continue
        gap = float(gaps[first - sample_begin][r])
        report.append(f"row {r} from position {first} (gap {gap:.4f})")
        if gap > BF16_GAP_TOL:
            fail(f"{label}: row {r} diverges at position {first}, where the reference's top-2 gap is {gap:.4f} "
                 f"> {BF16_GAP_TOL}")
    say(f"{label}: {same} of {len(ours)} rows match exactly" + (f"; diverging: {', '.join(report)}" if report else ""))
    return same


def timed_transcribe(torch, pipe, audio, options) -> tuple:
    """(result, wall s, launch counts) of one transcribe with the launch
    counts (and the decode graph's, `graph_stats`) set to 0 just before it
    and read just after it."""
    from whisperkit_tpu_torch.decoding import graph
    from whisperkit_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    graph.reset_stats()
    t0 = time.perf_counter()
    result = pipe.transcribe(audio, options)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, dict(_build.launches)


# a word may sit across its segment's edge by up to the word timing rules'
# median-duration cap (0.7 s, text/word_timestamps.py) and 0.01 s rounding
WORD_EDGE_TOL = 0.71


def phase_word_timestamps(torch, card: str, pipe, audio) -> dict:
    """Phase 4's pipeline with ALIGNMENT_HEADS and word_timestamps=True on
    the 600 s run, one pass. Every K3 launch of a layer that holds an
    alignment head must be the probs form: per decoder pass, one probs-form
    launch on each such layer and a plain one on each other layer. Words
    are in order within each segment and inside it (WORD_EDGE_TOL). Then
    the host transfer of an alignment buffer of the group's size is timed."""
    import dataclasses

    from whisperkit_tpu_torch.tools.workload import pipeline_options

    label = "phase 9 word timestamps"
    dims = pipe.dims
    options = dataclasses.replace(pipeline_options(GROUP), word_timestamps=True)
    pipe.alignment_heads = ALIGNMENT_HEADS
    try:
        torch.cuda.reset_peak_memory_stats()
        result, wall, counts = timed_transcribe(torch, pipe, audio, options)
    finally:
        pipe.alignment_heads = None
    n_layer, n_align = dims.n_text_layer, len({layer for layer, _ in ALIGNMENT_HEADS})
    check_launches(label, counts, ("log_mel", "mha_encoder", "cross_attend_q8", "cross_attend_q8_probs", "self_attend"),
                   ("self_attend",), ("self_attend_q8",), n_layer)
    probs, plain = counts["cross_attend_q8_probs"], counts["cross_attend_q8"]
    passes = probs // n_align
    if probs % n_align or plain != (n_layer - n_align) * passes:
        fail(f"{label}: {probs} probs-form and {plain} plain K3 launches are not {n_align} and {n_layer - n_align} "
             f"per decoder pass: a launch on an alignment layer took the plain form")
    check_segments(label, result.segments)
    n_words, across, inverted = 0, 0, 0
    for seg in result.segments:
        words = seg.words or []
        if any(b.start < a.start or b.end < a.end for a, b in zip(words, words[1:])):
            fail(f"{label}: segment {seg.id}'s words are out of order: {[(w.start, w.end) for w in words]}")
        for w in words:
            if not (seg.start - WORD_EDGE_TOL <= w.start and w.end <= seg.end + WORD_EDGE_TOL):
                fail(f"{label}: word {w.word!r} [{w.start}, {w.end}] outside segment {seg.id} [{seg.start}, {seg.end}]")
            across += not (seg.start <= w.start and w.end <= seg.end)
            inverted += w.start > w.end
            n_words += 1
    if not n_words:
        fail(f"{label}: no words")
    t = result.timings
    total = 3 + 221
    buf = torch.zeros((total, GROUP, len(ALIGNMENT_HEADS), 1500), device="cuda")
    transfer = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf.cpu()
        transfer.append(time.perf_counter() - t0)
    del buf
    say(f"{label}: {AUDIO_SECONDS:.0f} s audio, {len(result.segments)} segments, {n_words} words ({across} across "
        f"their segment's edge by up to {WORD_EDGE_TOL} s, {inverted} with start after end) | wall {wall:.3f} s "
        f"(one pass) | decode loop {t.decoding_loop:.3f} s, word-timing host {t.decoding_timestamp_alignment:.3f} s "
        f"| {passes} decoder passes: K3 probs form {probs}, plain {plain} | alignment buffer [{total}, {GROUP}, "
        f"{len(ALIGNMENT_HEADS)}, 1500] f32 ({total * GROUP * len(ALIGNMENT_HEADS) * 1500 * 4 / 1e6:.1f} MB) to the "
        f"host in {min(transfer) * 1e3:.1f}-{max(transfer) * 1e3:.1f} ms | peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | launches {json.dumps(counts)} | "
        f"{say_graph(graph_stats())} | {card}")
    return {"counts": counts, "wall": wall, "words": n_words, "transfer_ms": min(transfer) * 1e3}


def phase_beam(torch, card: str, pipe, audio) -> dict:
    """Beam 5 through phase 4's pipeline (serving preset: beam search gets
    the raw bf16 cross-KV) on the first 60 s of the audio, one pass: its
    T==1 steps run K4 over B·K rows and no K3."""
    import dataclasses

    from whisperkit_tpu_torch.pipelines import whisper as pipeline_module
    from whisperkit_tpu_torch.tools.workload import pipeline_options

    label = "phase 10 beam 5"
    clip = audio[: 60 * 16_000]
    options = dataclasses.replace(pipeline_options(GROUP), beam_size=5)
    with Spy(pipeline_module, "beam_decode_loop") as beams:
        result, wall, counts = timed_transcribe(torch, pipe, clip, options)
    g = graph_stats()
    check_launches(label, counts, ("log_mel", "mha_encoder", "self_attend"), ("self_attend",),
                   ("cross_attend_q8", "cross_attend_q8_probs", "self_attend_q8"), pipe.dims.n_text_layer)
    check_segments(label, result.segments)
    if not g["replays"] or g["captures"] != 2 * len(beams.calls):
        fail(f"{label}: {len(beams.calls)} beam searches did not run on their two graphs each: {g}")
    lines = []
    for out in beams.calls:
        for r in range(out.tokens.shape[0]):
            toks = out.tokens[r, 3:].tolist()
            lines.append(f"row {r}: {toks[:8]}... sum log-prob {float(out.sum_logprob[r]):.3f}")
    b = beams.calls[0].tokens.shape[0]
    say(f"{label}: 60 s audio, {len(beams.calls)} group(s) of {b} windows × 5 beams = {5 * b} rows, "
        f"{len(result.segments)} segments | wall {wall:.3f} s (one pass), decode loop "
        f"{result.timings.decoding_loop:.3f} s | launches {json.dumps(counts)} | {say_graph(g)} | {card}")
    say(f"  {label} hypotheses: " + "; ".join(lines))
    return {"counts": counts, "wall": wall, "rows": 5 * b, "decode_loop": result.timings.decoding_loop, "graph": g}


def phase_segmented(torch, card: str, pipe, audio) -> dict:
    """Segmented decode with batch compaction on the 600 s run's 32-row
    group. Run A (the plain loop, no bias) records each step's margin of
    the best non-EOT logit over EOT; the EOT bias is set between the 20th
    and 21st smallest of the rows' least margins over the first three
    segments, so 20 rows end there at their own steps (the trajectory is
    the same until a row's EOT). Run B: segmented_decode=True with that
    bias, which must compact; run C: the same bias uncompacted, the
    reference for B's tokens. Run D: an early-stop flag set before the
    run stops every window after its first 32-token segment: each row's
    tokens are run A's first 32."""
    from whisperkit_tpu_torch.core.concurrency import EarlyStopFlag
    from whisperkit_tpu_torch.core.configurations import ComputeOptions, WhisperConfig
    from whisperkit_tpu_torch.decoding import loop
    from whisperkit_tpu_torch.pipelines import whisper as pipeline_module
    from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
    from whisperkit_tpu_torch.tools.workload import pipeline_options

    label = "phase 11 segmented decode"
    sp, n_layer = pipe.tokenizer.special, pipe.dims.n_text_layer
    options = pipeline_options(GROUP)
    begin, segment, first_segments = 3, 32, 3

    with StepLogits(sp.eot) as rec_a, Spy(pipeline_module, "decode_loop") as out_a:
        _, wall_a, _ = timed_transcribe(torch, pipe, audio, options)
    least = torch.stack(rec_a.margins[: first_segments * segment]).amin(dim=0).sort().values.tolist()
    if not least[20] < float("inf"):
        fail(f"{label}: EOT is allowed at too few rows' steps to set a bias: least margins {least}")
    bias = (least[19] + least[20]) / 2

    def biased(segmented: bool):
        p = WhisperPipeline(
            WhisperConfig(compute_options=ComputeOptions.serving(segmented_decode=segmented), load=False),
            dims=pipe.dims, params=pipe.params, device="cuda",
        )
        plain_bias = p._suppress_bias

        def with_eot_bias(o, *device):
            b = plain_bias(o, *device).clone()
            b[sp.eot] += bias
            return b

        p._suppress_bias = with_eot_bias
        return p

    sizes = []  # (step, rows after, rows still decoding) of each compaction
    compact = loop._compact
    loop._compact = lambda st, rows, n: (sizes.append((st.pos - begin, len(rows), n)), compact(st, rows, n))[1]
    try:
        with Spy(pipeline_module, "decode_loop_segmented") as out_b:
            result_b, wall_b, counts = timed_transcribe(torch, biased(True), audio, options)
    finally:
        loop._compact = compact
    check_launches(label, counts, ("log_mel", "mha_encoder", "cross_attend_q8", "self_attend"), (),
                   ("self_attend_q8", "cross_attend_q8_probs"), n_layer)
    check_segments(label, result_b.segments)
    if not sizes:
        fail(f"{label}: the decode never compacted (EOT bias {bias:.4f})")
    with StepLogits(sp.eot) as rec_c, Spy(pipeline_module, "decode_loop") as out_c:
        _, wall_c, _ = timed_transcribe(torch, biased(False), audio, options)
    ref = out_c.calls[0].tokens
    finish = ((ref[:, begin:] != sp.eot).sum(dim=1)).tolist()
    same_b = divergences(f"{label}, compacted vs uncompacted (EOT bias {bias:.4f})", out_b.calls[0].tokens,
                         ref, rec_c.gaps, begin)

    flag_pipe = WhisperPipeline(WhisperConfig(compute_options=ComputeOptions.serving(), load=False),
                                dims=pipe.dims, params=pipe.params, device="cuda")
    flag_pipe.early_stop_flag = EarlyStopFlag()
    flag_pipe.early_stop_flag.stop()
    with Spy(pipeline_module, "decode_loop_segmented") as out_d:
        _, wall_d, counts_d = timed_transcribe(torch, flag_pipe, audio, options)
    check_launches(f"{label}, early stop", counts_d, ("log_mel", "mha_encoder", "cross_attend_q8", "self_attend"),
                   ("self_attend",), ("self_attend_q8", "cross_attend_q8_probs"), n_layer)
    stopped = out_d.calls[0].tokens
    if not bool((stopped[:, begin + segment :] == sp.eot).all()):
        fail(f"{label}, early stop: a row decoded past its first segment")
    full_a = out_a.calls[0].tokens[:, : begin + segment]
    same_d = divergences(f"{label}, early stop vs run A's first {segment} tokens", stopped[:, : begin + segment],
                         full_a, rec_a.gaps, begin)
    say(f"{label}: EOT bias {bias:.4f} | rows' finish steps without compaction {sorted(finish)} | compacted at "
        f"(step, rows, active) {sizes} | walls: A (no bias, plain loop, step recorder) {wall_a:.3f} s, B (bias, "
        f"segmented + compaction) {wall_b:.3f} s, C (bias, plain loop, step recorder) {wall_c:.3f} s, D (early "
        f"stop after one segment) {wall_d:.3f} s | B: {len(result_b.segments)} segments, launches "
        f"{json.dumps(counts)} | {card}")
    return {"counts": counts, "walls": [wall_a, wall_b, wall_c, wall_d], "compactions": sizes, "same": same_b,
            "same_early_stop": same_d, "bias": bias}


def phase_speculative(torch, card: str, pipe, audio) -> dict:
    """Batch-1 speculative decoding through the pipeline: phase 4's weights
    and serving preset (int8 cross-KV) with a random distil-large-v3 draft
    (init_params(SEED + 1), bf16), on the first 30 s of the audio (the
    seek path, one window at a time). The pipeline without the draft is
    the reference (its step logits recorded); the first window's tokens
    are held against it. The target's K3 launches count its passes: one
    prefill and one verify per round (draft_k + 1 = 5 query rows); the
    draft's K4 launches are 5 T==1 steps per round on each of its 2 layers."""
    from whisperkit_tpu_torch.core.configurations import ComputeOptions, WhisperConfig
    from whisperkit_tpu_torch.decoding import speculative
    from whisperkit_tpu_torch.models.whisper import VARIANT_DIMS, init_params
    from whisperkit_tpu_torch.pipelines import whisper as pipeline_module
    from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
    from whisperkit_tpu_torch.tools.workload import pipeline_options

    label = "phase 12 speculative"
    sp, dims = pipe.tokenizer.special, pipe.dims
    draft_dims = VARIANT_DIMS["distil-large-v3"]
    draft = init_params(SEED + 1, draft_dims, torch.bfloat16)
    spec_pipe = WhisperPipeline(WhisperConfig(compute_options=ComputeOptions.serving(), load=False), dims=dims,
                                params=pipe.params, draft_dims=draft_dims, draft_params=draft)
    clip = audio[: 30 * 16_000]
    options = pipeline_options(1)
    with StepLogits(sp.eot) as rec, Spy(pipeline_module, "decode_loop") as plain:
        _, wall_plain, _ = timed_transcribe(torch, pipe, clip, options)
    with Spy(pipeline_module, "speculative_decode_loop") as spec:
        result, wall, counts = timed_transcribe(torch, spec_pipe, clip, options)
    g = graph_stats()
    if not g["replays"] or g["captures"] != len(spec.calls):
        fail(f"{label}: {len(spec.calls)} speculative decodes did not run on one graph each: {g}")
    check_launches(label, counts, ("log_mel", "mha_encoder", "cross_attend_q8", "self_attend"), ("cross_attend_q8",),
                   ("self_attend_q8", "cross_attend_q8_probs"), dims.n_text_layer)
    check_segments(label, result.segments)
    k = speculative.DRAFT_K
    rounds = counts["cross_attend_q8"] // dims.n_text_layer - len(spec.calls)
    if counts["self_attend"] != rounds * (k + 1) * draft_dims.n_text_layer:
        fail(f"{label}: {counts['self_attend']} draft K4 launches for {rounds} rounds of {k + 1} steps on "
             f"{draft_dims.n_text_layer} layers")
    committed = sum(int(out.length) - 3 for out in spec.calls)  # rounds: every one run, after a stop too
    same = divergences(f"{label}, first window vs the pipeline without the draft", spec.calls[0].tokens,
                       plain.calls[0].tokens, rec.gaps, 3)
    say(f"{label}: 30 s audio, windows {len(spec.calls)} (without the draft {len(plain.calls)}), "
        f"{len(result.segments)} segments | {committed} tokens in {rounds} rounds ({committed / max(rounds, 1):.3f} "
        f"per target pass) | wall {wall:.3f} s (decode loop {result.timings.decoding_loop:.3f} s), without the "
        f"draft {wall_plain:.3f} s (with the step recorder), both one pass | launches {json.dumps(counts)} | "
        f"{say_graph(g)} | {card}")
    return {"counts": counts, "wall": wall, "wall_plain": wall_plain, "rounds": rounds, "same": same,
            "decode_loop": result.timings.decoding_loop, "graph": g, "draft": (draft, draft_dims)}


def group_mel(pipe, audio, options):
    """The mel of the first group that pipe.transcribe decodes on one
    device (its length-sorted VAD chunks, zero windows padding the group
    to the power-of-two bucket of the chunks, at most GROUP rows, as the
    pipeline pads a partial group)."""
    import math

    import numpy as np

    chunks = pipe._vad_chunks(audio, options)
    rows = min(GROUP, 1 << max(0, math.ceil(math.log2(len(chunks)))))
    order = sorted(range(len(chunks)), key=lambda i: len(chunks[i].audio_samples))[:rows]
    windows = [audio[c.seek_offset_index : c.seek_offset_index + min(len(c.audio_samples), 480_000)]
               for c in (chunks[i] for i in order)]
    windows += [np.zeros(480_000, np.float32)] * (rows - len(windows))
    return pipe._mel_batch(windows)


class DoneSpy(Spy):
    """Spy on the decode loop's `_release`, called once per decode and on
    each compaction: the `done` mask and host position it found."""

    def __init__(self):
        from whisperkit_tpu_torch.decoding import loop

        super().__init__(loop, "_release")
        self.done = []

    def before(self, st) -> None:
        self.done.append((st.done.clone(), st.pos))


def phase_decode_graph(torch, card: str, bf16_pipe, w8_params, audio, eot_bias: float) -> dict:
    """Phase 25: the decode loop's CUDA graph of the step (decoding/graph.py)
    against the eager loop (`cuda_graph=False`) on phase 4's 32-window
    group, encoded and prefilled once per case, each decode from the same
    prefill: (a) bf16 serving; (b) phase 6's W8A16 tree with the int8
    self-KV cache (K5 in place of K4); (c) bf16 with ALIGNMENT_HEADS (K3's
    probs form); (d) temperature 0.5, top-k 5, one generator seeded alike
    for each run; (e) segmented decode with compaction under phase 11's
    EOT bias, which must compact and capture once more per compaction.
    Tokens, token log-probabilities, the `done` mask and (c) the alignment
    buffer must be bit-equal (the same kernels on the same inputs in the
    same order), and the kernels' launches equal: the graph's are counted
    through its replays. Walls, the capture's and instantiation's host
    seconds and the replays are printed."""
    from whisperkit_tpu_torch.decoding import graph
    from whisperkit_tpu_torch.decoding import loop
    from whisperkit_tpu_torch.ops import _build
    from whisperkit_tpu_torch.pipelines.whisper import MAX_TOKEN_CONTEXT
    from whisperkit_tpu_torch.tools.workload import pipeline_options

    label = "phase 25 decode graph"
    pipe, dims, sp = bf16_pipe, bf16_pipe.dims, bf16_pipe.tokenizer.special
    options = pipeline_options(GROUP)
    mel = group_mel(pipe, audio, options)
    prompt, sot_index = pipe._build_prompt(options, "en")
    prompt = torch.tensor([prompt] * GROUP, dtype=torch.long, device=pipe.device)
    common = dict(dims=dims, special=sp, sample_begin=prompt.shape[1], top_k=options.top_k, sot_index=sot_index,
                  use_timestamp_rules=not options.without_timestamps, suppress_blank=options.suppress_blank)
    max_new = min(options.sample_length, MAX_TOKEN_CONTEXT - prompt.shape[1])
    suppress = pipe._suppress_bias(options)
    biased = suppress.clone()
    biased[sp.eot] += eot_bias
    cases = {
        "a": dict(params=pipe.params, q8_self=False, heads=None, temperature=0.0, segmented=False),
        "b": dict(params=w8_params, q8_self=True, heads=None, temperature=0.0, segmented=False),
        "c": dict(params=pipe.params, q8_self=False, heads=ALIGNMENT_HEADS, temperature=0.0, segmented=False),
        "d": dict(params=pipe.params, q8_self=False, heads=None, temperature=0.5, segmented=False),
        "e": dict(params=pipe.params, q8_self=False, heads=None, temperature=0.0, segmented=True),
    }
    out = {}
    for key, case in cases.items():
        params = case["params"]
        with torch.inference_mode():
            _, ck, cv = loop.encode_window(params, mel, dims, quantize_kv=True)
        pre = loop.prefill_window(params, ck, cv, prompt, **{k: common[k] for k in ("dims", "special", "sample_begin")},
                                  max_new_tokens=max_new, sot_index=sot_index, alignment_heads=case["heads"],
                                  quantize_self_kv=case["q8_self"])
        runs = {}
        for mode in ("eager", "graph"):
            scalars = pipe._decode_scalars(options, case["temperature"], 0)
            if case["temperature"] > 0:
                scalars = scalars._replace(generator=torch.Generator(device=pipe.device).manual_seed(SEED))
            kw = dict(common, max_new_tokens=max_new, alignment_heads=case["heads"], prefill=pre,
                      cuda_graph=mode == "graph")
            if case["temperature"] > 0:
                kw["top_k"] = 5
            sizes = []
            compact = loop._compact
            loop._compact = lambda st, rows, n: (sizes.append(len(rows)), compact(st, rows, n))[1]
            try:
                with DoneSpy() as spy:
                    torch.cuda.synchronize()
                    _build.reset_launches()
                    graph.reset_stats()
                    t0 = time.perf_counter()
                    if case["segmented"]:
                        res = loop.decode_loop_segmented(params, ck, cv, prompt, biased, scalars, compact=True, **kw)
                    else:
                        res = loop.decode_loop(params, ck, cv, prompt, suppress, scalars, **kw)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                loop._compact = compact
            runs[mode] = {"out": res, "wall": wall, "counts": dict(_build.launches), "graph": graph_stats(),
                          "done": spy.done[-1][0], "compactions": sizes}
        eager, graphed = runs["eager"], runs["graph"]
        equal = {
            "tokens": torch.equal(eager["out"].tokens, graphed["out"].tokens),
            "logprobs": torch.equal(eager["out"].token_logprobs, graphed["out"].token_logprobs),
            "done": torch.equal(eager["done"], graphed["done"]),
            "length": eager["out"].length == graphed["out"].length,
        }
        if case["heads"] is not None:
            equal["alignment"] = torch.equal(eager["out"].alignment, graphed["out"].alignment)
        kernels = {k: (eager["counts"][k], graphed["counts"][k]) for k in _build.KERNELS if eager["counts"][k]
                   or graphed["counts"][k]}
        g = graphed["graph"]
        line = (f"{label} ({key}) {'W8A16 + int8 self-KV' if case['q8_self'] else 'bf16'}"
                f"{', alignment heads' if case['heads'] else ''}{', T 0.5 top-k 5' if case['temperature'] else ''}"
                f"{f', segmented, EOT bias {eot_bias:.4f}' if case['segmented'] else ''}: bit-equal {json.dumps(equal)} "
                f"| walls eager {eager['wall']:.3f} s, graph {graphed['wall']:.3f} s | {say_graph(g)} | launches "
                f"(eager, graph) {json.dumps(kernels)}")
        if case["segmented"]:
            line += f" | compactions to {graphed['compactions']} rows (eager {eager['compactions']})"
        say(f"{line} | {card}")
        if not all(equal.values()):
            fail(f"{label} ({key}): the graph's decode differs from the eager loop's: {equal}")
        if any(a != b for a, b in kernels.values()):
            fail(f"{label} ({key}): launches differ between the eager loop and the graph: {kernels}")
        if eager["graph"]["captures"] or not g["replays"]:
            fail(f"{label} ({key}): eager {eager['graph']}, graph {g}")
        if case["segmented"] and (not graphed["compactions"] or g["captures"] != len(graphed["compactions"]) + 1):
            fail(f"{label} ({key}): {len(graphed['compactions'])} compactions, {g['captures']} captures")
        out[key] = {"equal": equal, "eager_wall": eager["wall"], "graph_wall": graphed["wall"], "graph": g,
                    "launches": {k: b for k, (_, b) in kernels.items()}, "compactions": graphed["compactions"]}
        del runs, eager, graphed, pre, ck, cv
    return out


def timed_graph_pair(torch, run) -> dict:
    """run(cuda_graph) once eagerly and once on the graph, each with the
    launch and graph counts set to 0 just before it and read just after:
    {"eager" | "graph": {"out", "wall", "counts", "graph"}}."""
    from whisperkit_tpu_torch.decoding import graph
    from whisperkit_tpu_torch.ops import _build

    runs = {}
    for mode in ("eager", "graph"):
        torch.cuda.synchronize()
        _build.reset_launches()
        graph.reset_stats()
        t0 = time.perf_counter()
        out = run(mode == "graph")
        torch.cuda.synchronize()
        runs[mode] = {"out": out, "wall": time.perf_counter() - t0, "counts": dict(_build.launches),
                      "graph": graph_stats()}
    return runs


def check_graph_pair(label, runs, equal: dict, captures: int, steps: int, card: str, extra: str = "") -> dict:
    """Fail unless every field of `equal` holds, the launches are the
    eager run's, the eager run made no graph and the graph run made
    `captures` captures and `steps - captures` replays; print the line."""
    from whisperkit_tpu_torch.ops import _build

    eager, graphed = runs["eager"], runs["graph"]
    kernels = {k: (eager["counts"][k], graphed["counts"][k]) for k in _build.KERNELS
               if eager["counts"][k] or graphed["counts"][k]}
    g = graphed["graph"]
    say(f"{label}: bit-equal {json.dumps(equal)} | walls eager {eager['wall']:.3f} s, graph {graphed['wall']:.3f} s "
        f"| {say_graph(g)} | launches (eager, graph) {json.dumps(kernels)}{extra} | {card}")
    if not all(equal.values()):
        fail(f"{label}: the graph's decode differs from the eager loop's: {equal}")
    if any(a != b for a, b in kernels.values()):
        fail(f"{label}: launches differ between the eager loop and the graph: {kernels}")
    if eager["graph"]["captures"] or g["captures"] != captures or g["replays"] != steps - captures:
        fail(f"{label}: {steps} steps or rounds, eager {eager['graph']}, graph {g} (expected {captures} captures)")
    return {"equal": equal, "eager_wall": eager["wall"], "graph_wall": graphed["wall"], "graph": g,
            "launches": {k: b for k, (_, b) in kernels.items()}}


def phase_search_graphs(torch, card: str, pipe, draft_params, draft_dims, audio, eot_bias: float) -> dict:
    """Phase 27: beam search's CUDA graphs (one per parity of the position)
    and speculative decoding's (one round) against their eager loops
    (`cuda_graph=False`). Beam 5 on phase 10's group (the first 60 s, its
    VAD windows padded to the pipeline's power-of-two bucket, the raw bf16
    cross-KV), with no bias and with phase 11's EOT bias: tokens, token
    log-probs, sums, no_speech_prob and `length` bit-equal, K4's launches
    equal, two captures and a replay for every later step with a decoder
    (K4's launches over the layers). Speculative on phase 12's first VAD
    window (of the first 30 s; bf16, int8 cross-KV) with its random
    distil-large-v3 draft, and with the target as its own draft
    (the draft reading the same int8 cross-KV): tokens, log-probs,
    `length` and the rounds that committed bit-equal, K3's and K4's
    launches equal, one capture and a replay for every later round (K3's
    launches: one verify pass a round, plus the self-draft's k + 1 steps);
    the self-draft must commit more than one token a target pass."""
    import dataclasses

    from whisperkit_tpu_torch.decoding import beam, loop, speculative
    from whisperkit_tpu_torch.pipelines.whisper import MAX_TOKEN_CONTEXT
    from whisperkit_tpu_torch.tools.workload import pipeline_options

    label = "phase 27 search graphs"
    dims, sp = pipe.dims, pipe.tokenizer.special
    n_layer = dims.n_text_layer
    out = {}

    # beam search on phase 10's group
    options = dataclasses.replace(pipeline_options(GROUP), beam_size=5)
    mel = group_mel(pipe, audio[: 60 * 16_000], options)
    with torch.inference_mode():
        _, ck, cv = loop.encode_window(pipe.params, mel, dims)
    base, sot_index = pipe._build_prompt(options, "en")
    prompt = torch.tensor([base] * mel.shape[0], dtype=torch.long, device=pipe.device)
    max_new = min(options.sample_length, MAX_TOKEN_CONTEXT - prompt.shape[1])
    suppress = pipe._suppress_bias(options)
    for case, bias in (("no bias", 0.0), ("EOT bias", eot_bias)):
        biased = suppress.clone()
        biased[sp.eot] += bias

        def run(cuda_graph):
            return beam.beam_decode_loop(
                pipe.params, ck, cv, prompt, biased, pipe._decode_scalars(options, 0.0, 0).max_initial_timestamp_index,
                dims=dims, special=sp, sample_begin=prompt.shape[1], max_new_tokens=max_new, beam_size=5,
                sot_index=sot_index, use_timestamp_rules=True, suppress_blank=options.suppress_blank,
                length_penalty=options.length_penalty, cuda_graph=cuda_graph,
            )

        runs = timed_graph_pair(torch, run)
        e, g = runs["eager"]["out"], runs["graph"]["out"]
        equal = {f: torch.equal(getattr(e, f), getattr(g, f))
                 for f in ("tokens", "token_logprobs", "sum_logprob", "no_speech_prob")}
        equal["length"] = e.length == g.length
        steps = runs["eager"]["counts"]["self_attend"] // n_layer  # steps with a decoder
        out[f"beam, {case}"] = check_graph_pair(
            f"{label} beam 5, {mel.shape[0]} windows x 5 beams, {case}", runs, equal, 2, steps, card,
            f" | length {g.length} of {prompt.shape[1] + max_new}, {steps} steps with a decoder")
    del ck, cv

    # speculative decoding on phase 12's first window
    options = pipeline_options(1)
    clip = audio[: 30 * 16_000]
    first = pipe._vad_chunks(clip, options)[0]
    mel = pipe._mel_batch([clip[first.seek_offset_index : first.seek_offset_index + min(len(first.audio_samples),
                                                                                     480_000)]])
    with torch.inference_mode():
        _, ck, cv = loop.encode_window(pipe.params, mel, dims, quantize_kv=True)
        _, dck, dcv = loop.encode_window(draft_params, mel, draft_dims)
    base, sot_index = pipe._build_prompt(options, "en")
    prompt = torch.tensor([base], dtype=torch.long, device=pipe.device)
    max_new = min(options.sample_length, MAX_TOKEN_CONTEXT - prompt.shape[1])
    k = speculative.DRAFT_K
    for case, draft, d_dims, d_kv in (("random distil-large-v3 draft", draft_params, draft_dims, (dck, dcv)),
                                     ("the target as its own draft", pipe.params, dims, (ck, cv))):
        def run(cuda_graph):
            return speculative.speculative_decode_loop(
                pipe.params, draft, ck, cv, *d_kv, prompt, pipe._suppress_bias(options),
                pipe._decode_scalars(options, 0.0, 0), dims=dims, draft_dims=d_dims, special=sp,
                sample_begin=prompt.shape[1], max_new_tokens=max_new, sot_index=sot_index,
                use_timestamp_rules=True, suppress_blank=options.suppress_blank, return_state=True,
                cuda_graph=cuda_graph,
            )

        runs = timed_graph_pair(torch, run)
        (e, est), (g, gst) = runs["eager"]["out"], runs["graph"]["out"]
        equal = {"tokens": torch.equal(e.tokens, g.tokens), "token_logprobs": torch.equal(e.token_logprobs,
                 g.token_logprobs), "length": e.length == g.length, "rounds": est.rounds == gst.rounds}
        verify_per_round = 1 + ((k + 1) if draft is pipe.params else 0)
        rounds = runs["eager"]["counts"]["cross_attend_q8"] // n_layer - 1 - (1 if draft is pipe.params else 0)
        rounds //= verify_per_round  # every round run, the ones after the stop too (less the prefills)
        committed = g.length - prompt.shape[1]
        per_pass = committed / max(gst.rounds, 1)
        out[f"speculative, {case}"] = {**check_graph_pair(
            f"{label} speculative, {case}", runs, equal, 1, rounds, card,
            f" | {committed} tokens in {gst.rounds} committing rounds ({per_pass:.3f} per target pass), {rounds} "
            f"rounds run"), "tokens_per_pass": per_pass}
        if draft is pipe.params and per_pass <= 1:
            fail(f"{label}: the target as its own draft committed {per_pass:.3f} tokens a target pass")
    return out


# phases 13-15: the request lengths cut from phase 4's audio, in seconds
WAV_SECONDS = (120, 90, 60, 30)


# --- phase 28: the W8A16 product's kernel (csrc/w8a16_matmul.cu) -----------

# the decode step's W8A16 products at large-v3's widths ([in, out]): self
# q/k/v/out and cross q/out at [1280, 1280], fc1, fc2; then one tp slice of
# each kind (a column slice of a [1280, 1280] linear, a row slice of fc2)
W8A16_SHAPES = ((1280, 1280), (1280, 5120), (5120, 1280))
W8A16_TP_SHAPES = ((1280, 640), (2560, 1280))
W8A16_ROWS = (1, 8, 16, 32, 64, 128, 160)
# beyond the dispatch's rows, up to the kernel's: where the crossover lies
W8A16_TIMED_ROWS = W8A16_ROWS + (192, 256)
# weight sets a timed shape cycles through: over 100 MB, twice the 50 MB L2,
# so every launch reads its codes from device memory as a decode step does
W8A16_SET_BYTES = 100e6
# the argument that runs phases 1, 2 and 28 alone, and its timing process
W8A16_ARG = "--w8a16"
W8A16_TIMES_ARG = "--w8a16-times"


def w8a16_bytes(rows: int, k: int, n: int) -> int:
    """The product's least traffic: the codes, the bf16 scales, x and y."""
    return k * n + 2 * n + 2 * rows * k + 2 * rows * n


def w8a16_case(torch, g, dev, k: int, n: int, sets: int = 1) -> list:
    """`sets` random W8A16 weights [k, n] (quantize_weight of N(0, 0.05^2))
    with random bf16 biases."""
    from whisperkit_tpu_torch.ops import quant

    out = []
    for _ in range(sets):
        q = quant.quantize_weight(torch.randn((k, n), generator=g, device=dev) * 0.05)
        q["b"] = (torch.randn((n,), generator=g, device=dev) * 0.1).to(torch.bfloat16)
        out.append(q)
    return out


def check_w8a16(torch, g, dev, k: int, n: int, rows: int, x_shape=None) -> dict:
    """The kernel against the float64 product of the same bf16 operands, its
    error beside the plain version's; the folded bias against the kernel's
    product plus the bias, rounded (bit-equal)."""
    from whisperkit_tpu_torch.ops import quant

    q = w8a16_case(torch, g, dev, k, n)[0]
    x = torch.randn(x_shape or (rows, k), generator=g, device=dev).to(torch.bfloat16)
    w = quant.dequantize_weight(q, torch.bfloat16)
    exact = x.double() @ w.double()
    kernel, with_bias = quant.w8a16_matmul(x, [q, q], [None, q["b"]])
    plain = quant.quantized_matmul_reference(x, q)
    err, plain_err = max_abs(torch, kernel, exact), max_abs(torch, plain, exact)
    if not bool(torch.isfinite(kernel.float()).all()) or not err <= 2 * plain_err:
        fail(f"w8a16_matmul [{k}, {n}] x {tuple(x.shape)}: max error {err:.3e} against float64, "
             f"more than twice the plain version's {plain_err:.3e}")
    if not torch.equal(with_bias, kernel + q["b"]):
        fail(f"w8a16_matmul [{k}, {n}] x {tuple(x.shape)}: the folded bias is not the product plus the bias")
    return {"err": err, "plain_err": plain_err}


def w8a16_graph_replays(torch, g, dev) -> bool:
    """Two replays of a captured graph of the q/k/v launch and fc2 give the
    eager call's bits."""
    from whisperkit_tpu_torch.ops import quant

    qs = w8a16_case(torch, g, dev, 1280, 1280, 3)
    fc2 = w8a16_case(torch, g, dev, 5120, 1280)[0]
    x = torch.randn((GROUP, 1, 1280), generator=g, device=dev).to(torch.bfloat16)
    h = torch.randn((GROUP, 1, 5120), generator=g, device=dev).to(torch.bfloat16)
    outs = {}

    def run(i):
        outs["qkv"] = quant.w8a16_matmul(x, qs, [q["b"] for q in qs])
        outs["fc2"] = quant.w8a16_matmul(h, [fc2], [None])[0]

    run(0)
    eager = [t.clone() for t in (*outs["qkv"], outs["fc2"])]
    graph = captured(torch, run, 1)
    got = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        got.append([t.clone() for t in (*outs["qkv"], outs["fc2"])])
    return all(torch.equal(a, b) for replay in got for a, b in zip(replay, eager))


def w8a16_decoder_launches(torch, g, dev) -> dict:
    """The W8A16 kernel's launches in a two-layer decoder of large-v3's
    widths (random W8A16 weights, int8 cross-KV): the cross-KV projection
    (GROUP x 1500 rows) takes the plain version; the prompt pass (GROUP x 3
    rows) and one step (GROUP rows) take q, k and v in one launch and each
    other product in one: 6 launches for 8 products a layer. The step's
    logits against the same step with the plain version."""
    from dataclasses import replace
    from unittest import mock

    from whisperkit_tpu_torch.models import whisper as model
    from whisperkit_tpu_torch.ops import _build, quant

    dims = replace(model.VARIANT_DIMS["large-v3"], n_audio_layer=1, n_text_layer=2)
    params = quant.quantize_whisper_params(model.init_params(SEED, dims, torch.bfloat16, dev))
    enc = torch.randn((GROUP, dims.n_audio_ctx, dims.n_audio_state), generator=g, device=dev).to(torch.bfloat16)
    prompt = torch.randint(0, dims.n_vocab, (GROUP, 3), generator=g, device=dev)
    token = torch.randint(0, dims.n_vocab, (GROUP, 1), generator=g, device=dev)
    counts = {}

    def step():
        with torch.inference_mode():
            _build.reset_launches()
            ck, cv = model.compute_cross_kv_quantized(params, enc, dims)
            counts["cross_kv"] = _build.launches["w8a16_matmul"]
            kv_k, kv_v = model.init_kv_cache(dims, GROUP, 224, torch.bfloat16, dev)
            model.decoder_forward(params, prompt, 0, kv_k, kv_v, ck, cv, dims)
            counts["prompt"] = _build.launches["w8a16_matmul"] - counts["cross_kv"]
            logits = model.decoder_forward(params, token, 3, kv_k, kv_v, ck, cv, dims)[:, -1]
            counts["step"] = _build.launches["w8a16_matmul"] - counts["cross_kv"] - counts["prompt"]
        return logits

    kernel = step()
    launched = dict(counts)
    with mock.patch.object(quant, "w8a16_matmul", lambda x, qs, biases: [
            quant.quantized_matmul_reference(x, q, b) for q, b in zip(qs, biases)]):
        plain = step()
    err, scale = max_abs(torch, kernel, plain), float(plain.abs().max())
    want = {"cross_kv": 0, "prompt": 6 * dims.n_text_layer, "step": 6 * dims.n_text_layer}
    if launched != want or not err <= 2.0 ** -4 * scale:
        fail(f"w8a16_matmul in the decoder: launches {launched} (want {want}), step logits differ from the plain "
             f"version's by {err:.3e} (max |logit| {scale:.3f})")
    return {"launches": launched, "products_a_layer": 8, "logits_err": err, "logits_scale": scale}


def phase_w8a16(torch, card: str, build_log: str) -> dict:
    """Phase 28: the W8A16 kernel at the decode step's shapes and rows (and
    a tp slice of each kind, a 3-d x, three products in one launch) against
    the float64 product of the same bf16 operands, within twice the plain
    version's error; the folded bias bit-equal; a captured graph's replays
    bit-equal; ptxas's registers and spills; then (in a process of its own)
    device times of the kernel, the plain version and torch.matmul on the
    dequantized weight, the bound, and the row crossover (timed up to the
    kernel's 256 rows)."""
    from whisperkit_tpu_torch.ops import quant

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    ptxas = [line.strip() for line in build_log.split("w8a16_matmul.cu:", 1)[-1].splitlines()
             if "w8a16" in line or "Used" in line or "spill" in line][:40]
    for line in ptxas:
        say(f"phase 28 ptxas: {line}")
    checks = {}
    for k, n in W8A16_SHAPES + W8A16_TP_SHAPES:
        for rows in (W8A16_ROWS if (k, n) in W8A16_SHAPES else (GROUP,)):
            checks[f"{k}x{n}/{rows}"] = check_w8a16(torch, g, dev, k, n, rows)
    checks["1280x1280/32x1 (3-d x)"] = check_w8a16(torch, g, dev, 1280, 1280, GROUP, (GROUP, 1, 1280))
    qs = w8a16_case(torch, g, dev, 1280, 1280, 3)
    x = torch.randn((GROUP, 1280), generator=g, device=dev).to(torch.bfloat16)
    together = quant.w8a16_matmul(x, qs, [q["b"] for q in qs])
    alone = [quant.w8a16_matmul(x, [q], [q["b"]])[0] for q in qs]
    if not all(torch.equal(a, b) for a, b in zip(together, alone)):
        fail("w8a16_matmul: three products in one launch differ from each alone")
    if not w8a16_graph_replays(torch, g, dev):
        fail("w8a16_matmul: a graph's replays differ from the eager call")
    decoder = w8a16_decoder_launches(torch, g, dev)
    say(f"phase 28 w8a16_matmul in a two-layer large-v3-wide decoder: launches {decoder['launches']} "
        f"(8 products, 6 launches a layer); step logits within {decoder['logits_err']:.3e} of the plain "
        f"version's (max |logit| {decoder['logits_scale']:.3f}) | {card}")
    worst = max(checks.values(), key=lambda c: c["err"] / c["plain_err"])
    say(f"phase 28 w8a16_matmul: {len(checks)} shapes x rows within 2x the plain version's error against "
        f"float64 (worst ratio {worst['err'] / worst['plain_err']:.3f}); bias, siblings and graph replays "
        f"bit-equal | {card}")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), W8A16_TIMES_ARG],
                          capture_output=True, text=True, timeout=900, cwd=REPO)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f"the W8A16 timing process exited {proc.returncode}:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    times = json.loads(lines[-1])
    for key, t in times["shapes"].items():
        say(f"phase 28 w8a16_matmul {key} by device time: kernel {t['ms']:.4f} ms | plain {t['plain_ms']:.4f} ms "
            f"| library {t['library_ms']:.4f} ms | bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{100 * t['bound_ms'] / t['ms']:.1f}% of it) | {card}")
    say(f"phase 28 w8a16_matmul crossover: {json.dumps(times['crossover'])}")
    step = times["step"]
    say(f"phase 28 w8a16_matmul in a large-v3 decode step at {GROUP} rows (32 layers; q/k/v, out, cross q, "
        f"cross out, fc1, fc2: 6 launches a layer): kernel {step['ms']:.4f} ms, q/k/v as three launches {step['qkv_apart_ms']:.4f} ms, "
        f"plain {step['plain_ms']:.4f} ms, bound {step['bound_ms']:.4f} ms "
        f"({100 * step['bound_ms'] / step['ms']:.1f}% of it) | {card}")
    full = times["shapes"][f"1280x1280/{GROUP}"]
    return {"max_abs_err": worst["err"], "plain_err": worst["plain_err"], "ms": full["ms"],
            "plain_ms": full["plain_ms"], "library_ms": full["library_ms"], "bound_ms": full["bound_ms"],
            "bound_by": full["bound_by"], "checks": checks, "decoder": decoder, "times": times, "ptxas": ptxas}


def w8a16_times(torch) -> dict:
    """Phase 28's timing process: by device time (profiler traces, 50 calls,
    each on the next of enough weight sets to overflow the L2) the kernel,
    the plain version (the dequant's multiply and cuBLAS's GEMM) and
    torch.matmul on the dequantized weight, at every shape and row count of
    the checks; the largest row count at which the kernel beats the plain
    version; one decode step's launches at GROUP rows."""
    from whisperkit_tpu_torch.ops import quant

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    out = {"shapes": {}, "crossover": {}}
    weights = {}
    for k, n in W8A16_SHAPES + W8A16_TP_SHAPES:
        weights[(k, n)] = w8a16_case(torch, g, dev, k, n, max(2, int(W8A16_SET_BYTES // (k * n)) + 1))
    # the library's bf16 weights over as many bytes as the codes: out of the L2 too
    deq = {(k, n): [quant.dequantize_weight(q) for q in qs[: max(2, int(W8A16_SET_BYTES // (2 * k * n)) + 1)]]
           for (k, n), qs in weights.items()}
    for (k, n), qs in weights.items():
        for rows in (W8A16_TIMED_ROWS if (k, n) in W8A16_SHAPES else (GROUP,)):
            x = torch.randn((rows, k), generator=g, device=dev).to(torch.bfloat16)
            ws = deq[(k, n)]
            t = {"ms": device_ms(torch, lambda i: quant.w8a16_matmul(x, [qs[i % len(qs)]], [None]), 50,
                                 "w8a16_matmul"),
                 "plain_ms": device_ms(torch, lambda i: quant.quantized_matmul_reference(x, qs[i % len(qs)]), 50),
                 "library_ms": device_ms(torch, lambda i: torch.matmul(x, ws[i % len(ws)]), 50),
                 **bound(w8a16_bytes(rows, k, n), 2 * rows * k * n)}
            out["shapes"][f"{k}x{n}/{rows}"] = t
        if (k, n) in W8A16_SHAPES:
            wins = [r for r in W8A16_TIMED_ROWS
                    if out["shapes"][f"{k}x{n}/{r}"]["ms"] < out["shapes"][f"{k}x{n}/{r}"]["plain_ms"]]
            out["crossover"][f"{k}x{n}"] = {"kernel_faster_up_to_rows": max(wins, default=0),
                                            "all_faster": len(wins) == len(W8A16_TIMED_ROWS)}
    # one decode step at GROUP rows: each layer's six launches, q/k/v together
    x = {1280: torch.randn((GROUP, 1280), generator=g, device=dev).to(torch.bfloat16),
         5120: torch.randn((GROUP, 5120), generator=g, device=dev).to(torch.bfloat16)}
    square = weights[(1280, 1280)]
    qkv_ms = device_ms(torch, lambda i: quant.w8a16_matmul(x[1280], [square[(3 * i + j) % len(square)] for j in range(3)],
                                                           [None] * 3), 50, "w8a16_matmul")
    one = {key: out["shapes"][f"{k}x{n}/{GROUP}"] for key, (k, n) in
           (("square", (1280, 1280)), ("fc1", (1280, 5120)), ("fc2", (5120, 1280)))}
    per_layer = qkv_ms + 3 * one["square"]["ms"] + one["fc1"]["ms"] + one["fc2"]["ms"]
    apart = 6 * one["square"]["ms"] + one["fc1"]["ms"] + one["fc2"]["ms"]
    plain = 6 * one["square"]["plain_ms"] + one["fc1"]["plain_ms"] + one["fc2"]["plain_ms"]
    step_bound = 6 * one["square"]["bound_ms"] + one["fc1"]["bound_ms"] + one["fc2"]["bound_ms"]
    out["step"] = {"ms": 32 * per_layer, "qkv_ms": qkv_ms, "qkv_apart_ms": 32 * apart, "plain_ms": 32 * plain,
                   "bound_ms": 32 * step_bound}
    return out


def sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def tree_mismatches(torch, ours, ref, path: str = "") -> list:
    """Where two parameter trees differ: their keys or layer counts, or a
    leaf that differs in dtype, shape or any value (`torch.equal`)."""
    if isinstance(ref, dict):
        if not isinstance(ours, dict) or sorted(ours) != sorted(ref):
            return [f"{path}: keys differ"]
        return [m for k in ref for m in tree_mismatches(torch, ours[k], ref[k], f"{path}.{k}")]
    if isinstance(ref, list):
        if not isinstance(ours, list) or len(ours) != len(ref):
            return [f"{path}: layer counts differ"]
        return [m for i, (a, b) in enumerate(zip(ours, ref)) for m in tree_mismatches(torch, a, b, f"{path}[{i}]")]
    if ours.dtype == ref.dtype and ours.shape == ref.shape and bool(torch.equal(ours, ref)):
        return []
    return [f"{path}: {ours.dtype} {tuple(ours.shape)} vs {ref.dtype} {tuple(ref.shape)}"]


def n_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(n_leaves(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(n_leaves(v) for v in tree)
    return 1


def phase_checkpoint(torch, card: str, bf16_pipe, folder: Path, device: str = "cuda") -> dict:
    """Phase 13: phase 4's bf16 tree written as an HF checkpoint folder
    (tools/checkpoint.write_hf_checkpoint, with ALIGNMENT_HEADS, and a
    byte-level vocab from write_synthetic_tokenizer), then loaded through
    the port's entry point, WhisperPipeline(WhisperConfig(model_folder=...,
    download=False, compute_options=ComputeOptions.serving(quantization=
    "w8a16"))): the headline configuration (W8A16 weights, int8 cross-KV,
    the bf16 self-KV cache). Every leaf of the loaded tree must be
    `torch.equal` to quantize_whisper_params of phase 4's tree (codes,
    scales and the unquantized leaves), its alignment heads ALIGNMENT_HEADS,
    its tokenizer the folder's BPE."""
    from whisperkit_tpu_torch.core.configurations import ComputeOptions, WhisperConfig
    from whisperkit_tpu_torch.ops.quant import quantize_whisper_params
    from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
    from whisperkit_tpu_torch.text.tokenizer import WhisperTokenizer
    from whisperkit_tpu_torch.tools.checkpoint import write_hf_checkpoint, write_synthetic_tokenizer

    label = "phase 13 checkpoint"
    dims = bf16_pipe.dims
    sync(torch, device)
    t0 = time.perf_counter()
    n_bytes = write_hf_checkpoint(folder, dims, bf16_pipe.params, alignment_heads=ALIGNMENT_HEADS)
    write_synthetic_tokenizer(folder, dims.n_vocab)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe = WhisperPipeline(
        WhisperConfig(model_folder=str(folder), download=False,
                      compute_options=ComputeOptions.serving(quantization="w8a16")),
        device=device,
    )
    sync(torch, device)
    t_load = time.perf_counter() - t0
    if pipe.dims != dims or pipe.device.type != device:
        fail(f"{label}: loaded {pipe.dims} on {pipe.device}, not {dims} on {device}")
    bad = tree_mismatches(torch, pipe.params, quantize_whisper_params(bf16_pipe.params))
    if bad:
        fail(f"{label}: {len(bad)} leaves differ from quantize_whisper_params of phase 4's tree: {bad[:5]}")
    heads = [tuple(h) for h in pipe.alignment_heads.tolist()]
    if heads != list(ALIGNMENT_HEADS):
        fail(f"{label}: alignment heads {heads} are not {ALIGNMENT_HEADS}")
    if not isinstance(pipe.tokenizer, WhisperTokenizer):
        fail(f"{label}: the tokenizer is {type(pipe.tokenizer).__name__}, not the folder's BPE")
    say(f"{label}: large-v3 bf16 tree as an HF folder: model.safetensors {n_bytes} bytes "
        f"({n_bytes / 2**30:.3f} GiB), written with the tokenizer in {t_write:.3f} s | WhisperPipeline(model_folder, "
        f"serving(quantization=\"w8a16\")) in {t_load:.3f} s (timings.model_loading "
        f"{pipe.timings.model_loading:.3f} s) | all {n_leaves(pipe.params)} leaves torch.equal to "
        f"quantize_whisper_params of phase 4's tree; {len(heads)} alignment heads equal | {card}")
    return {"pipe": pipe, "bytes": n_bytes, "write_s": t_write, "load_s": t_load,
            "model_loading_s": pipe.timings.model_loading}


def window_key(window) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha1(np.ascontiguousarray(window, np.float32).tobytes()).hexdigest()


class WindowRecorder:
    """On one pipeline instance, within the `with` block: each
    `_mel_batch` call's windows (`mels`) and each `_decode_with_fallback`
    call's (word_timestamps, per-row decodes) (`decodes`), in call order,
    with the decode options' fields in `held` replaced. Phase 14 holds
    them as tools/workload.pipeline_options does for phases 4-12: the
    fallback ladder at temperature 0 (random weights fail every quality
    threshold, so the ladder would end in tokens sampled at t = 1.0, whose
    draws depend on the batch's makeup and seeds) and no first-token floor
    (which would end every random-weight window at its first token)."""

    def __init__(self, pipe, **held):
        self.pipe, self.held, self.mels, self.decodes = pipe, held, [], []

    def __enter__(self):
        import dataclasses

        import numpy as np

        mel_batch, decode = self.pipe._mel_batch, self.pipe._decode_with_fallback

        def recorded_mel_batch(windows):
            self.mels.append([np.asarray(w) for w in windows])
            return mel_batch(windows)

        def greedy_decode(ck, cv, options, language, window_index, shard=None):
            out = decode(ck, cv, dataclasses.replace(options, **self.held), language, window_index, shard)
            self.decodes.append((options.word_timestamps, out))
            return out

        self.pipe._mel_batch, self.pipe._decode_with_fallback = recorded_mel_batch, greedy_decode
        return self

    def __exit__(self, *exc):
        del self.pipe._mel_batch, self.pipe._decode_with_fallback

    def clear(self) -> None:
        self.mels.clear()
        self.decodes.clear()


def reference_windows(torch, pipe, rec: WindowRecorder, audio, options) -> tuple:
    """`pipe.transcribe` of one request's audio alone (the list form for
    ≤ 30 s, the scheduler's one-window path), recorded: (result, {window
    key: (seek frame, sampled tokens, the filtered logits' top-2 gap of
    each step)}). Its VAD windows decode as one length-sorted group."""
    from whisperkit_tpu_torch.pipelines.whisper import WINDOW_SAMPLES

    short = len(audio) <= WINDOW_SAMPLES
    rec.clear()
    with StepLogits(pipe.tokenizer.special.eot) as steps:
        result = pipe.transcribe([audio], options)[0] if short else pipe.transcribe(audio, options)
    if isinstance(result, Exception):
        raise result
    if len(rec.mels) != 1 or len(rec.decodes) != 1:
        fail(f"reference of {len(audio) / 16000:.0f} s: {len(rec.mels)} mel and {len(rec.decodes)} decode calls, "
             "not one group")
    windows, decodes = rec.mels[0], rec.decodes[0][1]
    if short:
        order, seeks = [0], [0]
    else:
        chunks = pipe._vad_chunks(audio, options)
        # the pipeline's own order: one group of the chunks sorted by length
        order = sorted(range(len(chunks)), key=lambda i: len(chunks[i].audio_samples))
        seeks = [c.seek_offset_index // 160 for c in chunks]
        if len(order) > options.concurrent_worker_count:
            fail(f"reference of {len(audio) / 16000:.0f} s: {len(order)} chunks take more than one group")
    gaps = torch.stack(steps.gaps).float().cpu()  # [steps, rows]
    return result, {window_key(windows[i]): (seeks[i], decodes[r].tokens, gaps[:, r].tolist())
                    for r, i in enumerate(order)}


def first_divergence(ours: list, ref: list, gaps: list) -> tuple | None:
    """None when the token lists are equal, else (step of the first
    difference, the reference's top-2 gap there): where one list ended
    (EOT) and the other went on, the step of that EOT."""
    first = next((k for k, (a, b) in enumerate(zip(ours, ref)) if a != b), None)
    if first is None:
        if len(ours) == len(ref):
            return None
        first = min(len(ours), len(ref))
    return first, (gaps[first] if first < len(gaps) else float("inf"))


def write_wav(path: Path, audio) -> Path:
    import wave

    import numpy as np

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes((np.clip(audio, -1.0, 1.0) * 32767).astype("<i2").tobytes())
    return path


def phase_server(torch, card: str, pipe, audio, audio_dir: Path, device: str = "cuda") -> dict:
    """Phase 14: phase 13's pipeline behind create_app(batching=True,
    max_batch=16) on 127.0.0.1, an ephemeral port, in a thread. 16-bit WAVs
    of the first 120, 90, 60 and 30 s of phase 4's audio, posted together
    from threads with urllib: each as `json`, the 60 s also as
    `verbose_json` with word timestamps (K3's probs form), the 90 s with
    `stream=true` (SSE, ending in transcript.text.done), the 30 s with
    `priority=latency`; GET /health; a post with no file (400). Every
    response is checked with server/schema.py. Each window the batcher
    decoded is held against `pipe.transcribe` of its request's WAV alone
    (WindowRecorder: greedy, no first-token floor, in both runs) under the
    top-2-gap rule; where every
    window matches, every text must equal its reference's. K1, K2, K3, K3's
    probs form and K4 must launch during the requests."""
    import threading

    from whisperkit_tpu_torch.audio.io import load_audio
    from whisperkit_tpu_torch.core.configurations import DecodingOptions
    from whisperkit_tpu_torch.ops import _build
    from whisperkit_tpu_torch.server import client, schema
    from whisperkit_tpu_torch.server.openai_api import create_app

    label = "phase 14 server"
    paths = {s: write_wav(audio_dir / f"clip_{s}s.wav", audio[: s * 16_000]) for s in WAV_SECONDS}
    words = [("response_format", "verbose_json"), ("timestamp_granularities[]", "word")]
    requests = [(f"json {s} s", s, []) for s in WAV_SECONDS] + [
        ("words 60 s", 60, words), ("stream 90 s", 90, [("stream", "true")]),
        ("latency 30 s", 30, [("priority", "latency")]), ("no file", None, []),
    ]
    responses: dict = {}
    with WindowRecorder(pipe, temperature_fallback_count=0, first_token_log_prob_threshold=None) as rec:
        app = create_app(pipe, batching=True, max_batch=16)
        host, port = app.start("127.0.0.1", 0)
        base = f"http://{host}:{port}"
        try:
            def send(name, seconds=None, fields=None):
                """One request; its (status, headers, body, seconds), or the
                exception that stopped it, lands in `responses`."""
                t0 = time.perf_counter()
                try:
                    if fields is None:
                        got = client.get(base + "/health", timeout=600)
                    else:
                        files = [("file", paths[seconds].name, paths[seconds].read_bytes())] if seconds else []
                        got = client.post(base + "/v1/audio/transcriptions", [("language", "en")] + fields, files,
                                          timeout=600)
                    responses[name] = got + (time.perf_counter() - t0,)
                except Exception as e:  # noqa: BLE001 — reported by the check below
                    responses[name] = e

            sync(torch, device)
            _build.reset_launches()
            threads = [threading.Thread(target=send, args=r) for r in requests]
            threads.append(threading.Thread(target=send, args=("health",)))
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(900)
            sync(torch, device)
            wall = time.perf_counter() - t0
            counts = dict(_build.launches)
            if any(t.is_alive() for t in threads):
                fail(f"{label}: requests still open after 900 s")
            errors = {k: repr(v) for k, v in responses.items() if isinstance(v, Exception)}
            if errors:
                fail(f"{label}: requests failed: {errors}")
            stats = app.scheduler.stats
            after = client.get(base + "/health", timeout=60)
        finally:
            app.close()
        served = list(zip(rec.mels, rec.decodes))

        # every response: status and schema
        texts = {}
        for name, seconds, fields in requests:
            status, headers, body, _ = responses[name]
            if name == "no file":
                if status != 400:
                    fail(f"{label}: a post with no file answered {status}, not 400")
                schema.ErrorResponse.validate(json.loads(body))
                continue
            if status != 200:
                fail(f"{label}: {name} answered {status}: {body[:300]!r}")
            if name.startswith("stream"):
                events = [b[len("data: "):] for b in body.decode().split("\n\n") if b.startswith("data: ")]
                if events[-1] != "[DONE]" or json.loads(events[-2])["type"] != "transcript.text.done":
                    fail(f"{label}: {name} does not end with transcript.text.done and [DONE]: {events[-2:]}")
                for e in events[:-2]:
                    schema.StreamDeltaEvent.validate(json.loads(e))
                texts[name] = schema.StreamDoneEvent.validate(json.loads(events[-2])).text
            elif name.startswith("words"):
                payload = schema.VerboseTranscriptionResponse.validate(json.loads(body))
                if not payload.segments:
                    fail(f"{label}: {name} has no segments")
                n_words = len(payload.words or [])
                texts[name] = payload.text
            else:
                texts[name] = schema.TranscriptionResponse.validate(json.loads(body)).text
        for got in (responses["health"], after):
            if got[0] != 200:
                fail(f"{label}: /health answered {got[0]}")
            schema.HealthResponse.validate(json.loads(got[2]))
        check_launches(label, counts, ("log_mel", "mha_encoder", "cross_attend_q8", "cross_attend_q8_probs",
                                       "self_attend"), (), ("self_attend_q8",), pipe.dims.n_text_layer)

        # the references: each request's WAV alone, through the same pipeline
        refs, ref_texts = {False: {}, True: {}}, {}
        for seconds, word_ts in sorted({(s, bool(f) and f == words) for _, s, f in requests if s}):
            options = DecodingOptions(language="en", word_timestamps=word_ts, chunking_strategy="vad")
            result, windows = reference_windows(torch, pipe, rec, load_audio(paths[seconds]), options)
            refs[word_ts].update(windows)
            ref_texts[(seconds, word_ts)] = result.text

    same, diverged = 0, []
    for batch_windows, (word_ts, decodes) in served:
        for w, wd in zip(batch_windows, decodes):
            if not w.any():
                continue  # a silent pad row
            key = window_key(w)
            if key not in refs[word_ts]:
                fail(f"{label}: a served window ({len(w)} samples) has no reference window")
            seek, ref_tokens, gaps = refs[word_ts][key]
            div = first_divergence(wd.tokens, ref_tokens, gaps)
            if div is None:
                same += 1
                continue
            diverged.append(f"window at {seek / 100:.2f} s{' (words)' if word_ts else ''} from step {div[0]} "
                            f"(gap {div[1]:.4f})")
            if div[1] > BF16_GAP_TOL:
                fail(f"{label}: a window at {seek / 100:.2f} s diverges at step {div[0]}, where the reference's "
                     f"top-2 gap is {div[1]:.4f} > {BF16_GAP_TOL}")
    text_same = {name: texts[name] == ref_texts[(s, f == words)] for name, s, f in requests if s}
    if not diverged and not all(text_same.values()):
        fail(f"{label}: every window matched, but texts differ: {text_same}")
    latencies = {name: round(responses[name][3], 3) for name in list(texts) + ["no file", "health"]}
    say(f"{label}: {len(requests) + 1} requests in {wall:.3f} s ({n_words} words in the verbose_json) | latency s "
        f"{json.dumps(latencies)} | scheduler "
        f"{json.dumps(stats)} | {same} served windows equal to their reference alone"
        + (f"; diverging within the rule: {', '.join(diverged)}" if diverged else "")
        + f" | texts equal {sum(text_same.values())} of {len(text_same)} | launches {json.dumps(counts)} | {card}")
    return {"counts": counts, "wall": wall, "latencies": latencies, "stats": stats, "same": same,
            "diverged": len(diverged), "words": n_words, "paths": paths}


def phase_cli(torch, card: str, bf16_pipe, folder: Path, wav: Path, out_dir: Path, device: str = "cuda") -> dict:
    """Phase 15: `python -m whisperkit_tpu_torch.cli transcribe` on phase
    13's folder and the 60 s WAV (VAD, reports json and srt, the fallback
    ladder off by its flag so the decode is greedy) in a child process,
    which must exit 0. Its JSON report's segments are held, window by
    window, against an in-process WhisperPipeline with the CLI's own
    ComputeOptions (no quantization, bf16 cross-KV) and options, its
    first-token floor included, on phase 4's tree (the tree the folder
    holds) under the top-2-gap rule."""
    import re

    from whisperkit_tpu_torch.audio.io import load_audio
    from whisperkit_tpu_torch.cli import main as cli
    from whisperkit_tpu_torch.core.configurations import ComputeOptions, WhisperConfig
    from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
    from whisperkit_tpu_torch.text.tokenizer import load_tokenizer

    label = "phase 15 CLI"
    argv = ["transcribe", "--model-folder", str(folder), "--audio-path", str(wav), "--chunking-strategy", "vad",
            "--no-download", "--temperature-fallback-count", "0", "--report", "--report-format", "json", "srt",
            "--report-path", str(out_dir), "--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "whisperkit_tpu_torch.cli", *argv], capture_output=True, text=True,
                          cwd=REPO, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{label}: exit {proc.returncode}: {proc.stderr[-2000:]}")
    rtf = re.search(r"\(RTF ([0-9.]+)\)", proc.stderr)
    report = json.loads((out_dir / f"{wav.stem}.json").read_text())
    if not (out_dir / f"{wav.stem}.srt").read_text().startswith("1\n") or not report["segments"]:
        fail(f"{label}: empty reports")

    ref_pipe = WhisperPipeline(WhisperConfig(compute_options=ComputeOptions(), load=False), dims=bf16_pipe.dims,
                               params=bf16_pipe.params, tokenizer=load_tokenizer(folder, bf16_pipe.dims.n_vocab),
                               device=device)
    options = cli._decode_options(cli.build_parser().parse_args(argv), ref_pipe.tokenizer)
    with WindowRecorder(ref_pipe) as rec:
        result, windows = reference_windows(torch, ref_pipe, rec, load_audio(wav), options)
    by_seek = {seek: (tokens, gaps) for seek, tokens, gaps in windows.values()}
    same, diverged = hold_report(label, report["segments"], result, by_seek)
    say(f"{label}: `python -m whisperkit_tpu_torch.cli transcribe` on the 60 s WAV, exit 0 in {wall:.3f} s "
        f"(process start, device probe, checkpoint load, build reuse and transcribe), CLI's RTF "
        f"{rtf.group(1) if rtf else 'not printed'} | {len(report['segments'])} segments; {same} of "
        f"{same + len(diverged)} windows equal to the in-process pipeline's"
        + (f"; diverging within the rule: {', '.join(diverged)}" if diverged else "") + f" | {card}")
    return {"wall": wall, "rtf": float(rtf.group(1)) if rtf else None, "same": same, "diverged": len(diverged),
            "argv": argv, "reference": (result, by_seek)}


def per_window(segments) -> dict:
    """{seek: the window's tokens} of report (dict) or result segments."""
    out: dict = {}
    for s in segments:
        out.setdefault(s["seek"] if isinstance(s, dict) else s.seek, []).extend(
            s["tokens"] if isinstance(s, dict) else s.tokens)
    return out


def hold_report(label, report_segments, result, by_seek) -> tuple[int, list]:
    """A CLI report's windows against the in-process reference `result`
    (`by_seek`: its tokens and top-2 gaps per window) under the top-2-gap
    rule: (windows equal, notes on the windows that diverge within it)."""
    ours, ref = per_window(report_segments), per_window(result.segments)
    same, diverged = 0, []
    for seek in sorted(set(ours) | set(ref)):
        if ours.get(seek) == ref.get(seek):
            same += 1
            continue
        if seek not in by_seek:
            fail(f"{label}: the report has a window at {seek / 100:.2f} s that the reference does not decode")
        tokens, gaps = by_seek[seek]
        step, gap = first_divergence(ours.get(seek, []), tokens, gaps) or (len(ours.get(seek, [])), 0.0)
        diverged.append(f"window at {seek / 100:.2f} s from step {step} (gap {gap:.4f})")
        if gap > BF16_GAP_TOL:
            fail(f"{label}: the window at {seek / 100:.2f} s diverges at step {step}, where the reference's top-2 "
                 f"gap is {gap:.4f} > {BF16_GAP_TOL}")
    return same, diverged


# phase 16: the card against the port on this machine's CPU, on the first
# DIARIZE_CHECK_SECONDS of the audio, under torch's default TF32 flags (the
# models set their own precision, core.device.ieee_float32). Every variant
# computes in float32 (w16a16 and w8a16 round or quantize the weights only,
# as in the JAX package), so one set of limits holds all three: the
# segmenter's log-probabilities (cuDNN's LSTM and convolutions against the
# CPU's, other summation orders) within LOGPROB_LIMIT; the fbank (float32
# DFT products of int16-range samples; the port and JAX on one CPU differ by
# ~3e-4 in quiet bins) within FBANK_LIMIT; the L2-normalised embeddings,
# max-abs, within EMBED_LIMIT, end to end and with the card's embedder fed
# the CPU's fbank and masks. A frame whose speakers differ must have a CPU
# top-2 log-prob gap within 2 × LOGPROB_LIMIT (an argmax the errors may
# turn). Each limit must also fail the same model run with TF32 on (the
# control, `tf32_on`): a check that passes TF32 cannot hold float32. On an
# H100 (torch 2.11, cuDNN's defaults) the float32 readings were log-probs
# 3.6e-7, fbank 1.8e-4, embeddings 1.1e-7-1.3e-7, and their TF32 controls
# 8.6e-5-1.7e-4, 0.11 and 5.0e-5-7.6e-5: each limit sits about midway (in
# the logarithm) between the two.
DIARIZE_CHECK_SECONDS = 60
LOGPROB_LIMIT = 5e-6
FBANK_LIMIT = 2e-3
EMBED_LIMIT = 2e-6
PYANNET_PUBLISHED = {"sinc": (80, 1, 251), "lstm layers": 4, "hidden": 128, "classes": 7}
RESNET34_PUBLISHED = {"conv1": (32, 1, 3, 3), "blocks": [3, 4, 6, 3], "seg_1": (5120, 256)}


def _shape(leaf) -> tuple:
    return tuple((leaf["w_q"] if isinstance(leaf, dict) else leaf).shape)


def published_shapes(pipe) -> dict:
    """The loaded trees' shapes, in the terms of PYANNET_PUBLISHED and
    RESNET34_PUBLISHED."""
    seg, emb = pipe.segmenter_params, pipe.embedder_params
    return {
        "pyannet": {"sinc": _shape(seg["sinc"]["w"]), "lstm layers": seg["lstm"].num_layers,
                    "hidden": seg["lstm"].hidden_size, "classes": _shape(seg["cls"]["w"])[1]},
        "resnet34": {"conv1": _shape(emb["conv1"]["w"]),
                     "blocks": [len(emb[f"layer{i}"]) for i in range(1, 5)], "seg_1": _shape(emb["seg_1"]["w"])},
    }


class DiarizeStages:
    """Within the `with` block, the diarization pipeline's segmenter, fbank
    and embedder calls (the names pipelines/diarize.py calls) are recorded:
    their arguments, and their outputs joined over the calls on the CPU."""

    NAMES = ("pyannet_forward", "kaldi_fbank", "wespeaker_embed_masked")

    def __enter__(self):
        import contextlib

        from whisperkit_tpu_torch.pipelines import diarize

        self.stack = contextlib.ExitStack()
        self.spies = {n: self.stack.enter_context(Spy(diarize, n)) for n in self.NAMES}
        self.args = {n: [] for n in self.NAMES}
        for n, spy in self.spies.items():
            spy.before = lambda *args, _name=n, **kwargs: self.args[_name].append((args, kwargs))
        return self

    def __exit__(self, *exc):
        self.stack.close()

    def outputs(self, name: str):
        import torch

        return torch.cat([out.float().cpu() for out in self.spies[name].calls])

    def masks(self) -> list:
        return [args[2].cpu() for args, _ in self.args["wespeaker_embed_masked"]]

    def rerun(self, name: str, pipe, fn=None):
        """`fn` (the recorded function by default) on each recorded call's
        arguments moved to `pipe`'s device, with `pipe`'s parameters in
        place of a model's; the outputs joined on the CPU."""
        import torch

        from whisperkit_tpu_torch.models import pyannet
        from whisperkit_tpu_torch.ops import fbank

        fn = fn or getattr(fbank if name == "kaldi_fbank" else pyannet, name)
        params = {"pyannet_forward": (pipe.segmenter_params,), "wespeaker_embed_masked": (pipe.embedder_params,)}
        lead = params.get(name, ())
        return torch.cat([fn(*lead, *(a.to(pipe.device) for a in args[len(lead):]), **kwargs).float().cpu()
                          for args, kwargs in self.args[name]])


@contextlib.contextmanager
def tf32_on(torch):
    """cuDNN's and cuBLAS's TF32 on within the block: a model function
    without its float32 guard (its `__wrapped__`) then computes what the
    card gives in TF32, the control each phase-16 limit must fail."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def unit(e):
    return e / e.norm(dim=-1, keepdim=True)


def hold_diarize_cpu(torch, label, pipe, card_stages, cpu_stages, card_result, cpu_result) -> dict:
    """The card's stages and RTTM against the CPU's on the same audio (see
    LOGPROB_LIMIT and the limits beside it), each limit beside its TF32
    control."""
    from whisperkit_tpu_torch.models import pyannet
    from whisperkit_tpu_torch.ops import fbank

    lp, lp_cpu = card_stages.outputs("pyannet_forward"), cpu_stages.outputs("pyannet_forward")
    lp_err = max_abs(torch, lp, lp_cpu)
    with tf32_on(torch):
        lp_tf32 = max_abs(torch, card_stages.rerun("pyannet_forward", pipe, pyannet.pyannet_forward.__wrapped__),
                          lp_cpu)
    if not lp_err <= LOGPROB_LIMIT < lp_tf32:
        fail(f"{label}: segmenter log-probs {lp_err:.3e} from the CPU's, limit {LOGPROB_LIMIT}, TF32 control "
             f"{lp_tf32:.3e}")
    fb_cpu = cpu_stages.outputs("kaldi_fbank")
    fb_err = max_abs(torch, card_stages.outputs("kaldi_fbank"), fb_cpu)
    with tf32_on(torch):
        fb_tf32 = max_abs(torch, card_stages.rerun("kaldi_fbank", pipe, fbank.kaldi_fbank.__wrapped__), fb_cpu)
    if not fb_err <= FBANK_LIMIT < fb_tf32:
        fail(f"{label}: fbank {fb_err:.3e} from the CPU's, limit {FBANK_LIMIT}, TF32 control {fb_tf32:.3e}")
    top2 = lp_cpu.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).numpy()
    flips = (lp.argmax(-1) != lp_cpu.argmax(-1)).numpy()
    if flips.any() and gap[flips].max() > 2 * LOGPROB_LIMIT:
        fail(f"{label}: {int(flips.sum())} frames change class where the CPU's top-2 gap reaches "
             f"{gap[flips].max():.3e} > {2 * LOGPROB_LIMIT}")
    emb = {}
    if not flips.any():
        if not all(torch.equal(a, b) for a, b in zip(card_stages.masks(), cpu_stages.masks())):
            fail(f"{label}: the embedder's masks differ though every frame's class is the CPU's")
        name, fn = "wespeaker_embed_masked", pyannet.wespeaker_embed_masked
        e_cpu = unit(cpu_stages.outputs(name))
        with tf32_on(torch):
            controls = (unit(card_stages.rerun(name, pipe, fn.__wrapped__)),
                        unit(cpu_stages.rerun(name, pipe, fn.__wrapped__)))
        for key, e, control in (("end to end", unit(card_stages.outputs(name)), controls[0]),
                                ("the CPU's inputs", unit(cpu_stages.rerun(name, pipe)), controls[1])):
            emb[key] = (max_abs(torch, e, e_cpu), max_abs(torch, control, e_cpu))
            if not emb[key][0] <= EMBED_LIMIT < emb[key][1]:
                fail(f"{label}: L2-normalised embeddings ({key}) {emb[key][0]:.3e} from the CPU's, limit "
                     f"{EMBED_LIMIT}, TF32 control {emb[key][1]:.3e}")
    rttm, rttm_cpu = card_result.to_rttm(), cpu_result.to_rttm()
    if rttm != rttm_cpu and not flips.any():
        fail(f"{label}: the RTTM differs from the CPU's though every frame's class and embedding agree")
    return {"logprob_err": lp_err, "logprob_tf32": lp_tf32, "fbank_err": fb_err, "fbank_tf32": fb_tf32,
            "embedding_err": emb,
            "class_flips": int(flips.sum()), "max_flip_gap": float(gap[flips].max()) if flips.any() else None,
            "rttm_equal": rttm == rttm_cpu, "rttm_lines": len(rttm.splitlines())}


def phase_diarize_published(torch, card: str, audio, folder: Path, device: str = "cuda") -> dict:
    """Phase 16: the published speaker models at their published shapes
    (PyanNet: SincNet 80 × 251 at stride 10, 2 × Conv1d(60, k=5), a 4-layer
    BiLSTM(128), 2 × Linear(128), 7 classes; WeSpeaker ResNet34: 32 base
    channels, blocks (3, 4, 6, 3), 80 mels, 256-d embedding), random
    weights written under the published names (tools/checkpoint.
    write_pyannote_checkpoint) and loaded by DiarizePipeline.from_pretrained
    in each variant. Per variant: a warm diarize of the first 60 s, held
    against the same pipeline on the CPU (hold_diarize_cpu); then the whole
    600 s, timed, with its stage split (each stage ends in a device sync),
    chunk and embedding counts, speakers, RTTM lines and peak memory. No
    hand-written kernel runs on this path (the JAX package computes these
    models in XLA)."""
    import numpy as np

    from whisperkit_tpu_torch.ops import _build
    from whisperkit_tpu_torch.pipelines.diarize import DiarizePipeline
    from whisperkit_tpu_torch.tools.checkpoint import write_pyannote_checkpoint

    label = "phase 16 diarization"
    t0 = time.perf_counter()
    seg_path, emb_path = write_pyannote_checkpoint(folder, SEED, full=True)
    t_write = time.perf_counter() - t0
    head = np.ascontiguousarray(audio[: DIARIZE_CHECK_SECONDS * 16_000])
    out = {"write_s": t_write, "bytes": seg_path.stat().st_size + emb_path.stat().st_size}
    for variant in DiarizePipeline.VARIANTS:
        t0 = time.perf_counter()
        pipe = DiarizePipeline.from_pretrained(folder, variant=variant)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        shapes = published_shapes(pipe)
        if shapes != {"pyannet": PYANNET_PUBLISHED, "resnet34": RESNET34_PUBLISHED}:
            fail(f"{label} {variant}: loaded shapes {shapes} are not the published ones")
        # no device given: the entry point places the models on the card
        if pipe.device.type != device or (pipe.segmenter_backend, pipe.embedder_backend) != ("pyannet", "resnet"):
            fail(f"{label} {variant}: {pipe.device} {pipe.segmenter_backend}/{pipe.embedder_backend}")
        with DiarizeStages() as card_stages:
            card_head = pipe.diarize(head)
        cpu_pipe = DiarizePipeline.from_pretrained(folder, variant=variant, device="cpu")
        t0 = time.perf_counter()
        with DiarizeStages() as cpu_stages:
            cpu_head = cpu_pipe.diarize(head)
        t_cpu = time.perf_counter() - t0
        check = hold_diarize_cpu(torch, f"{label} {variant}", pipe, card_stages, cpu_stages, card_head, cpu_head)
        del cpu_pipe, card_stages, cpu_stages

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        result = pipe.diarize(audio)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _build.launches.items() if v}
        peak = torch.cuda.max_memory_allocated()
        t = result.timings
        if not result.segments or t["embedding_count"] == 0:
            fail(f"{label} {variant}: no speaker segments on the {AUDIO_SECONDS:.0f} s audio ({t})")
        rttm = result.to_rttm("talk").splitlines()
        if not all(line.startswith("SPEAKER talk 1 ") and line.endswith("<NA> <NA>") for line in rttm):
            fail(f"{label} {variant}: malformed RTTM line {rttm[:2]}")
        out[variant] = {"wall": wall, "load_s": t_load, "cpu_check_s": t_cpu, "peak": peak, "speakers":
                        result.num_speakers, "segments": len(result.segments), **{k: t[k] for k in t},
                        "launches": launches, **check}
        say(f"{label} {variant}: {AUDIO_SECONDS:.0f} s in {wall:.3f} s (RTF {wall / AUDIO_SECONDS:.6f}) | segmenter "
            f"{t['segmenter_seconds']:.3f} s, embedder {t['embedder_seconds']:.3f} s, clustering "
            f"{t['clustering_seconds']:.3f} s, post-process {t['post_process_seconds']:.3f} s | {t['chunk_count']} "
            f"chunks, {t['embedding_count']} embeddings, {result.num_speakers} speakers, {len(rttm)} RTTM lines "
            f"| peak {peak / 2**30:.2f} GiB | load {t_load:.3f} s | kernel launches {launches} | {card}")
        emb = "; ".join(f"{k} {e:.3e} (TF32 control {c:.3e})" for k, (e, c) in check["embedding_err"].items())
        say(f"  vs the CPU on the first {DIARIZE_CHECK_SECONDS} s ({t_cpu:.1f} s there), TF32 flags "
            f"{torch.backends.cudnn.allow_tf32}/{torch.backends.cuda.matmul.allow_tf32} (cuDNN/cuBLAS): log-probs "
            f"{check['logprob_err']:.3e} (limit {LOGPROB_LIMIT}, TF32 control {check['logprob_tf32']:.3e}), fbank "
            f"{check['fbank_err']:.3e} (limit {FBANK_LIMIT}, TF32 control {check['fbank_tf32']:.3e}), "
            f"L2-normalised embeddings max-abs (limit {EMBED_LIMIT}): {emb or 'not held (class flips)'}; class "
            f"flips {check['class_flips']} (largest CPU top-2 gap {check['max_flip_gap']}), RTTM equal "
            f"{check['rttm_equal']} ({check['rttm_lines']} lines)")
        del pipe
    say(f"{label}: published shapes {json.dumps(shapes)}; checkpoint written in {t_write:.3f} s, "
        f"{out['bytes']} bytes")
    return out


def phase_diarize_conv(torch, card: str, audio, wav: Path, whisper_folder: Path, out_dir: Path,
                       cli_phase: dict) -> dict:
    """Phase 17: DiarizePipeline() (the random-init conv models, the
    default) on the 600 s audio with its stage times; its embedder's mel
    is K1 at n_mels = 80 (the launch counts, set to 0 just before and read
    just after). Then `transcribe --diarization` through the CLI in a child
    process on phase 15's WAV and folder (a Whisper folder holds no pyannote
    checkpoints, so the CLI diarizes with the same conv models): every
    segment's text must carry the label that the in-process
    DiarizePipeline().diarize of the WAV, merged into phase 15's in-process
    transcript by merge_with_transcript, gives it, and its windows must hold
    against that transcript under the top-2-gap rule."""
    import copy
    import re

    from whisperkit_tpu_torch.ops import _build
    from whisperkit_tpu_torch.pipelines.diarize import DiarizePipeline

    label = "phase 17 conv diarization"
    pipe = DiarizePipeline()
    pipe.diarize(audio[: 60 * 16_000])  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    result = pipe.diarize(audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launches)
    check_launches(label, counts, ("log_mel",), (), ("mha_encoder", "cross_attend_q8", "self_attend",
                                                       "self_attend_q8"), 1)
    t = result.timings
    if t["chunk_count"] != DIARIZE_CONV_CHUNKS:
        fail(f"{label}: {t['chunk_count']} chunks, not {DIARIZE_CONV_CHUNKS}")
    say(f"{label}: DiarizePipeline() on {AUDIO_SECONDS:.0f} s in {wall:.3f} s | segmenter "
        f"{t['segmenter_seconds']:.3f} s, embedder {t['embedder_seconds']:.3f} s (K1 at n_mels 80 over "
        f"{t['chunk_count']} chunks), clustering {t['clustering_seconds']:.3f} s, post-process "
        f"{t['post_process_seconds']:.3f} s | {t['embedding_count']} embeddings, {result.num_speakers} speakers, "
        f"{len(result.segments)} segments | peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"| launches {json.dumps(counts)} | {card}")

    argv = [*cli_phase["argv"], "--diarization"]
    argv[argv.index("--report-path") + 1] = str(out_dir)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "whisperkit_tpu_torch.cli", *argv], capture_output=True, text=True,
                          cwd=REPO, timeout=600)
    cli_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{label}: `transcribe --diarization` exit {proc.returncode}: {proc.stderr[-2000:]}")
    report = json.loads((out_dir / f"{wav.stem}.json").read_text())
    ref_result, by_seek = cli_phase["reference"]
    dia = pipe.diarize(wav)
    merged = DiarizePipeline.merge_with_transcript(dia, copy.deepcopy(ref_result))
    label_of = re.compile(r"^\[(SPEAKER_\d\d)\]")
    for seg in report["segments"]:
        m = label_of.match(seg["text"])
        spk = dia.speaker_at(seg["start"], seg["end"])
        want = f"SPEAKER_{spk:02d}" if spk is not None else None
        if (m.group(1) if m else None) != want:
            fail(f"{label}: segment {seg['start']:.2f}-{seg['end']:.2f} s is labelled {seg['text'][:14]!r}, "
                 f"the in-process diarization gives {want}")
    same, diverged = hold_report(label, report["segments"], merged, by_seek)
    texts_equal = sum(1 for a, b in zip(report["segments"], merged.segments)
                      if a["seek"] == b.seek and a["text"] == (f"[{b.speaker}]{b.text}" if b.speaker else b.text))
    labels = sorted({label_of.match(s["text"]).group(1) for s in report["segments"] if label_of.match(s["text"])})
    say(f"{label}: `transcribe --diarization` child on the 60 s WAV exit 0 in {cli_wall:.3f} s | "
        f"{len(report['segments'])} segments labelled {labels}, each as the in-process diarization's "
        f"merge_with_transcript; {same} windows equal, {texts_equal} segment texts equal to the merged "
        f"in-process transcript" + (f"; diverging within the rule: {', '.join(diverged)}" if diverged else "")
        + f" | {card}")
    return {"wall": wall, "counts": counts, "chunks": t["chunk_count"], "embeddings": t["embedding_count"],
            "speakers": result.num_speakers, "cli_wall": cli_wall, "labels": labels, "same": same}


# phase 18: the stream's length and slice (seconds)
STREAM_SECONDS = 12
STREAM_SLICE = 1.0


def run_stream(torch, label, pipe, options, clip) -> dict:
    """One eager stream of `clip` in STREAM_SLICE slices through
    AudioStreamTranscriber (no VAD): fail unless the confirmed words are
    only ever extended and each pass's result equals pipe.transcribe of
    the same buffer with the same options (its clip_timestamps) called
    directly. The kernels' launch counts are set to 0 just before the
    stream and read just after it, before those direct calls."""
    import numpy as np

    from whisperkit_tpu_torch.ops import _build
    from whisperkit_tpu_torch.pipelines.streaming import AudioStreamTranscriber, simulate_stream

    def key(result):
        return [(s.seek, s.start, s.end, s.tokens, s.text, [(w.word, w.start, w.end) for w in s.words or []])
                for s in result.segments]

    passes = []
    orig = pipe.transcribe

    def recorded(buffer, opts, callback=None):
        t0 = time.perf_counter()
        result = orig(buffer, opts, callback=callback)
        torch.cuda.synchronize()
        # keyed now: the streamer shifts the segments' times once it has
        # trimmed its buffer
        passes.append((np.array(buffer), opts, key(result), time.perf_counter() - t0))
        return result

    pipe.transcribe = recorded
    _build.reset_launches()
    try:
        st = AudioStreamTranscriber(pipe, options, eager=True, use_vad=False)
        confirmed: list = []
        for state in st.stream(simulate_stream(clip, chunk_seconds=STREAM_SLICE)):
            words = [(w.word, w.start, w.end) for w in state.confirmed_words]
            if words[: len(confirmed)] != confirmed:
                fail(f"{label}: confirmed words rewritten: {confirmed} → {words}")
            confirmed = words
    finally:
        del pipe.transcribe
    counts = dict(_build.launches)

    for i, (buffer, opts, keyed, _) in enumerate(passes):
        if key(pipe.transcribe(buffer, opts)) != keyed:
            fail(f"{label}: pass {i} (clip {opts.clip_timestamps}) differs from pipe.transcribe of its buffer")
    if len(passes) < len(clip) // int(STREAM_SLICE * 16_000) - 1:
        fail(f"{label}: {len(passes)} passes over {len(clip) / 16_000:.0f} s in {STREAM_SLICE} s slices")
    n_words = sum(len(seg[5]) for *_, keyed, _ in passes for seg in keyed)
    return {"passes": len(passes), "walls": [w for *_, w in passes], "confirmed_words": len(confirmed),
            "pass_words": n_words, "final": st.confirmed_text or st.state.current_text, "counts": counts}


def phase_streaming(torch, card: str, audio, folder: Path, audio_dir: Path, cli_phase: dict) -> dict:
    """Phase 18: AudioStreamTranscriber(pipe, options, eager=True,
    use_vad=False) over simulate_stream of the first 12 s in 1 s slices
    (run_stream), on the pipeline `--stream-simulated` builds from phase
    13's folder (bf16, the CLI's ComputeOptions) with the CLI's options
    (phase 15's: the first-token floor on, the fallback ladder off by its
    flag, word timestamps on). The floor ends every random-weight window at
    its first token, and the folder's byte-pair vocab seldom decodes a
    random token into a word, so a second stream runs the same weights
    with the port's FakeTokenizer (each token a word), no timestamp tokens,
    no floor and a 16-token budget: words for the confirmation to agree
    on. Then
    `--stream-simulated` in a child process must print the first stream's
    final text, and `--stream` in a child process must exit 2 with the
    no-capture-backend message (no sounddevice on this machine)."""
    import dataclasses

    import numpy as np

    from whisperkit_tpu_torch.cli import main as cli
    from whisperkit_tpu_torch.core.configurations import WhisperConfig
    from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline

    label = "phase 18 streaming"
    clip = np.ascontiguousarray(audio[: STREAM_SECONDS * 16_000])
    wav = write_wav(audio_dir / "stream12.wav", clip)
    argv = cli_phase["argv"]  # phase 15's, without its report flags
    base = argv[: argv.index("--report")] + argv[argv.index("--device"):]
    base[base.index("--audio-path") + 1] = str(wav)
    argv = [*base, "--stream-simulated"]
    args = cli.build_parser().parse_args([*argv, "--device-probe-timeout", "0"])
    pipe = cli._build_pipeline(args)
    options = cli._decode_options(args, pipe.tokenizer)
    words_pipe = WhisperPipeline(WhisperConfig(compute_options=pipe.config.compute_options, load=False),
                                 dims=pipe.dims, params=pipe.params, alignment_heads=pipe.alignment_heads,
                                 device=pipe.device)
    streams = {"cli": run_stream(torch, f"{label} (the CLI's options)", pipe, options, clip)}
    counts = streams["cli"]["counts"]
    # ComputeOptions(): bf16 cross-KV, so no K3, and word timestamps take
    # the plain softmax, not K3's probs form
    check_launches(f"{label} (the CLI's options)", counts, ("log_mel", "mha_encoder", "self_attend"), ("self_attend",),
                   ("cross_attend_q8", "cross_attend_q8_probs", "self_attend_q8"), pipe.dims.n_text_layer)
    streams |= {
        "words": run_stream(torch, f"{label} (FakeTokenizer, no timestamps, no floor, 16 tokens)", words_pipe,
                            dataclasses.replace(options, first_token_log_prob_threshold=None, sample_length=16,
                                                without_timestamps=True), clip),
    }
    if streams["words"]["pass_words"] == 0:
        fail(f"{label}: the stream without the first-token floor decoded no words")

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "whisperkit_tpu_torch.cli", *argv], capture_output=True, text=True,
                          cwd=REPO, timeout=600)
    sim_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{label}: `--stream-simulated` exit {proc.returncode}: {proc.stderr[-2000:]}")
    # the replay's last line is its final text (which may be empty)
    printed = proc.stdout[:-1].split("\n")[-1] if proc.stdout.endswith("\n") else None
    if printed != streams["cli"]["final"]:
        fail(f"{label}: `--stream-simulated` printed {printed!r}, the in-process stream {streams['cli']['final']!r}")
    live = subprocess.run([sys.executable, "-m", "whisperkit_tpu_torch.cli", *base, "--stream"], capture_output=True,
                          text=True, cwd=REPO, timeout=300)
    if live.returncode != 2 or "no microphone backend (sounddevice) on this host" not in live.stderr:
        fail(f"{label}: `--stream` exit {live.returncode}, stderr {live.stderr[-500:]!r}")
    for name, st in streams.items():
        say(f"{label}, {name}: {st['passes']} passes over {STREAM_SECONDS} s in {STREAM_SLICE:.0f} s slices, each "
            f"equal to pipe.transcribe of its buffer; pass walls {', '.join(f'{w:.3f}' for w in st['walls'])} s; "
            f"{st['pass_words']} words in the passes, {st['confirmed_words']} confirmed, only ever extended; final "
            f"text {st['final'][:60]!r} | {card}")
    say(f"{label}: the CLI-options stream's launches {json.dumps(counts)}; `--stream-simulated` child exit 0 in "
        f"{sim_wall:.3f} s, the same final text {printed!r} (empty when the first-token floor ends every random "
        f"window) | `--stream` child exit 2 (no capture backend) | {card}")
    return {**{f"{name}_{k}": v for name, st in streams.items() for k, v in st.items() if k not in ("final", "counts")},
            "sim_wall": sim_wall, "counts": counts}


# --- phases 19-20: text-to-speech (pipelines/tts.py) --------------------------------

TTS_CHECK_FRAMES = 8
# phase 19's float32 card-against-CPU limits, each of which the same run in
# TF32 must fail: the first frame's code0 logits, and the vocoder's samples
# on the CPU's codes; TTS_GAP_TOL is the largest top-2 gap of the CPU's
# logits at which the card may pick the other token
TTS_LOGIT_LIMIT = 1e-3
TTS_WAVE_LIMIT = 1e-4
TTS_GAP_TOL = 1e-3
# the check's vocoder: its conv kernels scaled by this so that the final
# clamp hides nothing (random Code2Wav weights at full width saturate 84% of
# the samples; at 0.85 they peak near 0.35)
TTS_CHECK_CONV_SCALE = 0.85
TTS_STREAM_FRAMES = 50  # two blocks of 25 (first and steady context)
TTS_STREAM_TOL = 1e-4  # float32: streamed blocks against the whole utterance
TTS_CLI_FRAMES = 8
TTS_INSTRUCTION = "Speak slowly and warmly, like a storyteller by the fire."


class TTSSpy:
    """Within the block: the codes and waveform of each vocoder call of the
    TTS pipeline (whole-utterance and streamed), and the logits of every
    sampling call, code0 then the 15 heads, frame by frame (a clone per
    call, [B, V] on the device). A replay of the frame's CUDA graph makes
    no Python call, so with `eager` (which the logits need) the pipeline's
    frame loops run eagerly (`cuda_graph=False`): the recorded runs are
    references. Without it the frames replay their graph and only the
    vocoder's codes and waveforms are read."""

    def __init__(self, eager: bool = False):
        self.eager = eager

    def __enter__(self):
        import functools

        from whisperkit_tpu_torch.decoding import tts_loop
        from whisperkit_tpu_torch.models import qwen3_tts
        from whisperkit_tpu_torch.pipelines import tts

        self.codes, self.waves, self.logits = [], [], []

        def vocoder(fn):
            def wrapped(params, codes, *args, **kwargs):
                out = fn(params, codes, *args, **kwargs)
                self.codes.append(codes.clone())
                self.waves.append((out[0] if isinstance(out, tuple) else out).float().clone())
                return out
            return wrapped

        self.dtypes = []  # each sampling call's logits dtype (its top-k and /T run in it)

        def sampler(fn):
            def wrapped(logits, *args, **kwargs):
                self.dtypes.append(logits.dtype)
                self.logits.append(logits.float().clone())
                return fn(logits, *args, **kwargs)
            return wrapped

        def eagerly(fn):
            return functools.partial(fn, cuda_graph=False)

        wraps = [(tts, "speech_decoder_forward", vocoder), (tts, "code2wav_decode_block", vocoder)]
        if self.eager:
            wraps += [(tts_loop, "sample_topk", sampler), (qwen3_tts, "sample_topk", sampler),
                      (tts, "tts_generate_loop", eagerly), (tts, "tts_generate_segment", eagerly)]
        self.saved = []
        for module, name, wrap in wraps:
            self.saved.append((module, name, getattr(module, name)))
            setattr(module, name, wrap(getattr(module, name)))
        return self

    def __exit__(self, *exc):
        for module, name, orig in self.saved:
            setattr(module, name, orig)


def tts_spied(torch, pipe, text, options, device: str = "cuda", eager: bool = True) -> tuple:
    """(result, spy) of one `pipe.generate`; with `eager`, its frames run
    eagerly and the spy holds every sampling call's logits."""
    with TTSSpy(eager) as spy:
        result = pipe.generate(text, options)
    sync(torch, device)
    return result, spy


def tts_code_divergence(label, ours, ref, ref_logits, tol) -> str:
    """'equal', or where the first code of `ours` ([1, F, 16]) that is not
    `ref`'s sits; fails unless `ref`'s logits there (one per sampling
    call, code0 then the heads) put `ours`'s token within `tol` of its own."""
    ours, ref = ours[0].cpu(), ref[0].cpu()
    diff = (ours != ref).nonzero()
    if not len(diff):
        return "equal"
    f, j = (int(x) for x in diff[0])
    logits = ref_logits[f * 16 + j][0].cpu()
    gap = float(logits[ref[f, j]] - logits[ours[f, j]])
    if gap > tol:
        fail(f"{label}: frame {f} code {j} is {int(ours[f, j])}, the reference's {int(ref[f, j])} at a gap of "
             f"{gap:.3g} > {tol}")
    return f"first divergence at frame {f} code {j}, gap {gap:.3g} (within {tol})"


def tts_finite_logits_err(torch, a, b) -> float:
    """max |a - b| over the finite entries of the reference b (the
    suppressed range is -inf in both)."""
    a, b = a.cpu(), b.cpu()
    keep = torch.isfinite(b)
    if not torch.equal(keep, torch.isfinite(a)):
        fail("the card's suppressed logits are not the CPU's")
    return float((a[keep] - b[keep]).abs().max())


def phase_tts_card_vs_cpu(torch, card: str, dims) -> dict:
    """Phase 19a: the 0.6b pipeline in float32 (random weights on the card,
    the vocoder's conv kernels scaled by TTS_CHECK_CONV_SCALE) generates
    TTS_CHECK_FRAMES frames at temperature 0 on the card, at the
    precision its entry points set themselves (the vocoder guards its IEEE
    float32), and on this machine's CPU: codes equal under the top-2-gap
    rule (TTS_GAP_TOL), the first frame's code0 logits within
    TTS_LOGIT_LIMIT, the card's vocoder on the CPU's codes within
    TTS_WAVE_LIMIT of the CPU's waveform; each limit must fail the same
    run with TF32 on (the vocoder without its guard, its `__wrapped__`).
    These runs' frames are eager (`cuda_graph=False`): the spy records
    every sampling call's logits. Then, on the card, stream_blocks (blocks
    of 25) against generate of the same text, both on the frame's graph,
    and a prompt-cache hit (graph) against a miss (eager), codes equal and
    audio within TTS_STREAM_TOL."""
    import dataclasses

    from whisperkit_tpu_torch.core.device import resolve_device
    from whisperkit_tpu_torch.models.qwen3_tts import (
        init_tts_params,
        map_tree,
        params_to_device,
        speech_decoder_forward,
    )
    from whisperkit_tpu_torch.pipelines.tts import GenerationOptions, TTSPipeline
    from whisperkit_tpu_torch.tools.profile_tts import PARAGRAPH

    label = "phase 19 TTS card against CPU (float32)"
    dev = resolve_device("cuda")
    params = init_tts_params(torch.Generator(device=dev).manual_seed(SEED), dims, torch.float32, dev)
    params["c2w"] = map_tree(lambda _, t: t * TTS_CHECK_CONV_SCALE if t.ndim == 3 else t, params["c2w"])
    card_pipe = TTSPipeline(dims, params=params, device="cuda")
    cpu_pipe = TTSPipeline(dims, params=params_to_device(params, "cpu"), device="cpu")
    text = PARAGRAPH.split(". ")[0] + "."
    options = GenerationOptions(max_new_tokens=TTS_CHECK_FRAMES, temperature=0.0, chunking_strategy="none",
                                use_prompt_cache=False)
    t0 = time.perf_counter()
    cpu, cpu_spy = tts_spied(torch, cpu_pipe, text, options, "cpu")
    cpu_s = time.perf_counter() - t0
    ours, spy = tts_spied(torch, card_pipe, text, options)
    with tf32_on(torch):
        _, tf32_spy = tts_spied(torch, card_pipe, text, options)
    ref_codes = cpu_spy.codes[0]
    agreement = tts_code_divergence(label, spy.codes[0], ref_codes, cpu_spy.logits, TTS_GAP_TOL)
    logit_err = tts_finite_logits_err(torch, spy.logits[0], cpu_spy.logits[0])
    logit_tf32 = tts_finite_logits_err(torch, tf32_spy.logits[0], cpu_spy.logits[0])
    wave = speech_decoder_forward(card_pipe.params, ref_codes.to(dev), dims).float().cpu()
    with tf32_on(torch):
        wave_tf32 = speech_decoder_forward.__wrapped__(card_pipe.params, ref_codes.to(dev), dims).float().cpu()
    ref_wave = cpu_spy.waves[0]
    wave_err = float((wave - ref_wave).abs().max())
    wave_tf32_err = float((wave_tf32 - ref_wave).abs().max())
    for what, err, tf32, limit in (("logits", logit_err, logit_tf32, TTS_LOGIT_LIMIT),
                                   ("waveform", wave_err, wave_tf32_err, TTS_WAVE_LIMIT)):
        if not err <= limit < tf32:
            fail(f"{label}: {what} error {err:.3g}, TF32 control {tf32:.3g}: the limit {limit} must hold the first "
                 f"and fail the second")
    if not (np_finite(ours.audio) and len(ours.audio) == TTS_CHECK_FRAMES * 1920):
        fail(f"{label}: {len(ours.audio)} samples, or not finite")
    say(f"{label}: 0.6b, {TTS_CHECK_FRAMES} frames at temperature 0, one chunk | codes {agreement} | first-frame "
        f"code0 logits max err {logit_err:.3g} (limit {TTS_LOGIT_LIMIT}; TF32 control {logit_tf32:.3g}) | vocoder "
        f"on the CPU's codes max err {wave_err:.3g} (limit {TTS_WAVE_LIMIT}; TF32 control {wave_tf32_err:.3g}; "
        f"peak |sample| {float(ref_wave.abs().max()):.3f}) | CPU generate {cpu_s:.3f} s | {card}")
    del cpu_pipe, cpu_spy

    # streamed blocks and the prompt cache, on the card
    stream_opts = dataclasses.replace(options, max_new_tokens=TTS_STREAM_FRAMES)
    whole, whole_spy = tts_spied(torch, card_pipe, text, stream_opts, eager=False)
    with TTSSpy() as block_spy:
        blocks = [b for b in card_pipe.stream_blocks(text, stream_opts, block_frames=25)]
    streamed = np_concat(blocks)
    stream_err = float(abs(streamed - whole.audio).max()) if len(streamed) == len(whole.audio) else float("inf")
    same_codes = torch.equal(torch.cat(block_spy.codes, 1).cpu(), whole_spy.codes[0].cpu())
    hit_opts = dataclasses.replace(options, use_prompt_cache=True, instruction=TTS_INSTRUCTION)
    miss, miss_spy = tts_spied(torch, card_pipe, text, dataclasses.replace(hit_opts, use_prompt_cache=False))
    card_pipe.build_prompt_cache(hit_opts)
    hit, hit_spy = tts_spied(torch, card_pipe, text, hit_opts, eager=False)
    if not (same_codes and stream_err <= TTS_STREAM_TOL and [len(b) for b in blocks] == [25 * 1920] * 2):
        fail(f"{label}: stream_blocks {[len(b) for b in blocks]} samples, codes equal {same_codes}, max err "
             f"{stream_err:.3g} against generate (limit {TTS_STREAM_TOL})")
    cache_agreement = tts_code_divergence(label + " prompt cache", hit_spy.codes[0], miss_spy.codes[0],
                                          miss_spy.logits, TTS_GAP_TOL)
    cache_err = float(abs(hit.audio - miss.audio).max()) if len(hit.audio) == len(miss.audio) else float("inf")
    if cache_agreement == "equal" and not cache_err <= TTS_STREAM_TOL:
        fail(f"{label}: the prompt-cache hit's audio is {cache_err:.3g} from the miss's (limit {TTS_STREAM_TOL})")
    say(f"{label}: stream_blocks of 25 frames, {len(blocks)} blocks, codes equal to generate's, max err "
        f"{stream_err:.3g} (limit {TTS_STREAM_TOL}) | prompt cache with an instruction: the hit's codes "
        f"{cache_agreement} against the miss's, audio max err {cache_err:.3g} | {card}")
    return {"logit_err": logit_err, "logit_tf32": logit_tf32, "wave_err": wave_err, "wave_tf32": wave_tf32_err,
            "stream_err": stream_err, "cache_err": cache_err, "cpu_s": cpu_s}


def np_finite(x) -> bool:
    import numpy as np

    return bool(np.isfinite(x).all())


def np_concat(blocks):
    import numpy as np

    return np.concatenate(blocks) if blocks else np.zeros(0, np.float32)


def tts_timed(torch, pipe, text, options) -> dict:
    """One warm generate of 4 frames (every path of the loop and the
    vocoder), then `options`' generate timed (host clock, the device synced
    after), peak memory reset before it."""
    import dataclasses

    from whisperkit_tpu_torch.decoding import graph

    pipe.generate(text, dataclasses.replace(options, max_new_tokens=4))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    graph.reset_stats()
    t0 = time.perf_counter()
    result = pipe.generate(text, options)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t = result.timings
    if not (np_finite(result.audio) and len(result.audio) and t.frames):
        fail(f"TTS generate: {t.frames} frames, {len(result.audio)} samples, or not finite")
    return {"wall": wall, "frames": t.frames, "chunks": t.chunks, "ms_per_step": t.ms_per_step,
            "rtr": t.real_time_ratio, "tokenize_s": t.tokenize_seconds, "generate_s": t.generate_seconds,
            "vocode_s": t.vocode_seconds, "audio_s": len(result.audio) / 24_000,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "graph": graph_stats(by_device=True)}


def say_tts_run(label, run, weight_bytes, card) -> None:
    say(f"{label}: {run['chunks']} chunks (B), {run['frames']} frames, {run['audio_s']:.2f} s of audio | wall "
        f"{run['wall']:.3f} s | ms_per_step {run['ms_per_step']:.2f} (generate s over the frames of all rows) | "
        f"real-time ratio {run['rtr']:.3f} | "
        f"tokenize {run['tokenize_s']:.4f} s, generate {run['generate_s']:.3f} s, vocode {run['vocode_s']:.3f} s | "
        f"peak {run['peak_gib']:.2f} GiB, weights {weight_bytes} bytes ({weight_bytes / 2**30:.3f} GiB) | frame "
        f"graph by device {json.dumps(run['graph'])} | {card}")


def phase_tts(torch, card: str, dims) -> dict:
    """Phase 19b: the 0.6b pipeline in bf16 (random weights, the port's init
    with SEED) and its weights quantized to W8A16 and to W4A16: generate of
    profile_tts.PARAGRAPH (four sentence chunks, one batch) with the CLI's
    defaults (temperature 0.9, top-k 50, penalty 1.05, 245 frames at most),
    one warm pass then one timed, the frames on their CUDA graph (its
    captures and replays reported); stream_blocks (blocks of 25) timed to
    its first block; a prompt-cache hit against a miss; then, in a child
    process, `python -m whisperkit_tpu_torch.tools.profile_tts`: device
    and host launches, device busy and idle per frame, eager and as the
    graph (whose host launches must be single digits); and the 1.7b
    pipeline in bf16 on one short generate with an instruction."""
    import dataclasses

    from whisperkit_tpu_torch.ops.quant import quantized_size_bytes
    from whisperkit_tpu_torch.pipelines.tts import TTS_VARIANTS, GenerationOptions, TTSPipeline
    from whisperkit_tpu_torch.tools.profile_tts import PARAGRAPH

    label = "phase 19 TTS"
    options = GenerationOptions()
    bf16 = TTSPipeline(dims, seed=SEED, device="cuda")
    runs = {}
    for scheme in ("bf16", "w8a16", "w4a16"):
        pipe = bf16 if scheme == "bf16" else TTSPipeline(dims, params=bf16.params, quantize=scheme, device="cuda")
        runs[scheme] = tts_timed(torch, pipe, PARAGRAPH, options)
        runs[scheme]["weight_bytes"] = quantized_size_bytes(pipe.params)
        say_tts_run(f"{label} 0.6b {scheme}, generate", runs[scheme], runs[scheme]["weight_bytes"], card)
        del pipe

    # streaming: time to the first block of 25 frames, at temperature 0
    sentence = PARAGRAPH.split(". ")[0] + "."
    stream_opts = GenerationOptions(temperature=0.0, chunking_strategy="none", max_new_tokens=50)
    whole, whole_spy = tts_spied(torch, bf16, sentence, stream_opts, eager=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, blocks = None, []
    with TTSSpy() as block_spy:
        for block in bf16.stream_blocks(sentence, stream_opts, block_frames=25):
            blocks.append(block)
            first = first if first is not None else time.perf_counter() - t0
    total = time.perf_counter() - t0
    same = torch.equal(torch.cat(block_spy.codes, 1).cpu(), whole_spy.codes[0].cpu())
    streamed = np_concat(blocks)
    if not same or not blocks or len(streamed) != len(whole.audio):
        fail(f"{label} stream_blocks: {len(blocks)} blocks, {len(streamed)} samples, codes equal to generate's: "
             f"{same}")
    diff = abs(streamed - whole.audio)
    say(f"{label} 0.6b bf16 stream_blocks (25 frames a block, temperature 0): {len(blocks)} blocks, first after "
        f"{first:.3f} s, all after {total:.3f} s (generate of the same {whole.timings.frames} frames "
        f"{whole.timings.total_seconds:.3f} s) | codes equal to generate's; bf16 audio against generate's: "
        f"{float((diff <= 1e-2).mean()):.4f} of samples within 1e-2, max err {float(diff.max()):.3g} (the random "
        f"bf16 vocoder saturates its clamp: {float((abs(whole.audio) > 0.999).mean()):.3f} of samples) | {card}")

    # the prompt cache: a miss, then a hit, timed
    cache_opts = GenerationOptions(max_new_tokens=16, instruction=TTS_INSTRUCTION, voice="serena")
    miss = tts_timed(torch, bf16, PARAGRAPH, dataclasses.replace(cache_opts, use_prompt_cache=False))
    t0 = time.perf_counter()
    bf16.build_prompt_cache(cache_opts)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    hit = tts_timed(torch, bf16, PARAGRAPH, cache_opts)
    say(f"{label} 0.6b bf16 prompt cache (instruction, 16 frames): miss {miss['wall']:.3f} s, build "
        f"{build_s:.3f} s, hit {hit['wall']:.3f} s (tokenize {miss['tokenize_s']:.4f} / {hit['tokenize_s']:.4f} s, "
        f"generate {miss['generate_s']:.3f} / {hit['generate_s']:.3f} s) | {card}")

    # launches and device busy per frame, traced in a child process
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "whisperkit_tpu_torch.tools.profile_tts"], capture_output=True,
                          text=True, cwd=REPO, timeout=600)
    if proc.returncode != 0:
        fail(f"{label} profile: exit {proc.returncode}: {proc.stderr[-2000:]}")
    profiles = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    for prof in profiles:
        if prof["loop"] == "eager":
            parts = ", ".join(f"{k} {v['launches']:.0f} launches / {v['device_busy_ms']:.3f} ms busy"
                              for k, v in prof["parts"].items())
            extra = f"{parts} | vocoder wall {prof['vocoder_wall_ms']:.1f} ms"
        else:
            extra = (f"whole segments {', '.join(f'{w:.2f}' for w in prof['segment_call_ms'])} ms a frame | capture "
                     f"{prof['capture_s']:.3f} s, instantiate {prof['instantiate_s']:.3f} s")
        say(f"{label} 0.6b {prof['config']} {prof['loop']} trace (B={prof['batch']}): "
            f"{prof['launches_per_frame']:.1f} device launches, {prof['host_launches_per_frame']:.1f} host launches "
            f"and {prof['device_busy_ms']:.3f} ms device busy per frame, "
            f"frame wall {', '.join(f'{w:.2f}' for w in prof['frame_ms_unprofiled'])} ms, idle "
            f"{prof['idle_share']:.3f} | {extra} | {card}")
        say(f"  top: {json.dumps(prof['top'][:6])}")
    if len(profiles) != 6:
        fail(f"{label} profile: {len(profiles)} lines: {proc.stdout[-2000:]}")
    graphed = [p for p in profiles if p["loop"] == "graph"]
    if any(p["host_launches_per_frame"] >= 10 for p in graphed):
        fail(f"{label} profile: the graph's host launches per frame are not single digits: "
             f"{[p['host_launches_per_frame'] for p in graphed]}")
    say(f"{label} profile child: {time.perf_counter() - t0:.1f} s")

    # 1.7b, bf16: one short generate with an instruction
    big_dims = TTS_VARIANTS["1.7b"]
    big = TTSPipeline(big_dims, seed=SEED, device="cuda")
    big_opts = GenerationOptions(max_new_tokens=16, instruction=TTS_INSTRUCTION)
    big_run = tts_timed(torch, big, sentence, big_opts)
    big_run["weight_bytes"] = quantized_size_bytes(big.params)
    say_tts_run(f"{label} 1.7b bf16, generate with an instruction", big_run, big_run["weight_bytes"], card)
    del big
    torch.cuda.empty_cache()
    return {"pipe": bf16, **{f"{k}_{x}": v for k, r in runs.items() for x, v in r.items()},
            "stream_first_s": first, "profiles": profiles, "big_ms_per_step": big_run["ms_per_step"]}


def phase_tts_entry(torch, card: str, pipe, folder: Path) -> dict:
    """Phase 20: phase 19's bf16 tree written as a Qwen3-TTS folder
    (tools/checkpoint.write_qwen3_tts_checkpoint), loaded through
    TTSPipeline.from_pretrained with every leaf equal (the backbone bf16,
    Code2Wav in float32, its tokenizer.json read); then `python -m
    whisperkit_tpu_torch.cli tts` on the folder in a child process, which
    must exit 0 and write a 24 kHz WAV of the in-process pipeline's
    frames × 1920 samples, each equal to the in-process pipeline's (the
    same seed on the same card)."""
    import wave

    import numpy as np

    from whisperkit_tpu_torch.models.qwen3_tts import map_tree
    from whisperkit_tpu_torch.pipelines.tts import GenerationOptions, HFTTSTokenizer, TTSPipeline
    from whisperkit_tpu_torch.tools.checkpoint import write_qwen3_tts_checkpoint
    from whisperkit_tpu_torch.tools.profile_tts import PARAGRAPH

    label = "phase 20 TTS entry points"
    folder.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    write_qwen3_tts_checkpoint(folder, pipe.dims, params=pipe.params)
    write_s = time.perf_counter() - t0
    n_bytes = (folder / "model.safetensors").stat().st_size
    t0 = time.perf_counter()
    loaded = TTSPipeline.from_pretrained(str(folder), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want = dict(pipe.params, c2w=map_tree(lambda _, t: t.float(), pipe.params["c2w"]))
    bad = tree_mismatches(torch, loaded.params, want)
    if bad or loaded.dims != pipe.dims or not isinstance(loaded.tokenizer, HFTTSTokenizer):
        fail(f"{label}: {len(bad)} leaves differ ({bad[:5]}), dims {loaded.dims == pipe.dims}, tokenizer "
             f"{type(loaded.tokenizer).__name__}")
    say(f"{label}: 0.6b bf16 as a Qwen3-TTS folder: model.safetensors {n_bytes} bytes, written with config.json and "
        f"tokenizer.json in {write_s:.3f} s | TTSPipeline.from_pretrained in {load_s:.3f} s, all "
        f"{n_leaves(loaded.params)} leaves equal (Code2Wav as float32) | {card}")

    sentence = PARAGRAPH.split(". ")[0] + "."
    out = folder / "speech.wav"
    argv = ["tts", "--model-folder", str(folder), "--text", sentence, "--output-path", str(out),
            "--max-new-tokens", str(TTS_CLI_FRAMES)]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "whisperkit_tpu_torch.cli", *argv], capture_output=True, text=True,
                          cwd=REPO, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{label} CLI: exit {proc.returncode}: {proc.stderr[-2000:]}")
    with wave.open(str(out)) as w:
        rate, n = w.getframerate(), w.getnframes()
        pcm = np.frombuffer(w.readframes(n), "<i2")
    ref = loaded.generate(sentence, GenerationOptions(max_new_tokens=TTS_CLI_FRAMES))
    if rate != 24_000 or n != ref.timings.frames * 1920:
        fail(f"{label} CLI: {n} samples at {rate} Hz, the pipeline's {ref.timings.frames} frames make "
             f"{ref.timings.frames * 1920}")
    if not np.array_equal(pcm, (np.clip(ref.audio, -1, 1) * 32767).astype(np.int16)):
        fail(f"{label} CLI: the WAV's samples are not the in-process pipeline's (same folder, seed and card)")
    say(f"{label}: `python -m whisperkit_tpu_torch.cli tts` on the folder, exit 0 in {wall:.3f} s (process start, "
        f"device probe, load, generate, WAV) | {n} samples at {rate} Hz = {ref.timings.frames} frames x 1920, "
        f"equal to the in-process pipeline's | {card}")
    return {"bytes": n_bytes, "write_s": write_s, "load_s": load_s, "cli_wall": wall, "cli_samples": n}


# --- phase 26: the TTS frame's CUDA graph against the eager frame loop -------

# frames of each graph-against-eager run: a capture, then replays across
# two of tts_generate_loop's segments of 16; the stream's run: two blocks
# of 25 and 5, its replays across both
TTS_GRAPH_FRAMES = 20
TTS_GRAPH_STREAM_FRAMES = 30


@contextlib.contextmanager
def tts_calls(name: str, eager: bool):
    """Within the block, every call of pipelines.tts's `name`
    (`tts_generate_loop` or `tts_generate_segment`, from the mesh's threads
    too) recorded as (keywords, output), run with `cuda_graph=not eager`."""
    from whisperkit_tpu_torch.pipelines import tts

    orig, calls = getattr(tts, name), []

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs, cuda_graph=not eager)
        calls.append((kwargs, out))
        return out

    setattr(tts, name, wrapped)
    try:
        yield calls
    finally:
        setattr(tts, name, orig)


def loop_mismatches(torch, a, b) -> list:
    """The fields of two TTSLoopOutputs that are not bit-equal."""
    bad = [k for k in ("codes", "n_frames") if not torch.equal(getattr(a, k).cpu(), getattr(b, k).cpu())]
    if a.length != b.length:
        bad.append("length")
    if not all(torch.equal(x, y) for x, y in zip(a.kv, b.kv)):
        bad.append("kv")
    return bad


def frames_stepped(length: int, frames: int) -> int:
    """The frames tts_generate_loop steps when every row is done after
    `length`: to the end of that frame's segment."""
    from whisperkit_tpu_torch.decoding.tts_loop import SEGMENT_FRAMES

    return min(frames, -(-length // SEGMENT_FRAMES) * SEGMENT_FRAMES)


def check_graph_counts(label, eager_stats: dict, graph_stats_: dict, captures: int, stepped: int) -> None:
    """Fail unless the eager run made no graph and the graph run made
    `captures` (one per loop) and replayed every later frame."""
    got = {k: sum(v[k] for v in graph_stats_.values()) for k in ("captures", "replays")}
    if eager_stats or got != {"captures": captures, "replays": stepped - captures}:
        fail(f"{label}: eager graphs {eager_stats}; graph run {got}, want {captures} captures and "
             f"{stepped - captures} replays")


def tts_graph_pair(torch, run) -> dict:
    """`run(eager)` for eager then graph, each timed (the device synced),
    with the graphs' stats by device."""
    from whisperkit_tpu_torch.decoding import graph

    out = {}
    for form in ("eager", "graph"):
        graph.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run(form == "eager")
        torch.cuda.synchronize()
        out[form] = (result, time.perf_counter() - t0, graph_stats(by_device=True))
    return out


def padded_rows(pipe, options) -> tuple:
    """What `generate` hands the frame loop for profile_tts.PARAGRAPH's
    four chunks, TTS_INSTRUCTION on the first and third: (prompt embeds,
    pads, trailing text, step caps), the other two rows left-padded."""
    import dataclasses

    import torch

    from whisperkit_tpu_torch.tools.profile_tts import PARAGRAPH

    chunks = pipe.chunker.chunk(PARAGRAPH, options.target_chunk_size, options.min_chunk_size)
    tracks = [pipe._chunk_tracks(c, dataclasses.replace(options, instruction=TTS_INSTRUCTION if i % 2 == 0 else None))
              for i, c in enumerate(chunks)]
    embeds, pad = pipe._embed_tracks([(t, c) for t, c, _, _ in tracks])
    trailing = pipe._trailing_array([tr for _, _, tr, _ in tracks])
    caps = torch.tensor([cap for _, _, _, cap in tracks], device=pipe.device)
    return embeds, pad, trailing, caps


def phase_tts_graph(torch, card: str, bf16) -> dict:
    """Phase 26: the TTS frame as a CUDA graph (decoding/tts_loop.py,
    captured at a loop's first frame and replayed for every later one)
    against the same frames run eagerly (`cuda_graph=False`), each run
    TTS_GRAPH_FRAMES frames, at temperature 0 and at the CLI's 0.9 with
    one seed: (a) `tts_generate_loop` on profile_tts.PARAGRAPH's four
    rows, two of them left-padded (`padded_rows`), with phase 19's bf16
    tree and its W8A16 and W4A16 quantizations; (b) bf16 `stream_blocks`
    (batch 1, TTS_GRAPH_STREAM_FRAMES frames in blocks of 25): its
    segments' codes, the blocks' samples, the frames stepped and the
    cache; (c) bf16 `generate` on a prompt-cache
    hit: the loop's output and the audio. Codes, n_frames, `length` and
    the final KV cache bit-equal; one capture per loop or stream, a replay
    for every later frame (graph.stats_by_device)."""
    import numpy as np

    from whisperkit_tpu_torch.decoding.tts_loop import _frames_until_done, tts_generate_loop
    from whisperkit_tpu_torch.models.qwen3_tts import CODEC_EOS
    from whisperkit_tpu_torch.pipelines.tts import GenerationOptions, TTSPipeline
    from whisperkit_tpu_torch.tools.profile_tts import PARAGRAPH

    label = "phase 26 TTS graph"
    frames = TTS_GRAPH_FRAMES
    sentence = PARAGRAPH.split(". ")[0] + "."
    walls = {}
    for scheme in ("bf16", "w8a16", "w4a16"):
        pipe = bf16 if scheme == "bf16" else TTSPipeline(bf16.dims, params=bf16.params, quantize=scheme,
                                                         device="cuda")
        for temperature in (0.0, 0.9):
            options = GenerationOptions(temperature=temperature, max_new_tokens=frames)
            embeds, pad, trailing, caps = padded_rows(pipe, options)
            pair = tts_graph_pair(torch, lambda eager: tts_generate_loop(
                pipe.params, embeds, pipe._scalars(options), dims=pipe.dims, max_new_tokens=frames,
                top_k=options.top_k, prompt_pad=pad, trailing_text=trailing, step_cap=caps, cuda_graph=not eager))
            (eager, t_eager, s_eager), (graphed, t_graph, s_graph) = pair["eager"], pair["graph"]
            where = f"{label} (a) {scheme} T={temperature}"
            bad = loop_mismatches(torch, eager, graphed)
            if bad:
                fail(f"{where}: the graph's {bad} differ from the eager loop's")
            check_graph_counts(where, s_eager, s_graph, 1, frames_stepped(graphed.length, frames))
            walls[f"loop_{scheme}_{temperature}"] = (t_eager, t_graph)
            say(f"{where}: tts_generate_loop, B={embeds.shape[0]} (pads {pad.tolist()}), {frames} frames: codes, "
                f"n_frames {graphed.n_frames.tolist()}, length {graphed.length} and the cache bit-equal to the eager "
                f"loop's | eager {t_eager:.3f} s, graph {t_graph:.3f} s | graph by device {json.dumps(s_graph)} | "
                f"{card}")
        del pipe

    for temperature in (0.0, 0.9):
        # (b) stream_blocks, batch 1
        stream_opts = GenerationOptions(temperature=temperature, chunking_strategy="none",
                                        max_new_tokens=TTS_GRAPH_STREAM_FRAMES)

        def stream(eager):
            with tts_calls("tts_generate_segment", eager) as calls:
                blocks = list(bf16.stream_blocks(sentence, stream_opts, block_frames=25))
            codes = torch.cat([c for _, (c, _) in calls], dim=1)
            return blocks, codes, calls[-1][1][1]

        pair = tts_graph_pair(torch, stream)
        (eager, t_eager, s_eager), (graphed, t_graph, s_graph) = pair["eager"], pair["graph"]
        where = f"{label} (b) bf16 stream_blocks T={temperature}"
        (blocks_e, codes_e, st_e), (blocks_g, codes_g, st_g) = eager, graphed
        lengths = [int(_frames_until_done(c[:, :, 0], st.step_cap)) for c, st in ((codes_e, st_e), (codes_g, st_g))]
        same = (len(blocks_e) == len(blocks_g) and all(np.array_equal(x, y) for x, y in zip(blocks_e, blocks_g))
                and torch.equal(codes_e, codes_g) and st_e.step == st_g.step and lengths[0] == lengths[1]
                and all(torch.equal(x, y) for x, y in zip(st_e.kv, st_g.kv)))
        if not same:
            fail(f"{where}: blocks {[len(b) for b in blocks_g]} against {[len(b) for b in blocks_e]}, frames "
                 f"{st_g.step} against {st_e.step}, lengths {lengths}: not bit-equal to the eager stream")
        check_graph_counts(where, s_eager, s_graph, 1, st_g.step)
        walls[f"stream_{temperature}"] = (t_eager, t_graph)
        say(f"{where}: {len(blocks_g)} blocks of 25 frames at most, {st_g.step} frames stepped, n_frames "
            f"{int((codes_g[0, :, 0] != CODEC_EOS).sum())}, length {lengths[1]}: codes, samples and cache bit-equal "
            f"to the eager stream's | eager {t_eager:.3f} s, graph {t_graph:.3f} s | graph by device "
            f"{json.dumps(s_graph)} | {card}")

        # (c) a prompt-cache hit
        hit_opts = GenerationOptions(temperature=temperature, max_new_tokens=frames, voice="serena",
                                     instruction=TTS_INSTRUCTION, use_prompt_cache=True)
        bf16.build_prompt_cache(hit_opts)

        def hit(eager):
            with tts_calls("tts_generate_loop", eager) as calls:
                result = bf16.generate(PARAGRAPH, hit_opts)
            return result, calls

        pair = tts_graph_pair(torch, hit)
        ((res_e, calls_e), t_eager, s_eager), ((res_g, calls_g), t_graph, s_graph) = pair["eager"], pair["graph"]
        where = f"{label} (c) bf16 prompt-cache hit T={temperature}"
        (kw, out_g), (_, out_e) = calls_g[0], calls_e[0]
        bad = loop_mismatches(torch, out_e, out_g)
        if not kw["cached_len"] or bad or not np.array_equal(res_e.audio, res_g.audio):
            fail(f"{where}: cached_len {kw['cached_len']}, the graph's {bad} (audio equal "
                 f"{np.array_equal(res_e.audio, res_g.audio)}) differ from the eager loop's")
        check_graph_counts(where, s_eager, s_graph, 1, frames_stepped(out_g.length, frames))
        walls[f"hit_{temperature}"] = (t_eager, t_graph)
        say(f"{where}: generate, {res_g.timings.chunks} chunks after a cached prefix of {kw['cached_len']} "
            f"positions, {frames} frames: codes, n_frames, length {out_g.length}, cache and audio bit-equal to the "
            f"eager run's | eager {t_eager:.3f} s, graph {t_graph:.3f} s | graph by device {json.dumps(s_graph)} | "
            f"{card}")
    return {"walls": walls}


# ---------------------------------------------------------------------------
# Phases 21-23: evaluation, load and operations (run after phase 15)
# ---------------------------------------------------------------------------

# phase 21: the teacher trajectory's length (the JAX harness's default)
TF_TOKENS = 96
# phase 22: the burst (16 x 30 s) and the Poisson mix (12 clips of 30, 60
# and 90 s at 1x the burst's audio-seconds per second, tools/perf_serve.py's
# rule), the depth sampler's interval
LOAD_BURST = 16
LOAD_MIX = (30, 60, 90) * 4
LOAD_SEED = 10
# phase 23: the regression dataset's clips (s), the profiled CLI run's
# token budget (a trace of the full 224-token budget runs to hundreds of
# MB of JSON; 16 tokens keep every kernel of the run in it)
REGRESSION_SECONDS = (30, 60, 90)
PROFILE_SAMPLE_LENGTH = 16
# CUPTI's names of the kernels (csrc/*.cu) → their counters' keys
TRACE_KERNELS = (
    ("log_mel_kernel", "log_mel"), ("mha_encoder_", "mha_encoder"),
    ("cross_attend_q8_kernel<true>", "cross_attend_q8_probs"), ("cross_attend_q8_kernel<false>", "cross_attend_q8"),
    ("self_attend_q8_kernel", "self_attend_q8"), ("self_attend_kernel", "self_attend"),
)


def finite(*xs) -> bool:
    import math

    return all(x is None or math.isfinite(x) for x in xs)


def phase_quant_divergence(torch, card: str, pipe, audio) -> dict:
    """Phase 21: eval/quant_delta at large-v3 on phase 4's random tree.
    teacher_forced_divergence on the first 30 s window (TF_TOKENS tokens of
    the bf16 greedy teacher, T == 1 steps through K4; each scheme's
    full-sequence pass through K2 and, over an int8 cross-KV, K3) for every
    scheme of DEFAULT_SCHEMES; then quant_divergence on the 600 s audio
    with pipeline_options(GROUP), the pipeline once per scheme and a
    control that repeats the bf16 run, which must not diverge at all. The
    launch counts of the whole phase are the path `eval`."""
    from whisperkit_tpu_torch.eval.quant_delta import (
        DEFAULT_SCHEMES,
        quant_divergence,
        teacher_forced_divergence,
    )
    from whisperkit_tpu_torch.ops import _build
    from whisperkit_tpu_torch.pipelines.whisper import WINDOW_SAMPLES
    from whisperkit_tpu_torch.tools.workload import pipeline_options

    import dataclasses

    label = "phase 21 quantization divergence"
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    tf = teacher_forced_divergence(pipe.dims, pipe.params, audio[:WINDOW_SAMPLES], max_tokens=TF_TOKENS)
    torch.cuda.synchronize()
    tf_s = time.perf_counter() - t0
    if [r.scheme for r in tf] != list(DEFAULT_SCHEMES) or len({r.n_steps for r in tf}) != 1:
        fail(f"{label}: teacher-forced reports {[(r.scheme, r.n_steps) for r in tf]}")
    for r in tf:
        if not finite(r.tf_agreement, r.margin_bf16_median, r.flip_margin_median, r.mean_abs_logit_delta):
            fail(f"{label}: {r.scheme} teacher-forced figures are not finite: {r}")
        say(f"{label}, teacher-forced {r.scheme}: tf_agreement {r.tf_agreement} ({r.n_flips} flips in {r.n_steps} "
            f"steps) | margin_bf16_median {r.margin_bf16_median} | flip_margin_median {r.flip_margin_median} | "
            f"mean_abs_logit_delta {r.mean_abs_logit_delta} | {card}")
    schemes = {**DEFAULT_SCHEMES, "bf16_control": (None, {})}
    t0 = time.perf_counter()
    free = quant_divergence(pipe.dims, pipe.params, [audio], pipeline_options(GROUP), schemes)
    torch.cuda.synchronize()
    free_s = time.perf_counter() - t0
    counts = dict(_build.launches)
    for r in free:
        say(f"{label}, free-running {r.scheme} on {AUDIO_SECONDS:.0f} s: wer_vs_bf16 {r.wer_vs_bf16} | "
            f"token_divergence {r.token_divergence} ({r.n_diverged_tokens} of {r.n_ref_tokens} tokens) | "
            f"identical_text {r.identical_text} | {card}")
    control = free[-1]
    if control.scheme != "bf16_control" or control.n_diverged_tokens or not control.identical_text:
        fail(f"{label}: the bf16 control diverged from the bf16 run: {control}")
    if not all(r.n_ref_tokens == control.n_ref_tokens > 0 and finite(r.wer_vs_bf16) for r in free):
        fail(f"{label}: free-running reports {free}")
    check_launches(label, counts, ("log_mel", "mha_encoder", "cross_attend_q8", "self_attend", "self_attend_q8"),
                   ("cross_attend_q8", "self_attend", "self_attend_q8"), ("cross_attend_q8_probs",),
                   pipe.dims.n_text_layer)
    say(f"{label}: teacher-forced {tf_s:.3f} s, free-running {len(free)} runs of {AUDIO_SECONDS:.0f} s in "
        f"{free_s:.3f} s | launches {json.dumps(counts)} | {card}")
    return {"counts": counts, "teacher_forced_s": tf_s, "free_running_s": free_s,
            "teacher_forced": [dataclasses.asdict(r) for r in tf], "free_running": [dataclasses.asdict(r) for r in free]}


def phase_loadgen(torch, card: str, pipe, audio) -> dict:
    """Phase 22: eval/loadgen.run_load over a BatchScheduler (max_batch 16)
    on phase 13's pipeline (W8A16, int8 cross-KV, bf16 self-KV: the
    headline configuration) with pipeline_options(GROUP): a burst of
    LOAD_BURST 30 s clips cut from phase 4's audio, then Poisson arrivals
    of LOAD_MIX at 1x the burst's audio-seconds per second, the queue depth
    sampled. Every request must return, and the burst must batch (mean
    fill above 1). Its launch counts are the path `loadgen`."""
    import numpy as np

    from whisperkit_tpu_torch.eval.loadgen import poisson_gaps, run_load
    from whisperkit_tpu_torch.ops import _build
    from whisperkit_tpu_torch.pipelines.scheduler import BatchScheduler
    from whisperkit_tpu_torch.tools.workload import pipeline_options

    label = "phase 22 load generator"
    sr = 16_000
    options = pipeline_options(GROUP)
    burst = [audio[i * 30 * sr:(i + 1) * 30 * sr] for i in range(LOAD_BURST)]
    mix = [audio[i * 10 * sr:(i * 10 + s) * sr] for i, s in enumerate(LOAD_MIX)]
    sched = BatchScheduler(pipe, max_batch=16)
    runs = {}
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        runs["burst"] = run_load(sched, pipe, burst, options, timeout=600)
        capacity = runs["burst"]["audio_seconds"] / runs["burst"]["wall_s"]
        rate = capacity / (sum(LOAD_MIX) / len(LOAD_MIX))
        gaps = poisson_gaps(np.random.default_rng(LOAD_SEED), rate, len(mix))
        runs["poisson"] = run_load(sched, pipe, mix, options, arrival_gaps=gaps, sample_queue_depth=True,
                                   timeout=600)
        torch.cuda.synchronize()
        counts = dict(_build.launches)
    finally:
        sched.shutdown()
    runs["poisson"].update(arrival_rps=round(rate, 4), capacity_audio_s_per_s=round(capacity, 2))
    runs["poisson"].pop("queue_depth_trace", None)
    for name, out in runs.items():
        say(f"{label}, {name}: {out['requests']} requests, {out['audio_seconds']} s audio | wall {out['wall_s']} s | "
            f"p50/p90/p99 {out['p50_s']}/{out['p90_s']}/{out['p99_s']} s | agg_tokens_per_s "
            f"{out['agg_tokens_per_s']} | serving_rtf {out['serving_rtf']} | batches {out['batches']}, "
            f"mean_batch_fill {out['mean_batch_fill']}"
            + (f" | queue_depth_max {out['queue_depth_max']}, arrivals {out['arrival_rps']}/s at capacity "
               f"{out['capacity_audio_s_per_s']} audio-s/s" if name == "poisson" else "") + f" | {card}")
    if runs["burst"]["mean_batch_fill"] <= 1:
        fail(f"{label}: the burst did not batch (mean fill {runs['burst']['mean_batch_fill']})")
    if "queue_depth_max" not in runs["poisson"]:
        fail(f"{label}: no queue depth was sampled")
    check_launches(label, counts, ("log_mel", "mha_encoder", "cross_attend_q8", "self_attend"),
                   ("cross_attend_q8", "self_attend"), ("self_attend_q8", "cross_attend_q8_probs"),
                   pipe.dims.n_text_layer)
    say(f"{label}: launches {json.dumps(counts)} | {card}")
    return {"counts": counts, **runs}


def trace_kernel_counts(trace: dict) -> dict:
    """Device kernel events of a Chrome trace, counted per kernel of
    csrc/*.cu (TRACE_KERNELS) by CUPTI's names."""
    counts = {key: 0 for _, key in TRACE_KERNELS}
    for e in trace.get("traceEvents", []):
        if e.get("cat") != "kernel":
            continue
        key = next((k for part, k in TRACE_KERNELS if part in e.get("name", "")), None)
        if key is not None:
            counts[key] += 1
    return counts


def phase_operations(torch, card: str, bf16_pipe, audio, folder: Path, root: Path, wav: Path,
                     load_13: float) -> dict:
    """Phase 23 on phase 13's folder. (a) `python -m
    whisperkit_tpu_torch.eval.regression` in a child process on a dataset
    of three WAVs (REGRESSION_SECONDS of phase 4's audio, each with a .txt
    transcript): exit 0, a record per file, WER not null, every figure
    finite. (b) The loader's caches: the folder loaded as W8A16 serving
    three times, the port's caches deleted first: the first load writes
    them, the second reads them (every leaf torch.equal to
    quantize_whisper_params of phase 4's tree), the third, after
    os.utime on the safetensors, rebuilds them. (c) `python -m
    whisperkit_tpu_torch.cli transcribe --profile-dir D` on the 60 s WAV in
    a child process (PROFILE_SAMPLE_LENGTH tokens): exit 0, one trace under
    D that json.load reads, in which K1, K2 and K4 ran (the path `profile`:
    the trace's kernel events). (d) A ModelManager over the folder's load,
    asked from four threads at once, loads once."""
    import os
    import threading

    from whisperkit_tpu_torch.core.configurations import ComputeOptions, WhisperConfig
    from whisperkit_tpu_torch.core.model_manager import ModelManager
    from whisperkit_tpu_torch.core.modelstate import ModelState
    from whisperkit_tpu_torch.models.loader import cache_paths
    from whisperkit_tpu_torch.ops.quant import quantize_whisper_params
    from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline

    label = "phase 23"
    # (a) the regression harness
    data = root / "dataset"
    data.mkdir()
    for s in REGRESSION_SECONDS:
        write_wav(data / f"clip_{s}s.wav", audio[: s * 16_000])
        (data / f"clip_{s}s.txt").write_text("the quick brown fox jumps over the lazy dog")
    stats_path = root / "stats.jsonl"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "whisperkit_tpu_torch.eval.regression", str(folder), str(data),
                           "--out", str(stats_path)], capture_output=True, text=True, cwd=REPO, timeout=600)
    regression_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{label} regression: exit {proc.returncode}: {proc.stderr[-2000:]}")
    records = [json.loads(x) for x in stats_path.read_text().splitlines()]
    numeric = [v for r in records for v in r.values() if isinstance(v, (int, float)) and not isinstance(v, bool)]
    if len(records) != len(REGRESSION_SECONDS) or any(r["wer"] is None for r in records) or not finite(*numeric):
        fail(f"{label} regression: records {records}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    say(f"{label} regression: `python -m whisperkit_tpu_torch.eval.regression` on {len(records)} WAVs "
        f"({'/'.join(map(str, REGRESSION_SECONDS))} s), exit 0 in {regression_s:.3f} s | per file (wer, tok/s, RTF, "
        f"windows, fallbacks): "
        + "; ".join(f"{r['file']} ({r['wer']:.3f}, {r['tokens_per_second']:.1f}, {r['real_time_factor']:.4f}, "
                    f"{r['windows']}, {r['fallbacks']})" for r in records)
        + f" | summary {json.dumps(summary)} | {card}")

    # (b) the caches
    config = WhisperConfig(model_folder=str(folder), download=False,
                           compute_options=ComputeOptions.serving(quantization="w8a16"))
    want = quantize_whisper_params(bf16_pipe.params)
    files = [p for scheme in (None, "w8a16") for p in cache_paths(folder, scheme)]
    for p in files:
        p.unlink(missing_ok=True)
    loads = []
    for step in ("write", "hit", "rebuild"):
        if step == "rebuild":
            st = folder / "model.safetensors"
            os.utime(st, ns=(st.stat().st_atime_ns, st.stat().st_mtime_ns + 10**9))
        before = {p: p.stat().st_mtime_ns if p.exists() else None for p in files}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = WhisperPipeline(config)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
        bad = tree_mismatches(torch, pipe.params, want)
        if bad:
            fail(f"{label} caches, {step}: {len(bad)} leaves differ from quantize_whisper_params of phase 4's tree: "
                 f"{bad[:5]}")
        rewritten = [p.name for p in files if p.exists() and p.stat().st_mtime_ns != before[p]]
        if (step == "hit") == bool(rewritten) or not all(p.exists() for p in files):
            fail(f"{label} caches, {step}: rewrote {rewritten} of {[p.name for p in files]}")
        del pipe
    sizes = {p.name: p.stat().st_size for p in files if p.suffix == ".pt"}
    say(f"{label} caches: W8A16 serving loads of the folder: writing the caches {loads[0]:.3f} s, from the caches "
        f"{loads[1]:.3f} s (every leaf equal to quantize_whisper_params of phase 4's tree), after os.utime on the "
        f"safetensors (rebuilt) {loads[2]:.3f} s; phase 13's load (parse, quantize and write) {load_13:.3f} s | "
        f"cache bytes {json.dumps(sizes)} | {card}")

    # (c) --profile-dir
    trace_dir = root / "profile"
    argv = ["transcribe", "--model-folder", str(folder), "--audio-path", str(wav), "--chunking-strategy", "vad",
            "--no-download", "--temperature-fallback-count", "0", "--sample-length", str(PROFILE_SAMPLE_LENGTH),
            "--profile-dir", str(trace_dir)]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "whisperkit_tpu_torch.cli", *argv], capture_output=True, text=True,
                          cwd=REPO, timeout=600)
    profile_s = time.perf_counter() - t0
    traces = sorted(trace_dir.glob("*.json"))
    if proc.returncode != 0 or len(traces) != 1 or f"profiler trace written to {traces[0]}" not in proc.stderr:
        fail(f"{label} --profile-dir: exit {proc.returncode}, traces {traces}: {proc.stderr[-2000:]}")
    t0 = time.perf_counter()
    with open(traces[0]) as f:
        trace = json.load(f)
    read_s = time.perf_counter() - t0
    counts = trace_kernel_counts(trace)
    n_events = len(trace.get("traceEvents", []))
    del trace
    check_launches(f"{label} --profile-dir trace", counts, ("log_mel", "mha_encoder", "self_attend"),
                   ("self_attend",), ("cross_attend_q8", "cross_attend_q8_probs", "self_attend_q8"),
                   bf16_pipe.dims.n_text_layer)
    say(f"{label} --profile-dir: `cli transcribe --profile-dir` on the 60 s WAV ({PROFILE_SAMPLE_LENGTH} tokens), exit 0 "
        f"in {profile_s:.3f} s | {traces[0].name}: {traces[0].stat().st_size} bytes, {n_events} events, json.load "
        f"{read_s:.3f} s | kernels in the trace {json.dumps(counts)} | {card}")

    # (d) the model manager
    built = []

    def load():
        built.append(threading.get_ident())
        return WhisperPipeline(config)

    manager = ModelManager(load)
    got = [None] * 4
    threads = [threading.Thread(target=lambda i=i: got.__setitem__(i, manager.ensure_loaded())) for i in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    manager_s = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or len(built) != 1 or not all(p is got[0] for p in got) \
            or manager.state is not ModelState.LOADED:
        fail(f"{label} model manager: {len(built)} loads for 4 threads, state {manager.state}")
    manager.unload()
    del got
    say(f"{label} model manager: 4 threads, 1 load in {manager_s:.3f} s (load_time {manager.load_time:.3f} s) | {card}")
    return {"counts": counts, "regression_s": regression_s, "regression_summary": summary, "load_s": loads,
            "cache_bytes": sizes, "profile_s": profile_s, "trace_bytes": traces[0].stat().st_size,
            "trace_events": n_events, "manager_s": manager_s, "regression_wer": [r["wer"] for r in records]}


# phase 24: the frames TTS generates per chunk in its mesh checks (the
# paragraph's four chunks; 245 at the CLI's defaults take ~20 s a run)
MESH_TTS_FRAMES = 64
# phase 24 (b): a word's start or end may move by one alignment frame
# (20 ms) where the ranks' bf16 sums shift a probability at a DTW tie
MESH_WORD_TOL = 0.02


def mesh_devices(torch) -> tuple[list, str]:
    """Every visible card from two on; else two replicas of cuda:0 (a
    rehearsal: correctness and overhead, not scaling)."""
    n = torch.cuda.device_count()
    if n >= 2:
        return [f"cuda:{i}" for i in range(n)], f"{n} cards"
    return ["cuda:0", "cuda:0"], "two replicas of cuda:0 (one card)"


class DecodeCalls(Spy):
    """Spy on the pipeline's decode_loop: each call's sample_begin and output."""

    def __init__(self):
        from whisperkit_tpu_torch.pipelines import whisper as pipeline_module

        super().__init__(pipeline_module, "decode_loop")
        self.begins = []

    def before(self, *args, **kwargs) -> None:
        self.begins.append(kwargs["sample_begin"])


def windows_of(pipe, audio, options) -> list:
    """The VAD chunks in the pipeline's group order (length-sorted), as
    (chunk index, group, row) on one device."""
    chunks = pipe._vad_chunks(audio, options)
    order = sorted(range(len(chunks)), key=lambda i: len(chunks[i].audio_samples))
    group = min(options.concurrent_worker_count, 1 << max(0, (len(chunks) - 1).bit_length()))
    return [(i, k // group, k % group) for k, i in enumerate(order)]


def one_device_reference(torch, pipe, audio, options) -> tuple:
    """pipe.transcribe on one device, recorded: (result, {chunk: tokens},
    {chunk: the filtered logits' top-2 gap of each step}, each group's
    (decode_loop output, sample_begin))."""
    windows = {}
    with StepLogits(pipe.tokenizer.special.eot) as steps, DecodeCalls() as calls:
        result = pipe.transcribe(audio, options, callback=lambda p: windows.__setitem__(p.window_id, list(p.tokens)))
    torch.cuda.synchronize()
    per_group, at = [], 0
    for out, begin in zip(calls.calls, calls.begins):
        n = int(out.length) - begin
        per_group.append(torch.stack(steps.gaps[at : at + n]).float().cpu())  # [steps, rows]
        at += n
    gaps = {i: per_group[g][:, r].tolist() for i, g, r in windows_of(pipe, audio, options)}
    return result, windows, gaps, list(zip(calls.calls, calls.begins))


def mesh_words_teacher_forced(torch, label, one, pipe, clip, options, ref, teacher) -> dict:
    """Word timings of the same tokens on one device and on the tp mesh:
    the one-device run's tokens of its group (its mel and decode, recorded
    in `teacher`) pass teacher-forced (alignment_forward) through the whole
    tree and through the tp ranks' shards of it, both cast to float32,
    over the raw cross-KV (each rank writes its heads' float32 softmax);
    each chunk's reference segments then take their words from either
    alignment (the pipeline's word-timing rules), which must agree within
    MESH_WORD_TOL. On random weights the alignment heads' rows are near
    flat and the DTW path under them is ill-conditioned: the bf16 rounding
    that the ranks' sums move shifted words by 8 s, and in float32 the int8
    cross-KV's requantized query (a code flipped by the other summation
    order moves a probability by ~1%) still by 0.06 s (PERF.md §6).
    K3's probs form under tp is held on the pipeline's own path by
    mesh_alignment. The alignments' largest difference is reported."""
    import copy

    from whisperkit_tpu_torch.decoding.loop import alignment_forward, encode_window
    from whisperkit_tpu_torch.models.whisper import _map, _with_logits_weight
    from whisperkit_tpu_torch.parallel.sharding import shard_whisper_params
    from whisperkit_tpu_torch.text.word_timestamps import add_word_timestamps

    dims, heads = one.dims, ALIGNMENT_HEADS
    (out, begin), mel = teacher.decodes[0], teacher.mels[0]
    tokens = out.tokens[:, : out.length + 1]
    tree = _with_logits_weight(_map(lambda _, t: t.float() if t.is_floating_point() else t,
                                    {k: v for k, v in one.params.items()}))
    plan = pipe._mesh()
    trees = shard_whisper_params(plan, tree)[0]

    def align(params, dev):
        _, ck, cv = encode_window(params, mel.float().to(dev), dims)
        return alignment_forward(params, ck, cv, tokens.to(dev), dims=dims, alignment_heads=heads)

    single = align(tree, one.device).cpu().numpy()
    ranks = [a.cpu().numpy() for a in plan.run(lambda g, r: align(trees[r], plan.cells()[g][r]))[0]]
    del tree, trees
    align_err = max(float(abs(a - single).max()) for a in ranks)
    chunks = one._vad_chunks(clip, options)
    n_words, exact, worst = 0, 0, 0.0
    for i, g, row in windows_of(one, clip, options):
        if g:
            continue  # the 60 s clip is one group
        seek = chunks[i].seek_offset_index // 160
        segs = [s for s in ref.segments if s.seek == seek]
        sampled = [t for s in segs for t in s.tokens]
        frames = min(3000, -(-len(chunks[i].audio_samples) // 160))
        timed = []
        for a in (single, ranks[0]):
            timed.append([(w.word, w.start, w.end) for seg in add_word_timestamps(
                segments=copy.deepcopy(segs), alignment=a[:, row], sample_begin=begin, tokens=sampled,
                tokenizer=one.tokenizer, language="en", time_offset=seek / 100.0, window_frames=frames,
            ) for w in seg.words or []])
        if [w for w, _, _ in timed[0]] != [w for w, _, _ in timed[1]]:
            fail(f"{label}: the teacher-forced words of chunk {i} differ")
        for (_, s0, e0), (_, s1, e1) in zip(*timed):
            d = max(abs(s0 - s1), abs(e0 - e1))
            worst, exact, n_words = max(worst, d), exact + (d == 0), n_words + 1
    say(f"{label}: teacher-forced on the one-device run's tokens ({tokens.shape[0]} rows x {tokens.shape[1]}): "
        f"alignment max abs {align_err:.3e}; {n_words} words, {exact} timed exactly, largest difference "
        f"{worst:.3f} s (limit {MESH_WORD_TOL})")
    if not n_words or worst > MESH_WORD_TOL + 1e-9:
        fail(f"{label}: {n_words} teacher-forced words; the largest timing difference {worst:.3f} s > "
             f"{MESH_WORD_TOL} s")
    return {"words": n_words, "exact": exact, "worst_s": worst, "align_err": align_err}


def mesh_alignment(torch, label, ref_decodes: list, mesh_decodes: list, tp: int) -> dict:
    """K3's probs form under tp against one device on the pipeline's own
    path: the alignment buffer that the mesh's first decode gathered from
    its ranks' heads (each rank's first decode_loop call, bit-equal across
    ranks) against the one-device run's first decode, row by row over the
    positions before the row's first differing token (their inputs are
    equal), within 2^-4 of the largest probability compared: phase 5's
    bf16 rule applied to the probabilities, since the ranks' bf16 sums move
    the queries. → the worst difference and its limit."""
    if len(mesh_decodes) < tp or not ref_decodes:
        fail(f"{label}: {len(mesh_decodes)} mesh decodes for {tp} ranks, {len(ref_decodes)} on one device")
    ref = ref_decodes[0][0]
    ranks = [out for out, _ in mesh_decodes[:tp]]
    if any(not torch.equal(out.alignment, ranks[0].alignment) for out in ranks[1:]):
        fail(f"{label}: the ranks' gathered alignment buffers differ")
    ours = ranks[0]
    n = min(int(ref.length), int(ours.length)) + 1
    ref_tok, our_tok = ref.tokens[:, :n].cpu(), ours.tokens[:, :n].cpu()
    worst = top = 0.0
    positions = 0
    for r in range(ref_tok.shape[0]):
        differ = (ref_tok[r] != our_tok[r]).nonzero()
        p = int(differ[0]) if len(differ) else n
        a = ref.alignment[:p, r].float()
        b = ours.alignment[:p, r].to(a.device).float()
        if p:
            worst = max(worst, float((a - b).abs().max()))
            top = max(top, float(a.abs().max()))
        positions += p
    tol = 2.0 ** -4 * top
    say(f"{label}: K3p's gathered alignment against one device's over {positions} positions of "
        f"{ref_tok.shape[0]} rows before their first differing token: max abs {worst:.3e} (limit {tol:.3e}, "
        f"2^-4 of the largest probability {top:.3e})")
    if not positions or not worst <= tol:
        fail(f"{label}: the gathered alignment is {worst:.3e} from one device's (limit {tol:.3e}) over "
             f"{positions} positions")
    return {"align_err": worst, "align_tol": tol, "align_positions": positions}


def hold_windows(label, ours: dict, ref: dict, gaps: dict) -> int:
    """Every chunk's tokens against the reference's under the top-2-gap
    rule (first_divergence); → the chunks equal token for token."""
    if sorted(ours) != sorted(ref):
        fail(f"{label}: decoded chunks {sorted(ours)} are not the reference's {sorted(ref)}")
    same, report = 0, []
    for i in sorted(ref):
        div = first_divergence(ours[i], ref[i], gaps[i])
        if div is None:
            same += 1
            continue
        step, gap = div
        report.append(f"chunk {i} at step {step} (gap {gap:.4f})")
        if gap > BF16_GAP_TOL:
            fail(f"{label}: chunk {i} diverges at step {step}, where the reference's top-2 gap is {gap:.4f} > "
                 f"{BF16_GAP_TOL}")
    say(f"{label}: {same} of {len(ref)} chunks equal token for token" +
        (f"; diverging within the gap rule: {', '.join(report)}" if report else ""))
    return same


def mesh_run(torch, pipe, audio, options, counts: dict) -> tuple:
    """One timed transcribe on a mesh pipeline, its launches added to
    `counts` (total and per device) → (result, {chunk: tokens}, wall,
    peak bytes per distinct device, this run's launches by device). The
    decode graph's counts are set to 0 before it (`graph_stats`)."""
    from whisperkit_tpu_torch.decoding import graph
    from whisperkit_tpu_torch.ops import _build

    devices = sorted({str(d) for d in pipe.devices})
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
    windows = {}
    torch.cuda.synchronize()
    _build.reset_launches()
    graph.reset_stats()
    t0 = time.perf_counter()
    result = pipe.transcribe(audio, options, callback=lambda p: windows.__setitem__(p.window_id, list(p.tokens)))
    for d in devices:
        torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    by_device = {d: dict(c) for d, c in _build.launches_by_device.items()}
    for k, v in _build.launches.items():
        counts["total"][k] = counts["total"].get(k, 0) + v
    for d, c in by_device.items():
        for k, v in c.items():
            counts["by_device"].setdefault(d, dict.fromkeys(_build.KERNELS, 0))[k] += v
    return result, windows, wall, {d: torch.cuda.max_memory_allocated(d) for d in devices}, by_device


def phase_collective(torch, card: str) -> dict:
    """Phase 24 (0): the tp group's device all-reduce (csrc/tp_all_reduce.cu)
    on the layout's devices (every card from tp on, else replicas of
    cuda:0), through whisperkit_tpu_torch/tools/tp_collective_check.py:
    bit-equal to the rank-ordered fold at tp 2 and 4 (bf16 and f32 at the
    decoder's shape, f32 alignment rows, f64 and max for W8A8, the
    encoder's 123 MB in chunks); 1,000 eager calls; a graph of 96 calls
    per rank replayed 100 times (three replays held bit-equal, then timed:
    the kernel's device ms per call); a rank that never arrives and a rank
    that fails, each making its peer raise GroupAborted, and a collective
    after each reset; the host barrier form it replaced, timed. → phase
    3's fields for the kernels line, and the checks' figures."""
    from whisperkit_tpu_torch.tools import tp_collective_check as tc

    t0 = time.perf_counter()
    try:
        checks = {"bit_equal": [tc.check_bit_equal(2), tc.check_bit_equal(4)], "eager": tc.check_eager(2),
                  "graph": tc.check_graph(2), "abort": tc.check_abort(2), "host_form": tc.time_host_form(2)}
    except AssertionError as e:
        fail(f"phase 24 (0) the device all-reduce: {e}")
    plain_ms = tc.time_plain(2)
    for check in checks["bit_equal"]:
        say(f"phase 24 (0) all-reduce at tp {check['tp']} on {check['layout']}: bit-equal to the rank-ordered "
            f"fold in every case {json.dumps(check['cases'])} | {card}")
    eager, graph, abort, host = checks["eager"], checks["graph"], checks["abort"], checks["host_form"]
    say(f"phase 24 (0) all-reduce, tp 2, 32 x 1 x 1280 bf16 on {graph['layout']}: {eager['calls']} eager calls "
        f"bit-equal, {eager['host_us_per_call']:.1f} us of host a call | graph of {graph['calls_per_graph']} calls, "
        f"{graph['replays']} replays: {graph['ms'] * 1e3:.2f} us of device a call (bound {graph['bound_ms'] * 1e3:.3f} "
        f"us, {graph['bound_by']}) | plain version {plain_ms * 1e3:.2f} us | the host barrier form it replaced "
        f"{host['host_us_per_call']:.1f} us a call, {host['host_waits_per_call']:.0f} waits a rank | {card}")
    say(f"phase 24 (0) all-reduce faults: a peer that never arrives raised GroupAborted after "
        f"{abort['raised_after_s']:.3f} s (timeout {abort['timeout_s']} s); a failing peer ended the wait after "
        f"{abort['abort_ended_wait_after_s']:.3f} s; bit-equal after each reset {abort['bit_equal_after_reset']} "
        f"| {time.perf_counter() - t0:.1f} s | {card}")
    kernel = {"max_abs_err": 0.0, "ms": graph["ms"], "plain_ms": plain_ms, "bound_ms": graph["bound_ms"],
              "bound_by": graph["bound_by"], "library_ms": None, "layout": graph["layout"],
              "eager_host_us": eager["host_us_per_call"], "host_form_us": host["host_us_per_call"]}
    return {"kernel": kernel, **checks}


class RankGraphs:
    """Within the `with` block, per mesh thread: the decode steps that ran
    eagerly with a decoder (`_step(forward=True)` of `module`, the loop or
    beam search: in a graph run, a capture's warm-up and its recording),
    the captures and replays of decoding/graph.StepGraph, and the tp
    group's host barrier waits, in order; each thread's rank from the
    trees its `_advance` runs on. `by_rank()` sums them per rank;
    `waits_between_replays` counts the waits a thread made between two of
    its replays with no capture between (a replayed stretch)."""

    def __init__(self, module):
        import threading

        from whisperkit_tpu_torch.decoding import graph
        from whisperkit_tpu_torch.parallel import group

        self.module, self.graph, self.group, self.threading = module, graph, group, threading
        self.events: dict[int, list] = {}
        self.rank: dict[int, int] = {}

    def _log(self, what: str) -> None:
        self.events.setdefault(self.threading.get_ident(), []).append(what)

    def __enter__(self):
        spy, step_graph, tp_group = self, self.graph.StepGraph, self.group.TPGroup
        self.saved = (self.module._advance, self.module._step, step_graph.__init__, step_graph.replay, tp_group._wait)
        advance, step, init, replay, wait = self.saved

        def advance_(st, *args, **kwargs):
            spy.rank[spy.threading.get_ident()] = st.params["tp"].rank
            return advance(st, *args, **kwargs)

        def step_(st, forward, *args, **kwargs):
            if forward:
                spy._log("s")
            return step(st, forward, *args, **kwargs)

        def init_(self_, *args, **kwargs):
            init(self_, *args, **kwargs)
            spy._log("c")

        def replay_(self_):
            replay(self_)
            spy._log("r")

        def wait_(self_, r):
            spy._log("w")
            return wait(self_, r)

        self.module._advance, self.module._step = advance_, step_
        step_graph.__init__, step_graph.replay, tp_group._wait = init_, replay_, wait_
        return self

    def __exit__(self, *exc):
        self.module._advance, self.module._step = self.saved[:2]
        self.graph.StepGraph.__init__, self.graph.StepGraph.replay, self.group.TPGroup._wait = self.saved[2:]

    def by_rank(self) -> dict:
        out = {}
        for tid, events in self.events.items():
            if tid not in self.rank:
                continue
            per = out.setdefault(self.rank[tid], {"eager_steps": 0, "captures": 0, "replays": 0, "waits": 0,
                                                  "waits_between_replays": 0})
            for e in events:
                per[{"s": "eager_steps", "c": "captures", "r": "replays", "w": "waits"}[e]] += 1
            last, pending = None, 0
            for e in events:
                if e == "w":
                    pending += 1
                    continue
                if e == "r" and last == "r":
                    per["waits_between_replays"] += pending
                last, pending = (e if e in "rc" else last), 0
        return out


def check_rank_graphs(label, graphed: dict, eager: dict, tp: int, captures_each: int) -> None:
    """Fail unless every rank of the graph run captured and replayed, made
    no host wait inside a replayed stretch, and ran as many steps with a
    decoder as the eager run's (each the warm-up of a capture, which a
    capture records again, or a replay), and the eager run captured none."""
    bad = []
    if sorted(graphed) != list(range(tp)) or sorted(eager) != list(range(tp)):
        bad.append(f"ranks {sorted(graphed)} (graph), {sorted(eager)} (eager)")
    for r in range(tp):
        g, e = graphed.get(r, {}), eager.get(r, {})
        if not g.get("captures") or g["captures"] % captures_each or not g.get("replays"):
            bad.append(f"rank {r} captured {g.get('captures')}, replayed {g.get('replays')}")
        if g.get("waits_between_replays"):
            bad.append(f"rank {r} waited on the host {g['waits_between_replays']} times between replays")
        if e.get("captures") or g.get("captures", 0) + g.get("replays", 0) != e.get("eager_steps"):
            bad.append(f"rank {r}: {g.get('captures')} captures + {g.get('replays')} replays against "
                       f"{e.get('eager_steps')} eager steps ({e.get('captures')} captures in the eager run)")
    if bad:
        fail(f"{label}: " + "; ".join(bad))


def same_outputs(torch, ours: list, ref: list, fields) -> bool:
    """Whether each output of `ours` equals one of `ref` in every field
    (tensors bit for bit), one for one (a rank's calls in any order)."""
    def equal(a, b) -> bool:
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
                if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) and torch.equal(x, y.to(x.device))):
                    return False
            elif x != y:
                return False
        return True

    left = list(ref)
    for a in ours:
        hit = next((i for i, b in enumerate(left) if equal(a, b)), None)
        if hit is None:
            return False
        left.pop(hit)
    return not left


def stream_busy_ms(prof, path: Path) -> dict:
    """Per CUDA stream of a torch.profiler trace: the union of its device
    activities' intervals (ms) and the tp all-reduce's kernel time (ms)."""
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    path.unlink()
    spans: dict = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        key = f"device {e['args'].get('device')} stream {e['args'].get('stream')}"
        spans.setdefault(key, []).append((e["ts"], e["ts"] + e["dur"], "tp_all_reduce" in e.get("name", "")))
    out = {}
    for key, iv in spans.items():
        busy, cur_s, cur_e = 0.0, None, None
        for a, b, _ in sorted(iv):
            if cur_e is None or a > cur_e:
                busy += 0.0 if cur_e is None else cur_e - cur_s
                cur_s, cur_e = a, b
            else:
                cur_e = max(cur_e, b)
        busy += 0.0 if cur_e is None else cur_e - cur_s
        out[key] = {"busy_ms": busy / 1e3, "all_reduce_ms": sum(b - a for a, b, ar in iv if ar) / 1e3,
                    "activities": len(iv)}
    return out


# the tp step's timing: a prompt of TP_STEP_START tokens, then TP_STEPS
# replays of the step's graph from the next position (profile_step's
# decode point: a 224-key self-KV cache)
TP_STEP_START, TP_STEPS = 112, 50


def tp_step_times(torch, one, mesh_pipe, mel) -> dict:
    """A decode step at B = mel rows on one device (`one`'s tree) and on
    each rank of the tp mesh pipeline, each as its CUDA graph replayed
    TP_STEPS times from the position after a prompt of TP_STEP_START
    tokens: host-clock ms per step (three rounds after a warm one, each
    rank's stream synced before and after; the ranks' rounds run
    together), and each stream's device busy per step from a
    torch.profiler trace of one more round (on replicas of one card the
    ranks' streams share its memory and SMs)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from whisperkit_tpu_torch.core.configurations import DecodingOptions
    from whisperkit_tpu_torch.decoding import loop

    sp = one.tokenizer.special
    options = DecodingOptions(language="en", first_token_log_prob_threshold=None)
    base, sot_index = one._build_prompt(options, "en")
    prompt = base + list(range(1000, 1000 + TP_STEP_START - len(base)))
    kwargs = dict(dims=one.dims, special=sp, sample_begin=TP_STEP_START, max_new_tokens=TP_STEPS + 2,
                  sot_index=sot_index)
    rest = dict(top_k=options.top_k, use_timestamp_rules=not options.without_timestamps,
                suppress_blank=options.suppress_blank, cuda_graph=True, alignment_heads=None,
                quantize_self_kv=False)

    def ready(tree, dev):
        """The decode after its first step (eager, then captured)."""
        with torch.inference_mode():
            _, ck, cv = loop.encode_window(tree, mel.to(dev), one.dims, quantize_kv=True)
            p = torch.tensor([prompt] * mel.shape[0], dtype=torch.long, device=dev)
            pre = loop.prefill_window(tree, ck, cv, p, **kwargs)
            st, _ = loop._start(tree, ck, cv, p, one._suppress_bias(options).to(dev),
                                one._decode_scalars(options, 0.0, 0), pre, **kwargs, **rest)
            loop._advance(st, TP_STEP_START + 1, 1_000_000)
        return st

    def replays(st) -> None:
        with torch.inference_mode():
            st.pos_dev.fill_(TP_STEP_START + 1)
            st.mask_row[:, TP_STEP_START + 1 :] = float("-inf")
            for _ in range(TP_STEPS):
                st.graph.replay()

    def rounds(st, n: int) -> list:
        walls = []
        for _ in range(n):
            torch.cuda.current_stream().synchronize()
            t0 = time.perf_counter()
            replays(st)
            torch.cuda.current_stream().synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / TP_STEPS)
        return walls

    def traced(run) -> dict:
        with tempfile.TemporaryDirectory(prefix="whisperkit-smoke-") as tmp:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            per = stream_busy_ms(prof, Path(tmp) / "trace.json")
        top = sorted(per.items(), key=lambda kv: -kv[1]["busy_ms"])
        return {k: {x: y / TP_STEPS if x != "activities" else y for x, y in v.items()} for k, v in top
                if v["activities"] >= TP_STEPS}

    out = {}
    st = ready(one.params, one.device)
    rounds(st, 1)
    out["one_device"] = {"wall_ms": rounds(st, 3), "busy": traced(lambda: replays(st))}
    loop._release(st)
    del st
    plan, trees = mesh_pipe._mesh(), mesh_pipe._mesh_trees[0]
    states = plan.run(lambda g, r: ready(trees[r], plan.cells()[g][r]))[0]
    plan.run(lambda g, r: rounds(states[r], 1))
    walls = plan.run(lambda g, r: rounds(states[r], 3))[0]
    busy = traced(lambda: plan.run(lambda g, r: replays(states[r])))
    plan.run(lambda g, r: loop._release(states[r]))
    out["tp"] = {"wall_ms_by_rank": walls, "busy": busy}
    return out


def phase_mesh(torch, card: str, bf16_pipe, w8_params, audio) -> dict:
    """Phase 24, Whisper over the dcn x dp x tp mesh (parallel/), each run
    against the same tree on one device in this process:
    (a) dp = 2, serving(quantization="w8a16") on the 600 s audio: every
        chunk's tokens under the top-2-gap rule, wall, peak per device,
        launches per device; with four cards or more also dp = 2 x tp = 2;
    (0) the device all-reduce (phase_collective);
    (b) tp = 2, bf16 serving, ALIGNMENT_HEADS, word timestamps on the first
        60 s (K3's probs form on each rank's heads), each rank's decode on
        its CUDA graph: tokens under the gap rule; the gathered alignment
        buffer against one device's before each row's first differing
        token (mesh_alignment); the word timings of the one-device run's
        tokens, teacher-forced through both in float32
        (mesh_words_teacher_forced), within MESH_WORD_TOL; one
        teacher-forced decoder step's logits within phase 5's bf16 limit
        (2^-4 of the largest logit), the ranks' bit-equal; the same run
        with every rank's steps eager, bit-equal, and beam 5 the same way
        (RankGraphs, check_rank_graphs); a step at B = 32 timed on one
        device and on each rank (tp_step_times);
    (c) W8A8 at tp = 2: the encoder of 4 windows against the unsharded one,
        within JAX's test limit (rtol 3e-2, atol 6e-2; the ranks sum exact
        integer accumulators, so it is expected bit-equal);
    (d) the sequence-parallel encoder at tp = 2 (K2 with 750 queries over
        1500 keys), batch 1 at large-v3, against the replicated one within
        2^-4 of the largest output.
    The mesh runs' launches make the path `mesh`: K1-K4, K3's probs form and
    the all-reduce must all launch, and K2, K3, K4 and the all-reduce on
    every mesh device."""
    import dataclasses

    import numpy as np

    from whisperkit_tpu_torch.core.configurations import ComputeOptions, WhisperConfig
    from whisperkit_tpu_torch.decoding import beam, loop
    from whisperkit_tpu_torch.decoding.loop import encode_window, prefill_window
    from whisperkit_tpu_torch.models import whisper as model
    from whisperkit_tpu_torch.ops import _build
    from whisperkit_tpu_torch.parallel.mesh import make_mesh, shard_params_replicated
    from whisperkit_tpu_torch.parallel.sharding import encoder_seq_sharding, shard_whisper_params
    from whisperkit_tpu_torch.pipelines import whisper as pipeline_module
    from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
    from whisperkit_tpu_torch.tools.workload import pipeline_options

    devices, layout = mesh_devices(torch)
    say(f"phase 24 mesh: devices {layout}: {devices} | {card}")
    dims = bf16_pipe.dims
    counts = {"total": {}, "by_device": {}}
    out = {"layout": layout, "collective": phase_collective(torch, card)}
    options = pipeline_options(GROUP)

    def config(**co):
        return WhisperConfig(compute_options=ComputeOptions.serving(**co), load=False)

    # (a) dp = 2 (and dp 2 x tp 2 on four cards), W8A16 serving, 600 s
    shapes = [("a", {"dp_size": 2}, devices[:2])]
    if len(devices) >= 4:
        shapes.append(("a4", {"dp_size": 2, "tp_size": 2}, devices[:4]))
    one = WhisperPipeline(config(quantization="w8a16", dp_size=1), dims=dims, params=w8_params, device=devices[0])
    t0 = time.perf_counter()
    ref, ref_windows, gaps, _ = one_device_reference(torch, one, audio, options)
    ref_wall = time.perf_counter() - t0
    for key, co, devs in shapes:
        label = f"phase 24 ({key}) {co}, W8A16 serving, {AUDIO_SECONDS:.0f} s"
        pipe = WhisperPipeline(config(quantization="w8a16", **co), dims=dims, params=w8_params, device=devs)
        pipe.transcribe(audio[: 60 * 16_000], options)  # warm: the workers' first launches
        result, windows, wall, peaks, by_device = mesh_run(torch, pipe, audio, options, counts)
        graphs = graph_stats(by_device=True)
        check_segments(label, result.segments)
        same = hold_windows(label, windows, ref_windows, gaps)
        plan = pipe._mesh()
        say(f"{label}: mesh dcn {plan.dcn} x dp {plan.dp} x tp {plan.tp} | wall {wall:.3f} s (one device "
            f"{ref_wall:.3f} s, eager: with the step recorder) | {len(result.segments)} segments, {same} of "
            f"{len(ref_windows)} chunks equal | peak per device "
            f"{json.dumps({d: round(b / 2**30, 2) for d, b in peaks.items()})} GiB | launches per device "
            f"{json.dumps(by_device)} | decode graph per device (each mesh thread captures its own) "
            f"{json.dumps(graphs)} | {card}")
        if not all(graphs.get(str(torch.device(d)), {}).get("replays") for d in devs):
            fail(f"{label}: a device's decode replayed no CUDA graph: {graphs}")
        out[key] = {"wall": wall, "one_device_wall": ref_wall, "same": same, "chunks": len(ref_windows),
                    "peak_gib": {d: b / 2**30 for d, b in peaks.items()}, "launches_by_device": by_device,
                    "graph_by_device": graphs}
        del pipe
    del one

    # (b) tp = 2, bf16 serving, word timestamps, 60 s
    label = "phase 24 (b) tp 2, bf16 serving, word timestamps, 60 s"
    clip = audio[: 60 * 16_000]
    words_options = dataclasses.replace(options, word_timestamps=True)
    one = WhisperPipeline(config(dp_size=1), dims=dims, params=bf16_pipe.params, device=devices[0],
                          alignment_heads=ALIGNMENT_HEADS)
    with Spy(pipeline_module, "encode_window") as teacher:
        teacher.mels = []
        teacher.before = lambda params, mel, *a, **kw: teacher.mels.append(mel)
        ref, ref_windows, gaps, teacher.decodes = one_device_reference(torch, one, clip, words_options)
    pipe = WhisperPipeline(config(tp_size=2, dp_size=1), dims=dims, params=bf16_pipe.params, device=devices[:2],
                           alignment_heads=ALIGNMENT_HEADS)
    group = pipe._mesh().groups[0]
    waits0 = group.host_waits
    with DecodeCalls() as mesh_calls, RankGraphs(loop) as ranks_graph:
        result, windows, wall, peaks, by_device = mesh_run(torch, pipe, clip, words_options, counts)
    graphed = {"graph": graph_stats(), "waits": group.host_waits - waits0, "counts": dict(_build.launches)}
    # the same run with every rank's steps eager (`cuda_graph=False`'s path)
    graphs_on = loop._graphs_on
    loop._graphs_on = lambda device: False
    try:
        waits0 = group.host_waits
        with DecodeCalls() as eager_calls, RankGraphs(loop) as ranks_eager:
            eager_result, eager_windows, eager_wall, _, _ = mesh_run(torch, pipe, clip, words_options,
                                                                     {"total": {}, "by_device": {}})
        eager = {"graph": graph_stats(), "waits": group.host_waits - waits0, "counts": dict(_build.launches)}
    finally:
        loop._graphs_on = graphs_on
    fields = ("tokens", "token_logprobs", "length", "no_speech_prob", "alignment")
    equal = {"windows": windows == eager_windows,
             "decodes": same_outputs(torch, mesh_calls.calls, eager_calls.calls, fields),
             "launches": graphed["counts"] == eager["counts"]}
    rank_graph, rank_eager = ranks_graph.by_rank(), ranks_eager.by_rank()
    replays = sum(v["replays"] for v in rank_graph.values())
    say(f"{label}, graph against eager (each rank's steps eager): bit-equal {json.dumps(equal)} over "
        f"{len(mesh_calls.calls)} decodes (tokens, log-probs, length, no-speech, gathered alignment) | wall graph "
        f"{wall:.3f} s, eager {eager_wall:.3f} s | per rank (graph) {json.dumps(rank_graph)} | per rank (eager) "
        f"{json.dumps(rank_eager)} | host barrier waits: graph run {graphed['waits']}, eager run {eager['waits']}; "
        f"inside replayed stretches {sum(v['waits_between_replays'] for v in rank_graph.values())} over {replays} "
        f"replays | launches {json.dumps(graphed['counts'])} | {card}")
    if not all(equal.values()):
        fail(f"{label}: the tp decode on its graphs differs from the eager tp decode: {equal}; launches graph "
             f"{graphed['counts']}, eager {eager['counts']}")
    check_rank_graphs(label, rank_graph, rank_eager, 2, 1)
    if eager_result.text != result.text:
        fail(f"{label}: the eager tp run's text differs from the graph run's")
    check_segments(label, result.segments)
    same = hold_windows(label, windows, ref_windows, gaps)
    gathered = mesh_alignment(torch, label, teacher.decodes, list(zip(mesh_calls.calls, mesh_calls.begins)),
                              pipe._mesh().tp)
    del mesh_calls
    words = mesh_words_teacher_forced(torch, label, one, pipe, clip, words_options, ref, teacher)
    n_words, exact, worst = words["words"], words["exact"], words["worst_s"]
    require_mesh_launches(label, by_device, ("cross_attend_q8_probs",), ("cross_attend_q8_probs",))
    # one teacher-forced step: the rank trees against the whole tree
    plan = pipe._mesh()
    trees = pipe._mesh_trees[0]
    sp = one.tokenizer.special
    mel = one._mel_batch([clip[i * 480_000 : (i + 1) * 480_000] for i in range(2)])
    prompt = torch.tensor([[sp.sot, sp.language_token("en"), sp.transcribe]] * 2, device=devices[0])
    token = torch.full((2, 1), sp.timestamp_begin, device=devices[0])

    def step(tree, dev):
        _, ck, cv = encode_window(tree, mel.to(dev), dims, quantize_kv=True)
        pre = prefill_window(tree, ck, cv, prompt.to(dev), dims=dims, special=sp, sample_begin=3,
                             max_new_tokens=224, sot_index=0)
        with torch.inference_mode():
            return model.decoder_forward(tree, token.to(dev), 3, pre.kv_k, pre.kv_v, ck, cv, dims)[:, -1]

    single = step(bf16_pipe.params, torch.device(devices[0]))
    ranks = plan.run(lambda g, r: step(trees[r], plan.cells()[g][r]))[0]
    err = max(max_abs(torch, x.to(devices[0]), single) for x in ranks)
    tol = 2.0 ** -4 * float(single.abs().max())
    ranks_equal = all(torch.equal(ranks[0].cpu(), x.cpu()) for x in ranks)
    say(f"{label}: wall {wall:.3f} s | {same} of {len(ref_windows)} chunks equal; teacher-forced {n_words} words, "
        f"{exact} timed exactly, largest difference {worst:.3f} s (limit {MESH_WORD_TOL}) | teacher-forced step max "
        f"|Δlogit| {err:.3e} (limit {tol:.3e}), the ranks' logits bit-equal {ranks_equal} | peak per device "
        f"{json.dumps({d: round(b / 2**30, 2) for d, b in peaks.items()})} GiB | launches per device "
        f"{json.dumps(by_device)} | {card}")
    if not err <= tol or not ranks_equal:
        fail(f"{label}: teacher-forced logits {err:.3e} from one device's (limit {tol:.3e}), ranks equal {ranks_equal}")
    out["b"] = {"wall": wall, "eager_wall": eager_wall, "graph_vs_eager": equal, "ranks": rank_graph,
                "ranks_eager": rank_eager, "host_waits": graphed["waits"], "host_waits_eager": eager["waits"],
                "same": same, "words": n_words, "words_exact": exact, "word_worst_s": worst,
                "teacher_align_err": words["align_err"], **gathered,
                "step_err": err, "step_tol": tol, "launches_by_device": by_device}

    # (b) beam 5 at tp 2 on the clip's windows: the graphs against eager
    label = "phase 24 (b) beam 5, tp 2, bf16 serving, 60 s"
    beam_options = dataclasses.replace(options, beam_size=5)
    runs = {}
    graphs_on = beam._graphs_on
    try:
        for mode in ("graph", "eager"):
            beam._graphs_on = graphs_on if mode == "graph" else (lambda device: False)
            with Spy(pipeline_module, "beam_decode_loop") as beams, RankGraphs(beam) as ranks:
                res, wins, w, _, _ = mesh_run(torch, pipe, clip, beam_options,
                                              counts if mode == "graph" else {"total": {}, "by_device": {}})
            runs[mode] = {"result": res, "windows": wins, "wall": w, "calls": beams.calls, "ranks": ranks.by_rank(),
                          "counts": dict(_build.launches), "graph": graph_stats()}
    finally:
        beam._graphs_on = graphs_on
    g, e = runs["graph"], runs["eager"]
    equal_b = {"windows": g["windows"] == e["windows"],
               "decodes": same_outputs(torch, g["calls"], e["calls"],
                                       ("tokens", "token_logprobs", "sum_logprob", "length", "no_speech_prob")),
               "launches": g["counts"] == e["counts"]}
    say(f"{label}: graph against eager bit-equal {json.dumps(equal_b)} over {len(g['calls'])} searches | wall graph "
        f"{g['wall']:.3f} s, eager {e['wall']:.3f} s | per rank (graph) {json.dumps(g['ranks'])} | per rank (eager) "
        f"{json.dumps(e['ranks'])} | {say_graph(g['graph'])} | launches {json.dumps(g['counts'])} | {card}")
    if not all(equal_b.values()):
        fail(f"{label}: the tp beam search on its graphs differs from the eager one: {equal_b}")
    check_rank_graphs(label, g["ranks"], e["ranks"], 2, 2)
    check_segments(label, g["result"].segments)
    out["b_beam"] = {"graph_wall": g["wall"], "eager_wall": e["wall"], "equal": equal_b, "ranks": g["ranks"]}
    del runs, g, e

    # (b) a decode step at B = 32 on one device and on each tp rank
    steps = tp_step_times(torch, bf16_pipe, pipe, group_mel(bf16_pipe, audio, options))
    say(f"phase 24 (b) decode step at B = {GROUP}, S = {TP_STEP_START + TP_STEPS + 2} keys, graph replays: one device "
        f"{json.dumps(steps['one_device'])} | tp 2 on {layout}: {json.dumps(steps['tp'])} | {card}")
    out["b_step"] = steps
    del pipe, one, trees

    # (c) W8A8 at tp = 2: the encoder of 4 windows
    plan = make_mesh(dp=1, tp=2, devices=devices[:2])
    trees = shard_whisper_params(plan, w8_params)[0]
    mel4 = bf16_pipe._mel_batch([audio[i * 480_000 : (i + 1) * 480_000] for i in range(4)])
    with torch.inference_mode():
        ref_enc = model.encoder_forward(w8_params, mel4, dims, act8=True)
        _build.reset_launches()
        t0 = time.perf_counter()
        encs = plan.run(lambda g, r: model.encoder_forward(trees[r], mel4.to(plan.cells()[g][r]), dims, act8=True))[0]
        torch.cuda.synchronize()
        wall_c = time.perf_counter() - t0
    add_counts(counts, _build)
    enc = encs[0].to(devices[0]).float()
    bit_equal = all(torch.equal(e.to(devices[0]), ref_enc) for e in encs)
    excess = float(((enc - ref_enc.float()).abs() - (6e-2 + 3e-2 * ref_enc.float().abs())).max())
    say(f"phase 24 (c) W8A8 encoder at tp 2, 4 windows: max abs {max_abs(torch, enc, ref_enc):.3e}, bit-equal to "
        f"the unsharded encoder {bit_equal} (limit rtol 3e-2 atol 6e-2) | wall {wall_c:.3f} s (first call) | {card}")
    if excess > 0:
        fail(f"phase 24 (c): the tp W8A8 encoder exceeds rtol 3e-2 / atol 6e-2 of the unsharded one")
    out["c"] = {"max_abs": max_abs(torch, enc, ref_enc), "bit_equal": bit_equal}
    del trees, encs, enc, ref_enc

    # (d) the sequence-parallel encoder, tp = 2, batch 1
    seq = encoder_seq_sharding(plan)
    replicas = shard_params_replicated(plan, bf16_pipe.params)
    mel1 = mel4[:1]
    with torch.inference_mode():
        ref_enc = model.encoder_forward(bf16_pipe.params, mel1, dims)
        _build.reset_launches()
        t0 = time.perf_counter()
        encs = plan.run(lambda g, r: model.encoder_forward(
            replicas[plan.cells()[g][r]], mel1.to(plan.cells()[g][r]), dims, seq_group=seq[g][r]))[0]
        torch.cuda.synchronize()
        wall_d = time.perf_counter() - t0
    add_counts(counts, _build)
    err_d = max(max_abs(torch, e.to(devices[0]), ref_enc) for e in encs)
    tol_d = 2.0 ** -4 * float(ref_enc.float().abs().max())
    say(f"phase 24 (d) sequence-parallel encoder at tp 2, batch 1 (K2: 750 queries over 1500 keys): max abs "
        f"{err_d:.3e} (limit {tol_d:.3e}) | wall {wall_d:.3f} s (first call) | {card}")
    if not err_d <= tol_d:
        fail(f"phase 24 (d): the sequence-parallel encoder is {err_d:.3e} off the replicated one (limit {tol_d:.3e})")
    out["d"] = {"max_abs": err_d, "tol": tol_d}
    del replicas, encs, ref_enc, mel4

    # the mesh runs' cached blocks go back to the card: later phases start
    # children (CLI, profiles) that need room for their own contexts
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    free, total_bytes = torch.cuda.mem_get_info()
    out["card_free_gib_after"] = free / 2**30
    total = counts["total"]
    require_mesh_launches("phase 24", counts["by_device"],
                          ("log_mel", "mha_encoder", "cross_attend_q8", "cross_attend_q8_probs", "self_attend",
                           "tp_all_reduce"),
                          ("mha_encoder", "cross_attend_q8", "self_attend", "tp_all_reduce"))
    say(f"phase 24 mesh launches (the path `mesh`): {json.dumps(total)} | per device {json.dumps(counts['by_device'])} "
        f"| card memory free after the phase {free / 2**30:.2f} of {total_bytes / 2**30:.2f} GiB")
    out["counts"] = dict(total)
    out["counts_by_device"] = counts["by_device"]
    return out


def require_mesh_launches(label, by_device: dict, launched, on_every) -> None:
    """Fail unless each kernel of `launched` launched on some device and
    each of `on_every` on every device of `by_device`."""
    missing = [k for k in launched if not any(c.get(k) for c in by_device.values())]
    idle = [d for d, c in by_device.items() if not all(c.get(k) for k in on_every)]
    if missing or idle or not by_device:
        fail(f"{label}: kernels {missing} never launched, devices {idle} missed {on_every}: {json.dumps(by_device)}")


def add_counts(counts: dict, build) -> None:
    for k, v in build.launches.items():
        counts["total"][k] = counts["total"].get(k, 0) + v
    for d, c in build.launches_by_device.items():
        for k, v in c.items():
            counts["by_device"].setdefault(d, dict.fromkeys(build.KERNELS, 0))[k] += v


def tts_mesh_divergence(torch, label, ours, ref, ref_logits, dtypes, row, top_ks, temperature, noise) -> str:
    """'equal', or where the first code of `ours` ([F, 16]) that is not
    `ref`'s (row `row` of the reference run) sits. `ref_logits` holds the
    reference's logits of each sampling call ([B, V] float32, code0 then
    the 15 heads, frame by frame), `dtypes` the dtype each call sampled in
    (the float32 copy casts back exactly). At temperature 0 it fails unless `ours`'s
    token lies within BF16_GAP_TOL of `ref`'s in those logits. Sampled, it
    scores both tokens as the sampler did, logit / T + g, with `noise` the
    reference's uniform draws of each frame ([F, top_k + 15 · head top-k],
    made Gumbel noise as the sampler makes it, dealt to the top-k by rank): the recorded noise must give back `ref`'s
    token, and it fails unless `ours`'s token scores within
    BF16_GAP_TOL / T of it. `ours`'s token may take the noise of any rank
    whose logit lies within BF16_GAP_TOL of its own (bf16 sums reorder
    near-equal logits, and the noise goes by rank); a token outside that
    reach, or a shard sampling with other rows' noise, fails."""
    diff = (ours.cpu() != ref.cpu()).nonzero()
    if not len(diff):
        return "equal"
    f, j = (int(x) for x in diff[0])
    call = ref_logits[f * 16 + j]
    logits = call[row].float().cpu()
    a, b = int(ref[f, j]), int(ours[f, j])
    gap = abs(float(logits[a] - logits[b]))
    if temperature <= 0:
        if gap > BF16_GAP_TOL:
            fail(f"{label}: frame {f} code {j} is {b}, the reference's {a}, at a gap of {gap:.3g} > {BF16_GAP_TOL}")
        return f"first divergence at frame {f} code {j}, gap {gap:.3g}"
    k = top_ks[0] if j == 0 else top_ks[1]
    lo = 0 if j == 0 else top_ks[0] + (j - 1) * top_ks[1]
    # the sampler's own arithmetic: the top-k of the same [B, V] input in
    # its dtype (which fixes the ranks of ties), / T in that dtype, + g
    dtype, inv = dtypes[f * 16 + j], max(temperature, 1e-4)
    vals, idx = call.to(dtype).topk(k, dim=-1)
    u = noise[f, lo : lo + k].float().to(call.device)  # the uniform draws; Gumbel as parallel/mesh.gumbel
    g = -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(torch.float32).tiny)))
    scores = (vals[row] / inv + g).cpu()
    vals, idx, g = vals[row].float().cpu(), idx[row].cpu(), g.cpu()
    if int(idx[int(scores.argmax())]) != a:
        fail(f"{label}: the recorded noise of frame {f} code {j} does not give back the reference's code {a}")
    near = (vals - logits[b]).abs() <= BF16_GAP_TOL
    if not bool(near.any()):
        fail(f"{label}: frame {f} code {j} is {b}, whose logit is not within {BF16_GAP_TOL} of the reference's top-{k}")
    b_scaled = float((call[row, b : b + 1].to(dtype) / inv).float())
    noisy_gap = float(scores.max() - (b_scaled + g[near]).max())
    limit = BF16_GAP_TOL / temperature
    if noisy_gap > limit:
        fail(f"{label}: frame {f} code {j} is {b}, the reference's {a}: their noisy scores are {noisy_gap:.3g} apart "
             f"> {limit:.3g} (logit gap {gap:.3g})")
    return f"first divergence at frame {f} code {j}, logit gap {gap:.3g}, noisy-score gap {noisy_gap:.3g}"


def phase_mesh_speech(torch, card: str, audio, pyannote_folder: Path, tts_params, tts_dims) -> dict:
    """Phase 24 (e), diarization and TTS with dp = 2 against one device:
    the published speaker models (phase 16's folder, w32a32) on the 600 s
    audio, the RTTM equal and the L2-normalised embeddings within
    EMBED_LIMIT; Qwen3-TTS 0.6b bf16 (phase 19's weights), the paragraph's
    four chunks, MESH_TTS_FRAMES frames: at temperature 0 and at the CLI's
    0.9 with one seed, the mesh's codes (its frames on the graph) against
    the one-device run's (eager, spied) under the gap rules of
    tts_mesh_divergence (BF16_GAP_TOL: bf16 logits at two batch sizes;
    sampled, the two codes' scores under the one-device run's recorded
    noise; exact equality reported); then the mesh's frame graph against
    its eager frames, TTS_GRAPH_FRAMES frames at T 0 and 0.9, bit-equal."""
    import dataclasses

    import numpy as np

    from whisperkit_tpu_torch.decoding.tts_loop import HEAD_TOP_K
    from whisperkit_tpu_torch.pipelines import diarize
    from whisperkit_tpu_torch.pipelines import tts as tts_module
    from whisperkit_tpu_torch.pipelines.diarize import DiarizePipeline
    from whisperkit_tpu_torch.pipelines.tts import GenerationOptions, TTSPipeline
    from whisperkit_tpu_torch.tools.profile_tts import PARAGRAPH

    devices, _ = mesh_devices(torch)
    devs = devices[:2]
    runs = {}
    for key, dev in (("one", devices[0]), ("mesh", devs)):
        pipe = DiarizePipeline.from_pretrained(pyannote_folder, device=dev)
        pipe.diarize(audio[: 60 * 16_000])  # warm
        with Spy(diarize.VBxClusterer, "add") as added:
            embs = []
            added.before = lambda self, emb, ratio: embs.append(emb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = pipe.diarize(audio)
            torch.cuda.synchronize()
            runs[key] = (result, time.perf_counter() - t0, np.stack(embs) if embs else None)
        del pipe
    (one, wall_one, e_one), (mesh, wall_mesh, e_mesh) = runs["one"], runs["mesh"]
    emb_err = float(np.abs(e_one - e_mesh).max()) if e_one is not None and e_mesh is not None and \
        e_one.shape == e_mesh.shape else float("inf")
    rttm_equal = one.to_rttm("talk") == mesh.to_rttm("talk")
    say(f"phase 24 (e) diarization, dp 2 on {devs}: {AUDIO_SECONDS:.0f} s in {wall_mesh:.3f} s (one device "
        f"{wall_one:.3f} s) | RTTM equal {rttm_equal} ({len(one.to_rttm('talk').splitlines())} lines) | "
        f"embeddings max abs {emb_err:.3e} (limit {EMBED_LIMIT}) | {card}")
    if not rttm_equal or not emb_err <= EMBED_LIMIT:
        fail(f"phase 24 (e): diarization on the mesh: RTTM equal {rttm_equal}, embeddings {emb_err:.3e}")

    tts = {}
    base = GenerationOptions(max_new_tokens=MESH_TTS_FRAMES)
    one_pipe = TTSPipeline(tts_dims, params=tts_params, device=devices[0])
    mesh_pipe_ = TTSPipeline(tts_dims, params=tts_params, device=devs)
    mesh_pipe_.generate(PARAGRAPH, dataclasses.replace(base, temperature=0.0, max_new_tokens=4))  # warm
    made = []  # the SharedDraws of the one-device runs: their noise, frame by frame

    class RecordedDraws(tts_module.SharedDraws):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    for temperature in (0.0, 0.9):
        options = dataclasses.replace(base, temperature=temperature)
        shared_draws = tts_module.SharedDraws
        tts_module.SharedDraws = RecordedDraws
        try:
            t0 = time.perf_counter()
            ref, spy = tts_spied(torch, one_pipe, PARAGRAPH, options)
            t_one = time.perf_counter() - t0
        finally:
            tts_module.SharedDraws = shared_draws
        noise = made[-1]._draws
        # each mesh cell's loop (its frames on the graph), known by its
        # rows' trailing text (the cells run in threads: their calls start
        # and end in any order)
        with tts_calls("tts_generate_loop", eager=False) as loop_calls:
            t0 = time.perf_counter()
            ours = mesh_pipe_.generate(PARAGRAPH, options)
            for d in sorted(set(devs)):
                torch.cuda.synchronize(d)
            t_mesh = time.perf_counter() - t0
        ref_codes = spy.codes[0]
        ref_trailing = [tuple(row) for row in mesh_pipe_._trailing_array(
            [tr for _, _, tr, _ in (mesh_pipe_._chunk_tracks(c, options) for c in mesh_pipe_.chunker.chunk(
                PARAGRAPH, options.target_chunk_size, options.min_chunk_size))]).tolist()]
        by_row = {}
        for kwargs, out in loop_calls:
            for row, codes in zip(kwargs["trailing_text"].tolist(), out.codes):
                by_row.setdefault(tuple(row), codes.to(devices[0]))
        if len(ref_trailing) != ref_codes.shape[0] or any(t not in by_row for t in ref_trailing):
            fail(f"phase 24 (e) TTS: the mesh's rows do not cover the {ref_codes.shape[0]} chunks")
        ours_codes = torch.stack([by_row[t] for t in ref_trailing])
        rows = [tts_mesh_divergence(torch, f"phase 24 (e) TTS T={temperature} chunk {r}", ours_codes[r], ref_codes[r],
                                    spy.logits, spy.dtypes, r, (options.top_k, HEAD_TOP_K), temperature,
                                    torch.stack([d[r] for d in noise]) if noise else None)
                for r in range(ref_codes.shape[0])]
        equal = sum(r == "equal" for r in rows)
        say(f"phase 24 (e) TTS 0.6b bf16, dp 2, T={temperature}, {ours.timings.chunks} chunks x "
            f"{MESH_TTS_FRAMES} frames: {equal} of {len(rows)} chunks' codes equal, the others {rows} | generate "
            f"{ours.timings.generate_seconds:.3f} s (one device {ref.timings.generate_seconds:.3f} s), whole "
            f"{t_mesh:.3f} s (one device {t_one:.3f} s) | {card}")
        tts[str(temperature)] = {"equal_chunks": equal, "generate_s": ours.timings.generate_seconds,
                                 "one_device_generate_s": ref.timings.generate_seconds}

    # the frame's graph on the mesh (one capture per device thread) against
    # the mesh's eager frames, TTS_GRAPH_FRAMES frames
    for temperature in (0.0, 0.9):
        options = dataclasses.replace(base, temperature=temperature, max_new_tokens=TTS_GRAPH_FRAMES)

        def mesh_loops(eager):
            with tts_calls("tts_generate_loop", eager) as calls:
                mesh_pipe_.generate(PARAGRAPH, options)
            for d in sorted(set(devs)):
                torch.cuda.synchronize(d)
            return {tuple(kw["trailing_text"].flatten().tolist()): out for kw, out in calls}

        pair = tts_graph_pair(torch, mesh_loops)
        (eager, t_eager, s_eager), (graphed, t_graph, s_graph) = pair["eager"], pair["graph"]
        where = f"phase 24 (e) TTS graph, dp 2, T={temperature}"
        bad = {i: loop_mismatches(torch, eager[k], graphed[k]) for i, k in enumerate(graphed) if k in eager}
        if len(graphed) != 2 or set(graphed) != set(eager) or any(bad.values()):
            fail(f"{where}: {len(graphed)} cells; the graph's fields that differ from the eager mesh's, by cell: {bad}")
        check_graph_counts(where, s_eager, s_graph, 2,
                           sum(frames_stepped(o.length, TTS_GRAPH_FRAMES) for o in graphed.values()))
        say(f"{where}, {TTS_GRAPH_FRAMES} frames: each cell's codes, n_frames, length "
            f"{[o.length for o in graphed.values()]} and cache bit-equal to the eager mesh's | eager {t_eager:.3f} s, "
            f"graph {t_graph:.3f} s | graph by device {json.dumps(s_graph)} | {card}")
        tts[f"graph_{temperature}"] = {"eager_s": t_eager, "graph_s": t_graph, "graph": s_graph}
    return {"diarize_wall": wall_mesh, "diarize_one_device_wall": wall_one, "embedding_err": emb_err, "tts": tts}


# (kernel, source, TPU kernel it replaces, the path whose launch count it reports)
KERNEL_TABLE = (
    ("log_mel", "whisperkit_tpu_torch/csrc/mel.cu", "whisperkit_tpu/ops/mel.py:227", "int8"),
    ("mha_encoder", "whisperkit_tpu_torch/csrc/mha_encoder.cu", "whisperkit_tpu/ops/attention.py:85", "int8"),
    ("cross_attend_q8", "whisperkit_tpu_torch/csrc/attention_decode.cu",
     "whisperkit_tpu/ops/attention_decode.py:81", "int8"),
    ("cross_attend_q8_probs", "whisperkit_tpu_torch/csrc/attention_decode.cu",
     "whisperkit_tpu/ops/attention_decode.py:81", "words"),
    ("self_attend", "whisperkit_tpu_torch/csrc/attention_decode.cu",
     "whisperkit_tpu/ops/attention_decode.py:191", "bf16"),
    ("self_attend_q8", "whisperkit_tpu_torch/csrc/attention_decode.cu",
     "whisperkit_tpu/ops/attention_decode.py:216", "int8"),
    # no pl.pallas_call: the psums that XLA inserts from the tp shardings
    ("tp_all_reduce", "whisperkit_tpu_torch/csrc/tp_all_reduce.cu", "whisperkit_tpu/parallel/sharding.py:13", "mesh"),
    # no pl.pallas_call: XLA fuses W8A16's dequant into the matmul
    ("w8a16_matmul", "whisperkit_tpu_torch/csrc/w8a16_matmul.cu", "whisperkit_tpu/ops/quant.py quantized_matmul",
     "int8"),
)


def mesh_only(torch, name: str, card: str) -> None:
    """MESH_ARG: phases 1, 2 and 24 alone, for a machine with several
    cards: large-v3's bf16 tree (init_params(SEED)) and its W8A16
    quantization, the 600 s audio, the published speaker models and the
    0.6b TTS weights made here as the full run makes them."""
    from whisperkit_tpu_torch.core.configurations import ComputeOptions, WhisperConfig
    from whisperkit_tpu_torch.models.whisper import VARIANT_DIMS, init_params
    from whisperkit_tpu_torch.ops.quant import quantize_whisper_params
    from whisperkit_tpu_torch.pipelines.tts import TTS_VARIANTS, TTSPipeline
    from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
    from whisperkit_tpu_torch.tools.checkpoint import write_pyannote_checkpoint
    from whisperkit_tpu_torch.tools.workload import synth_speechlike_audio

    dims = VARIANT_DIMS["large-v3"]
    params = init_params(SEED, dims, torch.bfloat16, "cuda:0")
    pipe = WhisperPipeline(WhisperConfig(compute_options=ComputeOptions.serving(dp_size=1), load=False), dims=dims,
                           params=params, device="cuda:0")
    audio = synth_speechlike_audio(AUDIO_SECONDS)
    mesh = phase_mesh(torch, card, pipe, quantize_whisper_params(params), audio)
    with tempfile.TemporaryDirectory(prefix="whisperkit-smoke-") as tmp:
        write_pyannote_checkpoint(Path(tmp), SEED, full=True)
        tts = TTSPipeline(TTS_VARIANTS["0.6b"], seed=SEED, device="cuda:0")
        speech = phase_mesh_speech(torch, card, audio, Path(tmp), tts.params, TTS_VARIANTS["0.6b"])
    say(json.dumps({"phases": {"mesh": {k: v for k, v in mesh.items() if k != "counts"}, "mesh_speech": speech}}))
    say(f"card: {card}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


def main() -> None:
    if not (REPO / "whisperkit_tpu_torch").is_dir():
        fail("whisperkit_tpu_torch/ is not beside chip_smoke.py; run from a checkout of the repo")
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA device")
    # phases 1-15 hold the Whisper path's plain versions in IEEE float32;
    # phases 16-18 run under torch's default flags, as a user's process
    # does (the speaker models set their own precision)
    default_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == [TIMES_ARG]:
        say(json.dumps(traced_times(torch)))
        return
    if sys.argv[1:] == [W8A16_TIMES_ARG]:
        say(json.dumps(w8a16_times(torch)))
        return

    name, card = phase_card(torch)
    build_log = phase_build()
    if sys.argv[1:] == [MESH_ARG]:
        mesh_only(torch, name, card)
        return
    if sys.argv[1:] == [W8A16_ARG]:
        w8 = phase_w8a16(torch, card, build_log)
        say(json.dumps({"phases": {"w8a16": w8}}))
        say(f"card: {card}")
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
        }}))
        return
    kernel_results = phase_kernels(torch, card)
    kernel_results["w8a16_matmul"] = phase_w8a16(torch, card, build_log)
    bf16 = phase_main_path(torch, card)
    phase_step_parity(torch, "phase 5 decoder step, bf16 cache", bf16["pipe"], bf16["audio"], card)
    int8 = phase_int8_path(torch, card, bf16["pipe"], bf16["audio"])
    phase_step_parity(torch, "phase 7 decoder step, W8A16 + int8 self-KV cache", int8["pipe"], bf16["audio"],
                      card)
    phase_w4_w8a8(torch, card, bf16["pipe"], int8["pipe"], bf16["audio"])
    w8_params = int8.pop("pipe").params
    words = phase_word_timestamps(torch, card, bf16["pipe"], bf16["audio"])
    phases = {
        "word_timestamps": words,
        "beam": phase_beam(torch, card, bf16["pipe"], bf16["audio"]),
        "segmented": phase_segmented(torch, card, bf16["pipe"], bf16["audio"]),
        "speculative": phase_speculative(torch, card, bf16["pipe"], bf16["audio"]),
    }
    phases["decode_graph"] = phase_decode_graph(torch, card, bf16["pipe"], w8_params, bf16["audio"],
                                                phases["segmented"]["bias"])
    draft, draft_dims = phases["speculative"].pop("draft")
    phases["search_graphs"] = phase_search_graphs(torch, card, bf16["pipe"], draft, draft_dims, bf16["audio"],
                                                  phases["segmented"]["bias"])
    del draft
    # phase 24's Whisper part runs here, on phase 4's and phase 6's trees
    phases["mesh"] = phase_mesh(torch, card, bf16["pipe"], w8_params, bf16["audio"])
    del w8_params
    kernel_results["tp_all_reduce"] = phases["mesh"]["collective"]["kernel"]
    # phases 13-15 share one temporary folder: the checkpoint, the WAVs and
    # the CLI's reports; it is deleted when they end
    with tempfile.TemporaryDirectory(prefix="whisperkit-smoke-") as tmp:
        root = Path(tmp)
        for sub in ("model", "audio", "reports", "pyannote", "reports-diarization"):
            (root / sub).mkdir()
        phases["checkpoint"] = phase_checkpoint(torch, card, bf16["pipe"], root / "model")
        served = phases["checkpoint"].pop("pipe")
        phases["server"] = phase_server(torch, card, served, bf16["audio"], root / "audio")
        wav = phases["server"].pop("paths")[60]
        phases["cli"] = phase_cli(torch, card, bf16["pipe"], root / "model", wav, root / "reports")
        # phases 21-23 run here, on phase 4's tree and phase 13's pipeline
        phases["eval"] = phase_quant_divergence(torch, card, bf16["pipe"], bf16["audio"])
        phases["loadgen"] = phase_loadgen(torch, card, served, bf16["audio"])
        del served
        phases["operations"] = phase_operations(torch, card, bf16["pipe"], bf16["audio"], root / "model", root, wav,
                                                phases["checkpoint"]["load_s"])
        del bf16["pipe"]
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = default_tf32
        phases["diarize"] = phase_diarize_published(torch, card, bf16["audio"], root / "pyannote")
        phases["diarize_conv"] = phase_diarize_conv(torch, card, bf16["audio"], wav, root / "model",
                                                    root / "reports-diarization", phases["cli"])
        phases["streaming"] = phase_streaming(torch, card, bf16["audio"], root / "model", root / "audio",
                                              phases["cli"])
        for key in ("argv", "reference"):
            phases["cli"].pop(key)
        # phases 19-20: none of the Whisper kernels runs on the TTS path;
        # its W8A16 frames take the W8A16 product's
        from whisperkit_tpu_torch.ops import _build
        from whisperkit_tpu_torch.pipelines.tts import TTS_VARIANTS

        _build.reset_launches()
        phases["tts_check"] = phase_tts_card_vs_cpu(torch, card, TTS_VARIANTS["0.6b"])
        phases["tts"] = phase_tts(torch, card, TTS_VARIANTS["0.6b"])
        tts_pipe = phases["tts"].pop("pipe")
        phases["tts_graph"] = phase_tts_graph(torch, card, tts_pipe)
        phases["tts_entry"] = phase_tts_entry(torch, card, tts_pipe, root / "tts")
        tts_counts = dict(_build.launches)
        if any(n for k, n in tts_counts.items() if k != "w8a16_matmul") or not tts_counts["w8a16_matmul"]:
            fail(f"phases 19-20 launched Whisper kernels, or their W8A16 frames not the W8A16 product: {tts_counts}")
        # phase 24 (e): diarization on phase 16's folder, TTS on phase 19's tree
        phases["mesh_speech"] = phase_mesh_speech(torch, card, bf16["audio"], root / "pyannote", tts_pipe.params,
                                                  TTS_VARIANTS["0.6b"])
        del tts_pipe
    say(json.dumps({"phases": {k: {x: y for x, y in v.items() if x != "counts"} for k, v in phases.items()}}))

    counts = {"bf16": bf16["counts"], "int8": int8["counts"], "words": words["counts"],
              "server": phases["server"]["counts"], "diarize_conv": phases["diarize_conv"]["counts"],
              "streaming": phases["streaming"]["counts"], "tts": tts_counts, "eval": phases["eval"]["counts"],
              "loadgen": phases["loadgen"]["counts"], "profile": phases["operations"]["counts"],
              "mesh": phases["mesh"]["counts"], "beam": phases["beam"]["counts"],
              "speculative": phases["speculative"]["counts"]}
    kernels = [
        {
            "name": key, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[path][key], "path": path,
            "launches_by_path": {p: c.get(key, 0) for p, c in counts.items()},
            "mesh_launches_by_device": {d: c[key] for d, c in phases["mesh"]["counts_by_device"].items()},
            **kernel_results[key],
        }
        for key, source, replaces, path in KERNEL_TABLE
    ]
    say(f"total: chip_smoke.py took {time.perf_counter() - START:.1f} s")
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
