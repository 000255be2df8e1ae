"""Profile the port's Qwen3-TTS frame loop and vocoder on one CUDA card.

    python -m whisperkit_tpu_torch.tools.profile_tts

TTS_VARIANTS["0.6b"] at full width and depth, random bf16 weights from the
port's init (SEED), PARAGRAPH's sentence chunks as one batch (B = 4,
`TTSPipeline.generate`'s default chunking), temperature 0.9, top-k 50,
penalty 1.05, the backbone's cache as long as generate's (the prompt,
VOCODE_FRAMES frames and one). For bf16 weights and the same weights
quantized to W8A16 and to W4A16, the frame loop runs in two forms, each
printed as one JSON line: "loop": "eager" (`cuda_graph=False`: every op
launched from the host) and "loop": "graph" (the frame captured as a CUDA
graph, then replayed):

  frame_ms_unprofiled  wall per frame of FRAMES frames of
                       `tts_generate_segment` after the prompt's prefill,
                       two runs after a warm one (host clock, the device
                       synced before and after); for the graph, of
                       replays alone: each run's state has its first
                       frame run and captured before the clock starts
  segment_call_ms      graph only: wall per frame of whole segments of
                       FRAMES frames on a new state, the first frame run
                       eagerly and captured in each (what a generate pays
                       per graph), two runs after a warm one
  capture_s, instantiate_s  graph only: host seconds of a capture of the
                       frame and of the graph's instantiation
                       (`decoding/graph.stats_by_device`), per capture
  device_busy_ms       per frame: the union of the device activities'
                       intervals in a `torch.profiler` trace of
                       TRACE_FRAMES more frames (eager: EAGER_TRACE_FRAMES)
  launches_per_frame   device activities per frame in that trace
  host_launches_per_frame  the host's calls that put work on the device
                       (kernel and graph launches, async copies and sets:
                       `profile_step.LAUNCH_CALLS`) per frame in that trace
  idle_share           1 - device_busy_ms / mean(frame_ms_unprofiled)
  top                  the 12 kernel names with the most device time per
                       frame: [name, count in the trace, ms per frame]

The eager line also carries, for both forms:

  parts                one backbone step (`code_decoder_forward`, T = 1 at
                       a device slot), one `multicode_forward` (the code
                       predictor and its 15 heads) and the vocoder
                       (`speech_decoder_forward` on VOCODE_FRAMES frames of
                       every row), each traced alone: launches and device
                       busy ms
  vocoder_wall_ms      the vocoder's wall (one call after a warm one)

Every wall is taken before the first trace: once a `torch.profiler`
session has run, each later launch of the process costs the host more
(`tools/launch_cost.py`). The card's name and power limit (`nvidia-smi`)
come first.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from whisperkit_tpu_torch.tools.profile_step import _busy_us, _top, _trace

SEED = 0
FRAMES = 8  # frames per timed run
# frames per trace: the graph's, and the eager form's (host events of its
# ~6,000-14,000 launches a frame are slow to collect)
TRACE_FRAMES = 2
EAGER_TRACE_FRAMES = 1
VOCODE_FRAMES = 245  # GenerationOptions' max_new_tokens
# four sentences of 110-190 characters: four chunks at the default target of 200
PARAGRAPH = (
    "The old lighthouse keeper climbed the spiral stairs every evening at dusk, carrying a lantern and "
    "a small notebook in which he recorded the weather. "
    "Ships passing through the narrow strait relied on his light, and more than one captain had written "
    "to thank him for guiding them safely home through the storms of winter. "
    "When the automated beacon was finally installed, he stayed on anyway, tending the garden and "
    "watching the horizon out of habit. "
    "Visitors who came to the island in summer would often find him sitting on the rocks, telling "
    "stories about the sea to anyone who would listen."
)


def frame_inputs(pipe, options):
    """What `generate` hands the frame loop for PARAGRAPH: (prompt embeds,
    pads, trailing text, step caps), one row per chunk."""
    chunks = pipe.chunker.chunk(PARAGRAPH, options.target_chunk_size, options.min_chunk_size)
    tracks = [pipe._chunk_tracks(c, options) for c in chunks]
    embeds, pad = pipe._embed_tracks([(t, c) for t, c, _, _ in tracks])
    trailing = pipe._trailing_array([tr for _, _, tr, _ in tracks])
    caps = torch.tensor([cap for _, _, _, cap in tracks], device=pipe.device)
    return embeds, pad, trailing, caps


def _device_trace(fn) -> list:
    """Device activities of one call of `fn` under torch.profiler, which
    records the device's activity only (the parts: their host launches
    are their device launches, and host events of thousands of launches
    take long to collect)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    return device


def _busy(device) -> float:
    return _busy_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3


def _walls(fn, per: int) -> list:
    """Host-clock ms per frame of three calls of `fn` (each returning a
    call to time, its set-up done) but the first, the device synced
    before and after each."""
    walls = []
    for _ in range(3):
        timed = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / per)
    return walls[1:]


def profile(pipe, options) -> tuple[list, list, list]:
    """(the eager and graph lines' walls, the traced jobs: (line index or
    None, name, call, frames), the states holding a graph) of one
    configuration."""
    from whisperkit_tpu_torch.decoding import graph
    from whisperkit_tpu_torch.decoding.tts_loop import tts_generate_segment, tts_prefill_state, tts_release
    from whisperkit_tpu_torch.models.qwen3_tts import (
        code_decoder_forward,
        multicode_forward,
        speech_decoder_forward,
    )

    embeds, pad, trailing, caps = frame_inputs(pipe, options)
    b = embeds.shape[0]
    max_seq = embeds.shape[1] + VOCODE_FRAMES + 1  # generate's

    def state():
        g = torch.Generator(device=pipe.device).manual_seed(SEED)
        return tts_prefill_state(pipe.params, embeds, trailing, caps, g, dims=pipe.dims, max_seq=max_seq,
                                 prompt_pad=pad)

    scalars = pipe._scalars(options)

    def frames(st, n, cuda_graph):
        tts_generate_segment(pipe.params, st, scalars, dims=pipe.dims, n_frames=n, top_k=options.top_k,
                             cuda_graph=cuda_graph)

    def eager():
        st = state()
        return lambda: frames(st, FRAMES, False)

    graphs = []  # the states holding a graph

    def captured(n=FRAMES):
        """A state whose first frame ran and was captured; → n replays."""
        st = state()
        frames(st, 1, True)
        graphs.append(st)
        return lambda: frames(st, n, True)

    def whole():
        st = state()
        graphs.append(st)
        return lambda: frames(st, FRAMES, True)

    eager_line = {"loop": "eager", "batch": b, "frame_ms_unprofiled": _walls(eager, FRAMES)}
    graph.reset_stats()
    graph_line = {"loop": "graph", "batch": b, "frame_ms_unprofiled": _walls(captured, FRAMES),
                  "segment_call_ms": _walls(whole, FRAMES)}
    (stats,) = graph.stats_by_device.values()
    graph_line["capture_s"] = stats["capture_s"] / stats["captures"]
    graph_line["instantiate_s"] = stats["instantiate_s"] / stats["captures"]
    for st in graphs:
        tts_release(st)
    graphs.clear()
    codes = torch.randint(0, 2048, (b, VOCODE_FRAMES, 16), device=pipe.device,
                          generator=torch.Generator(device=pipe.device).manual_seed(SEED))
    speech_decoder_forward(pipe.params, codes, pipe.dims)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    speech_decoder_forward(pipe.params, codes, pipe.dims)
    torch.cuda.synchronize()
    eager_line["vocoder_wall_ms"] = (time.perf_counter() - t0) * 1e3

    traced_eager = state()
    st = state()
    kv_k, kv_v = st.kv
    hidden = st.hidden[:, -1]
    code0 = torch.zeros(b, dtype=torch.long, device=pipe.device)
    step_in = st.hidden.clone()
    slot = torch.tensor(st.bos_slot + 1, device=pipe.device)
    jobs = [
        (0, "frames", lambda: frames(traced_eager, EAGER_TRACE_FRAMES, False), EAGER_TRACE_FRAMES),
        (1, "frames", captured(TRACE_FRAMES), TRACE_FRAMES),
        (None, "backbone step", lambda: code_decoder_forward(
            pipe.params, step_in, slot, kv_k, kv_v, pipe.dims, rope_offset=slot - st.prompt_pad,
            key_invalid=st.key_invalid), 1),
        (None, "multicode", lambda: multicode_forward(pipe.params, hidden, code0, options.temperature, 5,
                                                      dims=pipe.dims, noise=torch.zeros(b, 15, 5, device=pipe.device)),
         1),
        (None, "vocoder", lambda: speech_decoder_forward(pipe.params, codes, pipe.dims), 1),
    ]
    return [eager_line, graph_line], jobs, graphs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_tts needs a CUDA device")
    from whisperkit_tpu_torch.decoding.tts_loop import tts_release
    from whisperkit_tpu_torch.pipelines.tts import TTS_VARIANTS, GenerationOptions, TTSPipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)

    dims = TTS_VARIANTS["0.6b"]
    options = GenerationOptions()
    with torch.inference_mode():
        bf16 = TTSPipeline(dims, seed=SEED, device="cuda")
        configs = {"bf16": bf16, "w8a16": TTSPipeline(dims, params=bf16.params, quantize="w8a16", device="cuda"),
                   "w4a16": TTSPipeline(dims, params=bf16.params, quantize="w4a16", device="cuda")}
        # every wall before the first trace
        runs = {label: profile(pipe, options) for label, pipe in configs.items()}
        for label, (lines, jobs, graphs) in runs.items():
            parts = {}
            for index, name, fn, per in jobs:
                if index is None:
                    device = _device_trace(fn)
                    parts[name] = {"device_busy_ms": _busy(device) / per, "launches": len(device) / per}
                    continue
                device, host = _trace(fn)
                figures = {"device_busy_ms": _busy(device) / per, "launches": len(device) / per}
                wall = sum(lines[index]["frame_ms_unprofiled"]) / len(lines[index]["frame_ms_unprofiled"])
                lines[index].update(
                    device_busy_ms=figures["device_busy_ms"], launches_per_frame=figures["launches"],
                    host_launches_per_frame=host / per, idle_share=1 - figures["device_busy_ms"] / wall,
                    top=_top(device, per))
            for st in graphs:
                tts_release(st)
            lines[0]["parts"] = parts
            for line in lines:
                print(json.dumps({"config": label, **line}), flush=True)


if __name__ == "__main__":
    main()
