"""Profile the port's Qwen3-TTS frame loop and vocoder on one CUDA card.

    python -m whisperkit_tpu_torch.tools.profile_tts

TTS_VARIANTS["0.6b"] at full width and depth, random bf16 weights from the
port's init (SEED), PARAGRAPH's sentence chunks as one batch (B = 4,
`TTSPipeline.generate`'s default chunking), temperature 0.9, top-k 50,
penalty 1.05. For bf16 weights and the same weights quantized to W8A16
and to W4A16 it prints one JSON line:

  frame_ms_unprofiled  wall per frame of FRAMES frames of
                       `tts_generate_segment` after the prompt's prefill,
                       two runs after a warm one (host clock, the device
                       synced before and after)
  device_busy_ms       per frame: the union of the device activities'
                       intervals in a `torch.profiler` trace (device
                       activity only) of TRACE_FRAMES more frames
  launches_per_frame   device activities per frame in that trace
  idle_share           1 - device_busy_ms / frame_ms_unprofiled
  parts                one backbone step (`code_decoder_forward`, T = 1),
                       one `multicode_forward` (the code predictor and its
                       15 heads) and the vocoder (`speech_decoder_forward`
                       on VOCODE_FRAMES frames of every row), each traced
                       alone: launches and device busy ms
  vocoder_wall_ms      the vocoder's wall (one call after a warm one)
  top                  the 12 kernel names with the most device time per
                       frame: [name, count in the trace, ms per frame]

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

from whisperkit_tpu_torch.tools.profile_step import _busy_us, _top

SEED = 0
FRAMES = 8  # frames per timed run
TRACE_FRAMES = 2  # frames per trace: ~9,000 device activities each (bf16)
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


def _trace(fn) -> list:
    """Device activities of one call of `fn` under torch.profiler, which
    records the device's activity only (host events of tens of thousands
    of launches take minutes to collect)."""
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


def profile(pipe, options) -> tuple[dict, list]:
    """(the walls, the traced jobs) of one configuration."""
    from whisperkit_tpu_torch.decoding.tts_loop import tts_generate_segment, tts_prefill_state
    from whisperkit_tpu_torch.models.qwen3_tts import (
        code_decoder_forward,
        multicode_forward,
        speech_decoder_forward,
    )

    embeds, pad, trailing, caps = frame_inputs(pipe, options)
    b = embeds.shape[0]
    max_seq = embeds.shape[1] + FRAMES + 1

    def state():
        g = torch.Generator(device=pipe.device).manual_seed(SEED)
        return tts_prefill_state(pipe.params, embeds, trailing, caps, g, dims=pipe.dims, max_seq=max_seq,
                                 prompt_pad=pad)

    scalars = pipe._scalars(options)

    def frames(st, n=FRAMES):
        tts_generate_segment(pipe.params, st, scalars, dims=pipe.dims, n_frames=n, top_k=options.top_k)

    walls = []
    for _ in range(3):
        st = state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames(st)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / FRAMES)
    codes = torch.randint(0, 2048, (b, VOCODE_FRAMES, 16), device=pipe.device,
                          generator=torch.Generator(device=pipe.device).manual_seed(SEED))
    speech_decoder_forward(pipe.params, codes, pipe.dims)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    speech_decoder_forward(pipe.params, codes, pipe.dims)
    torch.cuda.synchronize()
    vocode_ms = (time.perf_counter() - t0) * 1e3

    traced = state()
    torch.cuda.synchronize()
    st = state()
    kv_k, kv_v = st.kv
    hidden = st.hidden[:, -1]
    code0 = torch.zeros(b, dtype=torch.long, device=pipe.device)
    step_in = st.hidden.clone()
    slot = st.bos_slot + 1
    jobs = [
        ("frames", lambda: frames(traced, TRACE_FRAMES), TRACE_FRAMES),
        ("backbone step", lambda: code_decoder_forward(
            pipe.params, step_in, slot, kv_k, kv_v, pipe.dims, rope_offset=slot - st.prompt_pad,
            key_invalid=st.key_invalid), 1),
        ("multicode", lambda: multicode_forward(pipe.params, hidden, code0, options.temperature, 5, dims=pipe.dims,
                                                noise=torch.zeros(b, 15, 5, device=pipe.device)), 1),
        ("vocoder", lambda: speech_decoder_forward(pipe.params, codes, pipe.dims), 1),
    ]
    return {"batch": b, "frame_ms_unprofiled": walls[1:], "vocoder_wall_ms": vocode_ms}, jobs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_tts needs a CUDA device")
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
        for label, (line, jobs) in runs.items():
            traced = {}
            for name, fn, per in jobs:
                device = _trace(fn)
                traced[name] = {"device_busy_ms": _busy(device) / per, "launches": len(device) / per}
                if name == "frames":
                    traced[name]["top"] = _top(device, per)
            frame = traced.pop("frames")
            wall = sum(line["frame_ms_unprofiled"]) / len(line["frame_ms_unprofiled"])
            print(json.dumps({
                "config": label, **line, "device_busy_ms": frame["device_busy_ms"],
                "launches_per_frame": frame["launches"], "idle_share": 1 - frame["device_busy_ms"] / wall,
                "parts": traced, "top": frame["top"],
            }), flush=True)


if __name__ == "__main__":
    main()
