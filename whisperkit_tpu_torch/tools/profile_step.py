"""Profile the port's encode stage and decode step on one CUDA card.

    python -m whisperkit_tpu_torch.tools.profile_step

large-v3 at full width and depth (random weights from `init_params(SEED)`),
BATCH windows of random audio through the log-mel kernel.

Encode: one BATCH-window group through `encode_window` with the int8
cross-KV (the serving preset's encode stage), bf16 weights. One JSON line:

  wall_ms          host clock per call, three calls after a warm-up, the
                   device synced before and after each
  device_busy_ms   the union of the device activities' intervals in a
                   `torch.profiler` trace of one more call
  launches         device activities in that trace
  k2_ms, k2_share  the encoder attention kernel's device time, and its
                   share of device busy
  copies_ms        device time of copy kernels and memcpys
  top              the 12 kernel names with the most device time

Decode: `decode_loop` for STEPS decoder steps after a prompt of START
tokens, so the steps attend over positions START .. START + STEPS - 1 of
a START + STEPS + 1 = 224-key self-KV cache (the main path's length), for
bf16 weights with the bf16 self-KV cache (the `ComputeOptions.serving()`
decode) and the same weights quantized to W8A16 with the int8 self-KV cache (`serving(quantization="w8a16",
quantize_self_kv=True)`). Each runs twice: the eager loop
(`cuda_graph=False`, "loop": "eager") and the CUDA graph of the step
("loop": "graph"). For each it prints one JSON line:

  step_ms_unprofiled  wall per step of three loops after a warm-up one
                      (host clock, the device synced before and after);
                      for the graph, of the replays alone: the step
                      captured once, then STEPS replays a call from the
                      same position, the mask row reset to it each call
  decode_call_ms      graph only: wall per step of three whole
                      `decode_loop` calls, each running its first step
                      eagerly and capturing the step anew (the pipeline's
                      cost per group)
  capture_s, instantiate_s  graph only: host seconds of the capture of
                      the step and of the graph's instantiation
                      (`decoding/graph.stats_by_device`), per capture
  device_busy_ms      per step: the union of the device activities'
                      intervals (kernels, copies, sets) in a
                      `torch.profiler` trace of one more loop
  launches_per_step   device activities per step in that trace
  host_launches_per_step  the host's calls that put work on the device
                      (kernel and graph launches, async copies and sets)
                      per step in that trace
  port_kernels        the port's kernel launches per step (`_build.launches`,
                      counted through the replays for the graph)
  kernel_ms_per_launch  device ms per launch of K3, K4 and K5 in that trace
  k5_by_position      int8 only: K5's device µs per launch at each mask
                      position the steps open (the trace's launches in
                      order, one per layer a step), beside the bound at
                      that position (bytes over 3.35 TB/s: the visible
                      keys' int8 codes and f32 scales of K and V, the
                      query, the mask row, the output) and their ratio;
                      `k5_share` is the mean bound over the mean time
  top                 the 12 kernel names with the most device time:
                      [name (first 70 characters), count in the trace,
                      ms per step]

Beam search and speculative decoding, bf16 serving: a beam step of
phase 10's 4 windows × BEAM = 20 rows over the raw bf16 cross-KV (the
pipeline's beam encode), STEPS steps at positions START .. START + STEPS
- 1 of a 224-key cache, and ROUNDS speculative rounds at batch 1 with a
random distil-large-v3 draft (`init_params(SEED + 1)`) over the int8
cross-KV, draft_k 4, from position START. Each runs eagerly ("loop":
"eager", the step or round function called in a host loop) and as
replays of its CUDA graphs ("loop": "graph": one per parity for beam,
one for the round), each call from the same position. One JSON line
each, per step or round:

  wall_ms             three calls after a warm-up one, host clock, the
                      device synced before and after
  device_busy_ms, idle_share  the union of the device intervals in a
                      trace of one more call, and 1 - busy / the mean wall
  launches_per_step, host_launches_per_step, port_kernels, top  as above
  capture_s, instantiate_s  graph only, per capture
  reorder_ms          beam only: device ms of the step's self-KV gather
                      by beam (K and V, [32, 20, 20, 224, 64] bf16 each),
                      alone, by CUDA events, beside its bound (read and
                      write of both caches over 3.35 TB/s)

Every wall is taken before the first trace: once a `torch.profiler`
session has run, each later launch of the process costs the host more
(`tools/launch_cost.py`). The card's name and power limit (`nvidia-smi`)
come first. To compare another commit's kernels on the same card, copy
this file into a `git archive` of that commit and run both trees in one
call, in turns.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import torch

# positions 191 .. 222 of a 224-key cache: the main path's self-KV length
# (a 3-token prompt and 221 new tokens) near its end
BATCH, STEPS, START, SEED = 32, 32, 191, 0
# the decode step's attention kernels, by the name of their device activity
STEP_KERNELS = {"self_attend": "self_attend_kernel", "self_attend_q8": "self_attend_q8_kernel",
                "cross_attend_q8": "cross_attend_q8_kernel"}
# beam search: windows and beams (phase 10's 60 s group); speculative
# decoding: rounds a call, draft tokens a round
BEAM_WINDOWS, BEAM, ROUNDS, DRAFT_K = 4, 5, 16, 4
# the card's memory rate, for K5's bound (the H100's published 3.35 TB/s)
PEAK_BYTES_PER_S = 3.35e12
# the host's runtime calls that put work on the device, by their name in a trace
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _trace(fn) -> tuple[list, int]:
    """Device activities of one call of `fn` under torch.profiler, and the
    count of the host's LAUNCH_CALLS."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    host = sum(1 for e in events if e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS)
    return device, host


def _top(device: list, per: float) -> list:
    by_name: dict[str, list] = {}
    for e in device:
        entry = by_name.setdefault(e.name[:70], [0, 0.0])
        entry[0] += 1
        entry[1] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return [[name, n, us / 1e3 / per] for name, (n, us) in top]


def _span_ms(device: list, pick) -> float:
    return sum(e.time_range.end - e.time_range.start for e in device if pick(e.name)) / 1e3


def _per_launch_ms(device: list) -> dict:
    """Mean device ms per launch of each of STEP_KERNELS found in the trace."""
    out = {}
    for key, name in STEP_KERNELS.items():
        n = sum(1 for e in device if name in e.name)
        if n:
            out[key] = _span_ms(device, lambda s: name in s) / n
    return out


def _k5_by_position(device: list, steps: int, first_pos: int, cache_len: int, rows: int) -> dict:
    """K5's device µs per launch at each position of the traced steps and
    its bound there: the trace's K5 launches in time order, `rows` =
    batch × heads (batch, head) rows a launch, step j opening the mask to
    first_pos + j over a cache of `cache_len` keys."""
    launches = sorted((e for e in device if STEP_KERNELS["self_attend_q8"] in e.name),
                      key=lambda e: e.time_range.start)
    per_step = len(launches) // steps
    table, spent, least = [], 0.0, 0.0
    for j in range(steps):
        pos = first_pos + j
        us = sum(e.time_range.end - e.time_range.start for e in launches[j * per_step:(j + 1) * per_step]) / per_step
        n = pos + 1  # visible keys
        bound_us = (2 * rows * n * (64 + 4) + rows * (64 + 4 + 64 * 4) + cache_len * 4) / PEAK_BYTES_PER_S * 1e6
        table.append([pos, us, bound_us, bound_us / us])
        spent, least = spent + us, least + bound_us
    return {"k5_by_position": table, "k5_share": least / spent, "k5_launches_per_step": per_step}


def _walls(fn, per: float = 1.0) -> list:
    """Host-clock ms (over `per`) of three calls of `fn` after a warm-up
    one, the device synced before and after each."""
    fn()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / per)
    return walls


def _long_prompt(pipe, options, start: int, rows: int):
    """The prompt of `start` tokens (SOT sequence, then text) for `rows`
    rows, and its sot index."""
    base, sot_index = pipe._build_prompt(options, "en")
    prompt = base + list(range(1000, 1000 + start - len(base)))
    return torch.tensor([prompt] * rows, dtype=torch.long, device=pipe.device), sot_index


def decode_runner(pipe, mel, steps: int, start: int, cuda_graph: bool):
    """A call that runs `decode_loop` for `steps` steps after a prompt of
    `start` tokens (prefilled once here), and one that replays a graph of
    the step `steps` times from the same position (None when not
    `cuda_graph`)."""
    from whisperkit_tpu_torch.core.configurations import DecodingOptions
    from whisperkit_tpu_torch.decoding import loop as decode

    sp = pipe.tokenizer.special
    options = DecodingOptions(language="en", first_token_log_prob_threshold=None)
    _, ck, cv = pipe._encode(mel, options)
    prompt_arr, sot_index = _long_prompt(pipe, options, start, mel.shape[0])
    kwargs = dict(
        dims=pipe.dims, special=sp, sample_begin=start, max_new_tokens=steps + 1,
        sot_index=sot_index,
    )
    pre = decode.prefill_window(pipe.params, ck, cv, prompt_arr, **kwargs,
                                quantize_self_kv=pipe.config.compute_options.quantize_self_kv)
    rest = dict(top_k=options.top_k, use_timestamp_rules=not options.without_timestamps,
                suppress_blank=options.suppress_blank, cuda_graph=cuda_graph)
    args = (pipe.params, ck, cv, prompt_arr, pipe._suppress_bias(options), pipe._decode_scalars(options, 0.0, 0))

    def loop():
        # steps + 1 sampled tokens, `steps` decoder steps
        return decode.decode_loop(*args, **kwargs, **rest, prefill=pre)

    if not cuda_graph:
        return loop, None
    # one more position, so that each of the `steps` replays runs the decoder
    st, _ = decode._start(*args, pre, **{**kwargs, "max_new_tokens": steps + 2}, **rest, alignment_heads=None,
                          quantize_self_kv=False)
    decode._advance(st, start + 1, 16)  # the first step, eagerly, then its capture

    def replays():
        # back to the position after the eager step, the mask row closed
        # again past it (each replay opens its position)
        st.pos_dev.fill_(start + 1)
        st.pos = start + 1
        st.mask_row[:, start + 1 :] = float("-inf")
        decode._advance(st, start + 1 + steps, 16)

    return loop, replays


def beam_runners(pipe, mel):
    """(eager, replays, reorder) calls of STEPS beam steps of BEAM beams
    over `mel`'s windows from position START (each call resets the
    position, the mask row and `done`); `reorder` runs the step's two
    gathers of the self-KV cache alone."""
    from whisperkit_tpu_torch.core.configurations import DecodingOptions
    from whisperkit_tpu_torch.decoding import beam
    from whisperkit_tpu_torch.decoding.graph import StepGraph
    from whisperkit_tpu_torch.decoding.loop import encode_window

    options = DecodingOptions(language="en", beam_size=BEAM, first_token_log_prob_threshold=None)
    _, ck, cv = encode_window(pipe.params, mel, pipe.dims)  # raw: the pipeline's beam encode
    prompt, sot_index = _long_prompt(pipe, options, START, mel.shape[0])
    scalars = pipe._decode_scalars(options, 0.0, 0)

    def state(cuda_graph):
        st, _ = beam._start(
            pipe.params, ck, cv, prompt, pipe._suppress_bias(options), scalars.max_initial_timestamp_index,
            dims=pipe.dims, special=pipe.tokenizer.special, sample_begin=START, max_new_tokens=STEPS + 1,
            beam_size=BEAM, sot_index=sot_index, use_timestamp_rules=True, suppress_blank=options.suppress_blank,
            length_penalty=None, cuda_graph=cuda_graph,
        )
        return st

    def reset(st):
        st.pos_dev.fill_(START)
        st.mask_row[:, START:] = float("-inf")
        st.done.zero_()

    eager_st, graph_st = state(False), state(True)

    def eager():
        reset(eager_st)
        for i in range(STEPS):
            beam._step(eager_st, True, i % 2)

    graphs = [StepGraph(lambda p=p: beam._step(graph_st, True, p), pipe.device) for p in (0, 1)]

    def replays():
        reset(graph_st)
        for i in range(STEPS):
            graphs[i % 2].replay()

    rows = torch.arange(mel.shape[0] * BEAM, device=pipe.device).flip(0)

    def reorder():
        for src, dst in ((eager_st.kv_k[0], eager_st.kv_k[1]), (eager_st.kv_v[0], eager_st.kv_v[1])):
            torch.index_select(src, 1, rows, out=dst)

    return eager, replays, reorder


def spec_runners(pipe, draft, draft_dims, mel):
    """(eager, replays) calls of ROUNDS speculative rounds over `mel`'s one
    window from position START (each call resets the position and
    `done`)."""
    from whisperkit_tpu_torch.core.configurations import DecodingOptions
    from whisperkit_tpu_torch.decoding import speculative
    from whisperkit_tpu_torch.decoding.graph import StepGraph
    from whisperkit_tpu_torch.decoding.loop import encode_window, prefill_window

    options = DecodingOptions(language="en", first_token_log_prob_threshold=None)
    _, ck, cv = pipe._encode(mel, options)  # int8 under the serving preset
    _, dck, dcv = encode_window(draft, mel, draft_dims)
    prompt, sot_index = _long_prompt(pipe, options, START, 1)
    sp = pipe.tokenizer.special
    max_new = 224 - START
    width = START + max_new + DRAFT_K + 1
    headroom = dict(special=sp, sample_begin=START, max_new_tokens=max_new + DRAFT_K + 1, sot_index=sot_index)

    def state():
        pre = prefill_window(pipe.params, ck, cv, prompt, dims=pipe.dims, **headroom)
        dpre = prefill_window(draft, dck, dcv, prompt, dims=draft_dims, **headroom)
        tokens = torch.full((1, width), sp.eot, dtype=torch.long, device=pipe.device)
        tokens[:, :START] = prompt
        return speculative._Spec(
            pipe.params, draft, ck, cv, dck, dcv, pipe._suppress_bias(options), pipe._decode_scalars(options, 0.0, 0),
            pipe.dims, draft_dims, sp, START, START + max_new, DRAFT_K, True, options.suppress_blank, pre.kv_k,
            pre.kv_v, dpre.kv_k, dpre.kv_v, tokens, torch.zeros((1, width), device=pipe.device),
            torch.tensor(START, device=pipe.device), prompt[:, -1].clone(),
            torch.zeros((1,), dtype=torch.bool, device=pipe.device), torch.zeros((), dtype=torch.long, device=pipe.device),
        )

    def reset(st):
        st.pos.fill_(START)
        st.done.zero_()

    eager_st, graph_st = state(), state()

    def eager():
        reset(eager_st)
        for _ in range(ROUNDS):
            speculative._round(eager_st)

    g = StepGraph(lambda: speculative._round(graph_st), pipe.device)

    def replays():
        reset(graph_st)
        for _ in range(ROUNDS):
            g.replay()

    return eager, replays


def profile_reorder(reorder, cache_bytes: int) -> dict:
    """The beam step's self-KV gather alone: device ms a step by CUDA
    events over 20 calls after a warm-up one (each call's two gathers take
    far longer on the card than their launches on the host), and its
    bound (each of the two caches read and written once)."""
    reorder()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        reorder()
    end.record()
    end.synchronize()
    return {"reorder_ms": start.elapsed_time(end) / 20, "reorder_bound_ms": 4 * cache_bytes / PEAK_BYTES_PER_S * 1e3}


def profile_decode(loop, steps: int, k5: dict | None = None) -> dict:
    """The decode line's traced figures, from one more call of `loop`;
    with `k5` (the keywords of `_k5_by_position` but the trace's), K5's
    figures per position too."""
    from whisperkit_tpu_torch.ops import _build

    _build.reset_launches()
    device, host = _trace(loop)
    counts = {k: v / steps for k, v in _build.launches.items() if v}
    return {
        **(_k5_by_position(device, steps, **k5) if k5 else {}),
        "device_busy_ms": _busy_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3 / steps,
        "launches_per_step": len(device) / steps,
        "host_launches_per_step": host / steps,
        "port_kernels": counts,
        "kernel_ms_per_launch": _per_launch_ms(device),
        "top": _top(device, steps),
    }


def profile_encode(call) -> dict:
    """The encode line's traced figures, from one more call of `call`."""
    device, _ = _trace(call)
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3
    k2 = _span_ms(device, lambda n: "mha_encoder" in n)
    return {
        "device_busy_ms": busy, "launches": len(device),
        "k2_ms": k2, "k2_share": k2 / busy,
        "copies_ms": _span_ms(device, lambda n: "copy" in n.lower() or "memcpy" in n.lower()),
        "top": _top(device, 1),
    }


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_step needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    from whisperkit_tpu_torch.core.configurations import ComputeOptions, WhisperConfig
    from whisperkit_tpu_torch.decoding import graph
    from whisperkit_tpu_torch.decoding.loop import encode_window
    from whisperkit_tpu_torch.models.whisper import VARIANT_DIMS, init_params
    from whisperkit_tpu_torch.ops.quant import quantize_whisper_params
    from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)

    dims = VARIANT_DIMS["large-v3"]
    params = init_params(SEED, dims, torch.bfloat16, "cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    configs = {
        "bf16": (ComputeOptions.serving(), params),
        "int8": (ComputeOptions.serving(quantization="w8a16", quantize_self_kv=True),
                 quantize_whisper_params(params)),
    }
    # (the line's first fields, the call, steps per call, its traced figures)
    jobs = []
    with torch.inference_mode():
        for label, (compute, tree) in configs.items():
            pipe = WhisperPipeline(WhisperConfig(compute_options=compute, load=False),
                                   dims=dims, params=tree, device="cuda")
            audio = [(torch.randn(480_000, generator=g, device="cuda") * 0.1).cpu().numpy()
                     for _ in range(BATCH)]
            mel = pipe._mel_batch(audio)
            if label == "bf16":
                jobs.append(({"encode": "bf16", "batch": BATCH},
                             functools.partial(encode_window, tree, mel, dims, quantize_kv=True), 1, profile_encode))
            head = {"config": label, "batch": BATCH, "positions": [START, START + STEPS - 1]}
            # K5's positions: the eager loop's steps open the mask to START ..
            # START + STEPS - 1 of the prefill's START + STEPS + 1 key cache;
            # the replays, one position later, to START + 1 .. START + STEPS
            rows = BATCH * dims.n_text_head
            k5 = label == "int8"
            loop, _ = decode_runner(pipe, mel, STEPS, START, cuda_graph=False)
            jobs.append(({**head, "loop": "eager"}, loop, STEPS, functools.partial(
                profile_decode, steps=STEPS,
                k5=dict(first_pos=START, cache_len=START + STEPS + 1, rows=rows) if k5 else None)))
            graph.reset_stats()
            loop, replays = decode_runner(pipe, mel, STEPS, START, cuda_graph=True)
            (stats,) = graph.stats_by_device.values()
            head = {**head, "loop": "graph", "capture_s": stats["capture_s"],
                    "instantiate_s": stats["instantiate_s"]}
            jobs.append((head, replays, STEPS, functools.partial(
                profile_decode, steps=STEPS,
                k5=dict(first_pos=START + 1, cache_len=START + STEPS + 1, rows=rows) if k5 else None)))
            jobs.append((None, loop, STEPS, None))  # the whole call's wall, beside the replays'
        # beam search and speculative decoding on the bf16 tree
        pipe = WhisperPipeline(WhisperConfig(compute_options=ComputeOptions.serving(), load=False),
                               dims=dims, params=params, device="cuda")
        draft_dims = VARIANT_DIMS["distil-large-v3"]
        draft = init_params(SEED + 1, draft_dims, torch.bfloat16, "cuda")
        cache_bytes = dims.n_text_layer * BEAM_WINDOWS * BEAM * dims.n_text_head * (START + STEPS + 1) * 64 * 2
        for search in ("beam", "speculative"):
            graph.reset_stats()
            if search == "beam":
                eager, replays, reorder = beam_runners(pipe, pipe._mel_batch(audio[:BEAM_WINDOWS]))
                head, per = {"search": "beam", "rows": BEAM_WINDOWS * BEAM, "positions": [START, START + STEPS - 1]}, STEPS
            else:
                eager, replays = spec_runners(pipe, draft, draft_dims, pipe._mel_batch(audio[:1]))
                head, per = {"search": "speculative", "rows": 1, "draft_k": DRAFT_K, "from": START}, ROUNDS
            (stats,) = graph.stats_by_device.values()
            per_capture = {k: stats[k] / stats["captures"] for k in ("capture_s", "instantiate_s")}
            profile = functools.partial(profile_decode, steps=per)
            jobs.append(({**head, "loop": "eager"}, eager, per, profile))
            if search == "beam":
                profile = (lambda fn, p=profile, r=reorder: {**p(fn), **profile_reorder(r, cache_bytes)})
            jobs.append(({**head, "loop": "graph", "captures": stats["captures"], **per_capture}, replays, per,
                         profile))
        # every wall before the first trace: once a profiler session has run,
        # each later launch of the process costs the host more
        walls = [_walls(fn, per) for _, fn, per, _ in jobs]
        for i, ((head, fn, per, profile), wall) in enumerate(zip(jobs, walls)):
            if head is None:
                continue
            if "search" in head:
                traced = profile(fn)
                idle = 1 - traced["device_busy_ms"] / (sum(wall) / len(wall))
                print(json.dumps({**head, "wall_ms": wall, "idle_share": idle, **traced}), flush=True)
                continue
            key = "wall_ms" if "encode" in head else "step_ms_unprofiled"
            extra = {"decode_call_ms": walls[i + 1]} if head.get("loop") == "graph" else {}
            print(json.dumps({**head, key: wall, **extra, **profile(fn)}), flush=True)


if __name__ == "__main__":
    main()
