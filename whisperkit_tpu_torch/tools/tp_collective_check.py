"""Check and time the tp group's device all-reduce (csrc/tp_all_reduce.cu)
on the card.

    python -m whisperkit_tpu_torch.tools.tp_collective_check

Every visible card when there are at least `tp` of them, else `tp`
replicas of cuda:0 (each rank a thread with a stream of its own, as a
mesh runs them). `chip_smoke.py` phase 24 runs the same checks; as a
script this prints one JSON line per check and fails (exit 1) on the
first that does not hold:

  bit_equal   at tp 2 and 4: each CASES entry's tensors (rank r's drawn
              with scale 4^r, so that the order of the bf16 adds matters)
              through `TPRank.all_reduce_sum` / `_max` on every rank,
              each rank's result bit for bit the rank-ordered fold
              `plain_all_reduce`; also the elements where the reversed
              order would round otherwise (the check's power to fail)
  eager       tp 2: EAGER_CALLS back-to-back calls at the decoder's shape
              from each rank, every call's result held as above; host µs
              per call
  graph       tp 2: a CUDA graph per rank (decoding/graph.StepGraph) of
              GRAPH_CALLS calls at the decoder's shape (a large-v3 step's
              96 all-reduces), replayed GRAPH_REPLAYS times; three
              replays on fresh inputs held as above, then the device µs
              per call (CUDA events on each rank's stream, the slower
              rank) beside the bound
  abort       tp 2: a rank that never arrives makes its peer raise
              GroupAborted within the group's timeout (TIMEOUT_S, the
              device's wait bound); a rank that raises aborts its peer's
              device wait long before the timeout; a collective after
              each `reset()` is bit-equal again
  host_form   tp 2: the host barrier form that the kernel replaced
              (`TPGroup._combine`, three barrier waits a call) timed over
              the same calls: host µs per call
"""

from __future__ import annotations

import json
import sys
import time

import torch

from whisperkit_tpu_torch.decoding.graph import StepGraph
from whisperkit_tpu_torch.ops import _build
from whisperkit_tpu_torch.parallel.group import STAGING_BYTES, GroupAborted, plain_all_reduce
from whisperkit_tpu_torch.parallel.mesh import make_mesh

# (name, shape, dtype, op): the decoder's row-split outputs (bf16 and, in
# float32 runs, f32), gather_alignment's one position of ten heads, W8A8's
# float64 integer accumulators and its row absmax, and the encoder's
# output at B = 32, 123 MB of bf16: eight chunks of the staging slot
CASES = (
    ("decoder bf16", (32, 1, 1280), torch.bfloat16, "sum"),
    ("decoder f32", (32, 1, 1280), torch.float32, "sum"),
    ("alignment f32", (1, 32, 10, 1500), torch.float32, "sum"),
    ("w8a8 acc f64", (32, 1, 1280), torch.float64, "sum"),
    ("w8a8 absmax f32", (32, 1, 1), torch.float32, "max"),
    ("encoder bf16 (chunked)", (32, 1500, 1280), torch.bfloat16, "sum"),
)
DECODER = (32, 1, 1280)
EAGER_CALLS = 1000
GRAPH_CALLS = 96
GRAPH_REPLAYS = 100
TIMEOUT_S = 2.0
# the other checks' groups: a wait that long is a fault, not a slow peer
CHECK_TIMEOUT_S = 60.0
PEAK_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9  # each way, one card to the others


def devices_for(tp: int) -> tuple[list[str], str]:
    """The ranks' devices: every visible card from `tp` on, else replicas."""
    n = torch.cuda.device_count()
    if n >= tp:
        return [f"cuda:{i}" for i in range(tp)], f"{tp} cards"
    return ["cuda:0"] * tp, f"{tp} replicas of cuda:0"


def bound_ms(tp: int, nbytes: int, replicas: bool) -> dict:
    """The least time of one call: on replicas of one card, the ranks'
    inputs read once and their outputs written once through the card's
    memory (2 tp n bytes); on cards, a rank's tp inputs read and its
    output written (tp + 1) n bytes, or its peers' (tp - 1) n bytes over
    NVLink, whichever is longer."""
    if replicas:
        return {"bound_ms": 2 * tp * nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    local = (tp + 1) * nbytes / PEAK_BYTES_PER_S
    link = (tp - 1) * nbytes / NVLINK_BYTES_PER_S
    return {"bound_ms": max(local, link) * 1e3, "bound_by": "bytes"}


def _inputs(shape, dtype, tp: int, devices, seed: int) -> list[torch.Tensor]:
    g = torch.Generator(device="cuda:0").manual_seed(seed)
    xs = [torch.randn(shape, generator=g, device="cuda:0", dtype=torch.float32) * 4.0**r for r in range(tp)]
    return [x.to(dtype).to(devices[r]) for r, x in enumerate(xs)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]).cpu()


def _equal_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b.to(a.device)))


def _sync_all(devices) -> None:
    for d in dict.fromkeys(devices):
        torch.cuda.synchronize(d)


def check_bit_equal(tp: int) -> dict:
    devices, layout = devices_for(tp)
    plan = make_mesh(dp=1, tp=tp, devices=devices, timeout=CHECK_TIMEOUT_S)
    out = {"tp": tp, "layout": layout, "cases": {}}
    for i, (name, shape, dtype, op) in enumerate(CASES):
        xs = _inputs(shape, dtype, tp, devices, 100 + i)
        with torch.inference_mode():
            ys = plan.run(lambda g, r: getattr(plan.rank(g, r), f"all_reduce_{op}")(xs[r]))[0]
        _sync_all(devices)
        ref = plain_all_reduce(xs, op)
        rev = plain_all_reduce(xs[::-1], op)
        order_matters = int((_bits(ref) != _bits(rev)).sum())
        equal = all(_equal_bits(y, ref) for y in ys)
        out["cases"][name] = {"bit_equal": equal, "elements": ref.numel(),
                              "chunks": -(-ref.numel() * ref.element_size() // STAGING_BYTES),
                              "reversed_order_differs": order_matters}
        if not equal:
            raise AssertionError(f"tp {tp} {name}: a rank's all-reduce differs from the rank-ordered fold")
        del xs, ys, ref, rev
    return out


def check_eager(tp: int = 2) -> dict:
    devices, layout = devices_for(tp)
    plan = make_mesh(dp=1, tp=tp, devices=devices, timeout=CHECK_TIMEOUT_S)
    stacks = [x.reshape(EAGER_CALLS, *DECODER) for x in _inputs((EAGER_CALLS * DECODER[0], *DECODER[1:]),
                                                                torch.bfloat16, tp, devices, 7)]

    def rank(g, r):
        h = plan.rank(g, r)
        torch.cuda.current_stream().synchronize()
        t0 = time.perf_counter()
        ys = [h.all_reduce_sum(stacks[r][i]) for i in range(EAGER_CALLS)]
        torch.cuda.current_stream().synchronize()
        return torch.stack(ys), time.perf_counter() - t0

    with torch.inference_mode():
        res = plan.run(rank)[0]
    ref = plain_all_reduce(stacks, "sum")
    equal = all(_equal_bits(ys, ref) for ys, _ in res)
    if not equal:
        raise AssertionError("eager calls: a rank's result differs from the rank-ordered fold")
    return {"tp": tp, "layout": layout, "calls": EAGER_CALLS, "bit_equal": equal,
            "host_us_per_call": max(t for _, t in res) / EAGER_CALLS * 1e6}


def check_graph(tp: int = 2) -> dict:
    devices, layout = devices_for(tp)
    plan = make_mesh(dp=1, tp=tp, devices=devices, timeout=CHECK_TIMEOUT_S)
    cells = plan.cells()[0]
    static_in = [[torch.empty(DECODER, dtype=torch.bfloat16, device=cells[r]) for _ in range(GRAPH_CALLS)]
                 for r in range(tp)]
    static_out: list[list] = [[None] * GRAPH_CALLS for _ in range(tp)]
    fills = _inputs((4, GRAPH_CALLS, *DECODER), torch.bfloat16, tp, devices, 11)  # per rank: 4 sets of inputs

    def load(r: int, k: int) -> None:
        for i in range(GRAPH_CALLS):
            static_in[r][i].copy_(fills[r][k, i])

    def rank(g, r):
        h = plan.rank(g, r)

        def step():
            for i in range(GRAPH_CALLS):
                static_out[r][i] = h.all_reduce_sum(static_in[r][i])

        load(r, 0)
        graph = StepGraph(step, cells[r])  # the warm-up on fill 0, then the capture
        h.captured()
        launches = len(graph.record)
        results = []
        for k in (1, 2, 3):
            load(r, k)
            graph.replay()
            results.append(torch.stack(static_out[r]).clone())
        stream = torch.cuda.current_stream()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        stream.synchronize()
        start.record(stream)
        for _ in range(GRAPH_REPLAYS):
            graph.replay()
        end.record(stream)
        end.synchronize()
        ms = start.elapsed_time(end)
        graph.close()
        return results, ms, launches

    with torch.inference_mode():
        res = plan.run(rank)[0]
    for k in (1, 2, 3):
        ref = plain_all_reduce([f[k] for f in fills], "sum")
        if not all(_equal_bits(r[0][k - 1], ref) for r in res):
            raise AssertionError(f"graph replay {k}: a rank's result differs from the rank-ordered fold")
    per_call_ms = max(ms for _, ms, _ in res) / (GRAPH_REPLAYS * GRAPH_CALLS)
    nbytes = DECODER[0] * DECODER[1] * DECODER[2] * 2
    return {"tp": tp, "layout": layout, "calls_per_graph": GRAPH_CALLS, "replays": GRAPH_REPLAYS,
            "captured_launches": res[0][2], "bit_equal": True, "ms": per_call_ms,
            **bound_ms(tp, nbytes, layout.endswith("cuda:0"))}


def check_abort(tp: int = 2) -> dict:
    devices, layout = devices_for(tp)
    plan = make_mesh(dp=1, tp=tp, devices=devices, timeout=TIMEOUT_S)
    group = plan.groups[0]
    xs = _inputs(DECODER, torch.bfloat16, tp, devices, 3)

    def again() -> bool:
        with torch.inference_mode():
            ys = plan.run(lambda g, r: plan.rank(g, r).all_reduce_sum(xs[r]))[0]
        _sync_all(devices)
        return all(_equal_bits(y, plain_all_reduce(xs, "sum")) for y in ys)

    if not again():
        raise AssertionError("the collective before the abort checks differs from the fold")

    def waits_alone(g, r):
        if r:
            return None  # never arrives
        y = plan.rank(g, r).all_reduce_sum(xs[r])
        torch.cuda.current_stream().synchronize()
        plan.rank(g, r).check()
        return y

    t0 = time.perf_counter()
    try:
        with torch.inference_mode():
            plan.run(waits_alone)
        raise AssertionError("a rank whose peer never arrived did not raise")
    except GroupAborted as e:
        timed_out_s, timeout_msg = time.perf_counter() - t0, str(e)
    if not timed_out_s < TIMEOUT_S + 10.0:
        raise AssertionError(f"the timeout took {timed_out_s:.1f} s (bound {TIMEOUT_S} s)")
    after_timeout = again()

    def peer_fails(g, r):
        if r:
            time.sleep(0.5)
            raise ValueError("a rank fails before its collective")
        y = plan.rank(g, r).all_reduce_sum(xs[r])
        torch.cuda.current_stream().synchronize()
        plan.rank(g, r).check()
        return y

    group.timeout = 600.0  # only the abort can end this wait early
    t0 = time.perf_counter()
    try:
        with torch.inference_mode():
            plan.run(peer_fails)
        raise AssertionError("a rank whose peer failed did not raise")
    except ValueError:
        aborted_s = time.perf_counter() - t0
    if not aborted_s < 30.0:
        raise AssertionError(f"the abort ended the wait after {aborted_s:.1f} s")
    after_abort = again()
    if not (after_timeout and after_abort):
        raise AssertionError(f"a collective after reset(): bit-equal {after_timeout}, {after_abort}")
    return {"tp": tp, "layout": layout, "timeout_s": TIMEOUT_S, "raised_after_s": timed_out_s,
            "message": timeout_msg, "abort_ended_wait_after_s": aborted_s,
            "bit_equal_after_reset": [after_timeout, after_abort]}


def time_host_form(tp: int = 2, calls: int = 200) -> dict:
    """The host barrier form on the decoder's shape: µs per call."""
    devices, layout = devices_for(tp)
    plan = make_mesh(dp=1, tp=tp, devices=devices, timeout=CHECK_TIMEOUT_S)
    xs = _inputs(DECODER, torch.bfloat16, tp, devices, 5)

    def rank(g, r):
        group = plan.groups[g]
        t0 = time.perf_counter()
        for _ in range(calls):
            group._combine(r, xs[r], "sum")
        torch.cuda.current_stream().synchronize()
        return time.perf_counter() - t0

    with torch.inference_mode():
        secs = plan.run(rank)[0]
    waits = plan.groups[0].host_waits
    return {"tp": tp, "layout": layout, "calls": calls, "host_us_per_call": max(secs) / calls * 1e6,
            "host_waits_per_call": waits / (calls * tp)}


def time_plain(tp: int = 2, iters: int = 200) -> float:
    """The plain version's ms per call at the decoder's shape (the fold on
    the first rank's device, CUDA events)."""
    devices, _ = devices_for(tp)
    xs = _inputs(DECODER, torch.bfloat16, tp, devices, 9)
    plain_all_reduce(xs, "sum")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        plain_all_reduce(xs, "sum")
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run_all() -> dict:
    """Every check, in order; raises on the first that does not hold."""
    _build.library()
    out = {"bit_equal": [check_bit_equal(2), check_bit_equal(4)], "eager": check_eager(2),
           "graph": check_graph(2), "abort": check_abort(2), "host_form": time_host_form(2),
           "plain_ms": time_plain(2)}
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        sys.exit(1)
    res = _build.build()
    ours = res.log.split("tp_all_reduce.cu:", 1)[-1].split(".cu:", 1)[0]
    print(json.dumps({"build_s": res.seconds, "ptxas": [
        line.strip() for line in ours.splitlines() if "Used" in line or "spill" in line]}), flush=True)
    try:
        out = run_all()
    except AssertionError as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
    for key, value in out.items():
        print(json.dumps({key: value}), flush=True)


if __name__ == "__main__":
    main()
