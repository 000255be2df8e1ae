"""The Qwen3 decode glue kernels (ops/qwen3_decode.py,
csrc/qwen3_decode.cu) against their plain versions, at the TTS frame's
shapes, and their device times.

`chip_smoke.py --qwen3-decode` and tests/test_torch_qwen3_decode_card.py
run these on the card; on the CPU every wrapper runs its plain version, so
the same calls compare the plain version with itself (a rehearsal of the
shapes and the control flow).

Limits, each kernel output against the plain version on the same inputs:

  add_rms_norm      the sum s bit-equal (one rounding of an exact sum); h
                    within 1 bf16 ulp (the norm's sum of squares in
                    another order)
  swiglu            within 1 bf16 ulp
  decode_attention  the output within 1 bf16 ulp; the values written into
                    the cache bit-equal, every slot it does not write
                    untouched, the keys written within 1 bf16 ulp and
                    bit-equal but where the norm's float32 result lies
                    within 1e-5 (relative) of a bf16 rounding boundary;
                    two replays of a captured graph bit-equal to the
                    eager launch
  a frame           the talker step's code0 logits and the code
                    predictor's 15 head logits (teacher-forced codes)
                    through the kernels no farther from the same path in
                    float32 activations than FRAME_RATIO times the plain
                    bf16 path's distance from it (the W8A16 path's own
                    spread: two bf16 paths that round at the same points
                    in other summation orders each lie about that far
                    from float32, and ~sqrt(2) times it from each other)

Shapes: the talker's step (4 rows, 16 query / 8 KV heads of 128, a cache
of TALKER_S slots, the slot a 0-d tensor, a cached prefix and left pads
hidden by the mask) at three slots, and the code predictor's passes (T = 2
at slot 0, T = 1 at slots 2, 9 and 16 of its 17).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from whisperkit_tpu_torch.models.qwen3_tts import _rope_angles
from whisperkit_tpu_torch.ops import qwen3_decode

SEED = 0
ROWS = 4
D_MODEL = 1024
D_FF = 3072
N_HEAD, N_KV_HEAD, HEAD_DIM = 16, 8, 128
TALKER_S = 450  # generate's cache for a paragraph: ~200 prompt slots, 245 frames and one
TALKER_CACHED = 40  # the prompt cache's prefix
TALKER_PADS = (0, 3, 9, 20)  # left pads of the four rows
TALKER_SLOTS = (61, 205, TALKER_S - 1)
CP_S = 17
CP_PASSES = ((2, 0), (1, 2), (1, 9), (1, 16))  # (T, slot)
EPS = 1e-6
# the relative distance from a bf16 rounding boundary within which a key
# written into the cache may round the other way than the plain version's
TIE_REL = 1e-5
# how much farther from float32 a frame's logits through the kernels may
# lie than the plain path's: the largest of thousands of differences, each
# a sum of many roundings, varies by some 10-20% between two such paths
FRAME_RATIO = 1.5


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per element, how many bf16 steps lie between a and b (bf16 tensors
    of one shape; +0 and -0 are one value)."""
    def order(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(bits >= 0x8000, -(bits & 0x7FFF), bits)
    return (order(a) - order(b)).abs()


def _normal(g: torch.Generator, shape, dev, scale: float = 1.0, shift: float = 0.0) -> torch.Tensor:
    return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(torch.bfloat16)


def check_add_rms_norm(dev, rows: int, d: int, with_y: bool, seed: int = SEED) -> dict:
    g = torch.Generator(device=dev).manual_seed(seed)
    x = _normal(g, (rows, 1, d), dev, 2.0)
    y = _normal(g, (rows, 1, d), dev, 2.0) if with_y else None
    w = _normal(g, (d,), dev, 0.1, 1.0)
    s, h = qwen3_decode.add_rms_norm(x, y, w, EPS)
    s_ref, h_ref = qwen3_decode.add_rms_norm_reference(x, y, w, EPS)
    ulps = bf16_ulps(h, h_ref)
    return {"sum_equal": bool(torch.equal(s, s_ref)), "max_ulps": int(ulps.max()), "differ": int((ulps > 0).sum()),
            "elements": h.numel()}


def check_swiglu(dev, rows: int, n: int, seed: int = SEED) -> dict:
    g = torch.Generator(device=dev).manual_seed(seed)
    gate, up = _normal(g, (rows, 1, n), dev, 3.0), _normal(g, (rows, 1, n), dev, 3.0)
    ulps = bf16_ulps(qwen3_decode.swiglu(gate, up), qwen3_decode.swiglu_reference(gate, up))
    return {"max_ulps": int(ulps.max()), "differ": int((ulps > 0).sum()), "elements": ulps.numel()}


def attention_case(dev, kind: str, slot: int, t: int = 1, seed: int = SEED) -> dict:
    """The inputs of one layer's attention as the TTS forwards build them:
    kind "talker" (a tensor slot, the whole cache under the causal mask
    and the left pads' key_invalid, rope 1e6) or "cp" (an int slot, keys
    [0, slot + t), rope 1e4). The cache holds random keys and values in
    every slot, as no real cache does past its slot: a kernel that read
    them unmasked would show."""
    g = torch.Generator(device=dev).manual_seed(seed + 7919 * slot + t)
    b, h, kvh, dh = ROWS, N_HEAD, N_KV_HEAD, HEAD_DIM
    s = TALKER_S if kind == "talker" else CP_S
    q = _normal(g, (b, t, h * dh), dev, 1.5)
    k = _normal(g, (b, t, kvh * dh), dev, 1.5)
    v = _normal(g, (b, t, kvh * dh), dev)
    qnorm, knorm = _normal(g, (dh,), dev, 0.3, 1.0), _normal(g, (dh,), dev, 0.3, 1.0)
    cache_k = _normal(g, (b, kvh, s, dh), dev, 2.0)  # normed, rotated keys of scale ~ the norm's weight
    cache_v = _normal(g, (b, kvh, s, dh), dev)
    steps = torch.arange(t, device=dev)[None, :]
    if kind == "talker":
        pad = torch.tensor(TALKER_PADS, device=dev)
        pos_offset = torch.tensor(slot, dtype=torch.int64, device=dev)
        positions = torch.clamp_min(pos_offset - pad[:, None] + steps, 0)
        key_pos = torch.arange(s, device=dev)[None, :]
        query_pos = pos_offset + torch.arange(t, device=dev)[:, None]
        mask = torch.where(key_pos <= query_pos, 0.0, -math.inf)[None, None]
        key_invalid = (key_pos >= TALKER_CACHED) & (key_pos < TALKER_CACHED + pad[:, None])
        inv = key_invalid[:, None, None, :] & (key_pos != query_pos)[None, None]
        mask = mask + torch.where(inv, -math.inf, 0.0)
        cos, sin = _rope_angles(positions, 1_000_000.0, HEAD_DIM)
    else:
        pos_offset = slot
        positions = (slot + steps).expand(b, t)
        key_pos = torch.arange(slot + t, device=dev)[None, :]
        query_pos = slot + torch.arange(t, device=dev)[:, None]
        mask = torch.where(key_pos <= query_pos, 0.0, -math.inf)[None, None]
        cos, sin = _rope_angles(positions, 10_000.0, HEAD_DIM)
    return {"q": q, "k": k, "v": v, "qnorm": qnorm, "knorm": knorm, "cos": cos, "sin": sin, "cache_k": cache_k,
            "cache_v": cache_v, "pos_offset": pos_offset, "mask": mask, "slot": slot, "t": t, "kind": kind}


def run_attention(case: dict, fn: Callable, caches: Optional[tuple] = None) -> tuple:
    """(out, cache_k, cache_v) of `fn` (the wrapper or the plain version)
    on copies of the case's caches, or on `caches`."""
    ck, cv = caches if caches is not None else (case["cache_k"].clone(), case["cache_v"].clone())
    out = fn(case["q"], case["k"], case["v"], case["qnorm"], case["knorm"], case["cos"], case["sin"], ck, cv,
             case["pos_offset"], case["mask"], n_head=N_HEAD, n_kv_head=N_KV_HEAD, eps=EPS)
    return out, ck, cv


def _key_ties(case: dict) -> torch.Tensor:
    """[B, KVH, T, Dh] bool: where a written key may round the other way
    under another float32 summation order: its normed value (float64), or
    that of its rotary partner 64 features away, lies within TIE_REL of a
    bf16 rounding boundary."""
    b, t = case["k"].shape[:2]
    k = case["k"].double().reshape(b, t, N_KV_HEAD, HEAD_DIM)
    normed = k * torch.rsqrt(k.square().mean(-1, keepdim=True) + EPS) * case["knorm"].double()
    near = normed.to(torch.bfloat16).double()
    ulp = torch.ldexp(torch.ones_like(near), torch.frexp(near.abs()).exponent - 8)  # bf16's step at `near`
    tie = (ulp / 2 - (normed - near).abs()) <= TIE_REL * normed.abs()
    return (tie | tie.roll(HEAD_DIM // 2, dims=-1)).transpose(1, 2)


def check_attention(case: dict) -> dict:
    out, ck, cv = run_attention(case, qwen3_decode.decode_attention)
    ref, rk, rv = run_attention(case, qwen3_decode.decode_attention_reference)
    ulps = bf16_ulps(out, ref)
    slot, t = case["slot"], case["t"]
    written = torch.zeros(ck.shape[2], dtype=torch.bool, device=ck.device)
    written[slot:slot + t] = True
    k_ulps = bf16_ulps(ck[:, :, written], rk[:, :, written])
    ties = _key_ties(case)
    return {
        "max_ulps": int(ulps.max()), "differ": int((ulps > 0).sum()), "elements": ulps.numel(),
        "values_equal": bool(torch.equal(cv, rv)),
        "untouched_equal": bool(torch.equal(ck[:, :, ~written], rk[:, :, ~written])),
        "key_max_ulps": int(k_ulps.max()), "keys_differ": int((k_ulps > 0).sum()),
        "keys_differ_off_ties": int(((k_ulps > 0) & ~ties).sum()),
    }


def attention_graph_equal(case: dict) -> bool:
    """Two replays of a captured graph of the wrapper bit-equal to its
    eager launch (outputs and caches)."""
    eager = run_attention(case, qwen3_decode.decode_attention)
    caches = (case["cache_k"].clone(), case["cache_v"].clone())
    box = {}

    def call():
        box["got"] = run_attention(case, qwen3_decode.decode_attention, caches)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    same = True
    for _ in range(2):
        caches[0].copy_(case["cache_k"])
        caches[1].copy_(case["cache_v"])
        graph.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(a, b) for a, b in zip(box["got"], eager))
    return same


def frame_logits(pipe, plain: bool, float32: bool = False) -> dict:
    """The talker's step (T = 1 at its first frame's slot, after the
    paragraph's prefill) and the code predictor's prefill and 14 steps over
    teacher-forced codes: {"code0": [B, V] logits, "heads": [15, B, 2048]
    logits}, through the kernels, or the plain path (`plain`), or the plain
    path in float32 activations and caches (`float32`)."""
    from unittest import mock

    from whisperkit_tpu_torch.decoding.tts_loop import tts_prefill_state
    from whisperkit_tpu_torch.models import qwen3_tts as tm
    from whisperkit_tpu_torch.pipelines.tts import GenerationOptions
    from whisperkit_tpu_torch.tools.profile_tts import frame_inputs

    params, dims, dev = pipe.params, pipe.dims, pipe.device
    embeds, pad, trailing, caps = frame_inputs(pipe, GenerationOptions())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.inference_mode():
        st = tts_prefill_state(params, embeds, trailing, caps, gen, dims=dims,
                               max_seq=embeds.shape[1] + 245 + 1, prompt_pad=pad)
        dtype = torch.float32 if float32 else torch.bfloat16
        kv_k, kv_v = (c.to(dtype) for c in st.kv)
        x = st.hidden.to(dtype)
        slot = torch.tensor(st.bos_slot + 1, device=dev)
        b = x.shape[0]
        codes = torch.randint(0, tm.HEAD_VOCAB, (b, 16), generator=gen, device=dev)
        with mock.patch.object(tm.qwen3_decode, "qwen3_decode_takes",
                               (lambda *a, **k: False) if plain else qwen3_decode.qwen3_decode_takes):
            logits, hidden = tm.code_decoder_forward(params, x, slot, kv_k, kv_v, dims,
                                                     rope_offset=slot - st.prompt_pad, key_invalid=st.key_invalid)
            mc = params["mc"]
            cp_shape = (dims.cp_layer, b, dims.cp_kv_head, CP_S, dims.cp_head_dim)
            ck, cv = torch.zeros(cp_shape, dtype=dtype, device=dev), torch.zeros(cp_shape, dtype=dtype, device=dev)
            c0e = params["code_embed"][codes[:, 0]].to(dtype)
            last = tm.code_predictor_forward(mc, torch.stack([hidden[:, -1], c0e], dim=1), 0, ck, cv, dims)[:, -1]
            heads = []
            for i in range(15):
                head = {k: v[i] for k, v in mc["heads"].items()} if isinstance(mc["heads"], dict) else mc["heads"][i]
                heads.append(tm._mm_f32(last, head))
                if i < 14:
                    emb = mc["embeds"][i][codes[:, 1 + i]].to(dtype)
                    last = tm.code_predictor_forward(mc, emb[:, None], 2 + i, ck, cv, dims)[:, -1]
    return {"code0": logits[:, -1].float(), "heads": torch.stack(heads).float()}


def check_frame(pipe) -> dict:
    """A frame's logits through the kernels and through the plain path,
    each against the plain path in float32 activations: `kernel_err` and
    `plain_err`, the largest |difference| (and `between`, the two bf16
    paths' own distance)."""
    kern, plain, f32 = frame_logits(pipe, False), frame_logits(pipe, True), frame_logits(pipe, True, True)
    out = {}
    for key in ("code0", "heads"):
        out[key] = {"kernel_err": float((kern[key] - f32[key]).abs().max()),
                    "plain_err": float((plain[key] - f32[key]).abs().max()),
                    "between": float((kern[key] - plain[key]).abs().max()),
                    "scale": float(f32[key].abs().max())}
    return out


def attention_bytes(case: dict) -> int:
    """The least traffic of one launch: q, k, v, the norms, the rotary rows,
    the mask rows, the visible old keys and values read, the new ones
    written, the output."""
    b, t = case["q"].shape[:2]
    n_vis = int((case["mask"] > -math.inf).any(dim=2).any(dim=0).nonzero().max()) + 1
    vec = 2 * HEAD_DIM
    return (b * t * (N_HEAD + 2 * N_KV_HEAD) * vec + 2 * vec + 2 * b * t * HEAD_DIM * 4
            + case["mask"].shape[0] * t * case["mask"].shape[-1] * 4
            + 2 * b * N_KV_HEAD * (n_vis - t) * vec + 2 * b * N_KV_HEAD * t * vec + b * t * N_HEAD * vec)


def cases(dev) -> list:
    """Every attention case of the check: the talker at TALKER_SLOTS, the
    code predictor at CP_PASSES."""
    return ([attention_case(dev, "talker", s) for s in TALKER_SLOTS]
            + [attention_case(dev, "cp", s, t) for t, s in CP_PASSES])


def check_all(dev) -> dict:
    """Every kernel check at the frame's shapes (0.6b; the 1.7b talker's
    2048 features for the norm) → {name: figures}."""
    out = {}
    for rows in (ROWS, 2 * ROWS):
        for d in (D_MODEL, 2 * D_MODEL):
            for with_y in (False, True):
                out[f"add_rms_norm/{rows}x{d}/{'add' if with_y else 'norm'}"] = check_add_rms_norm(dev, rows, d,
                                                                                                   with_y)
        out[f"swiglu/{rows}x{D_FF}"] = check_swiglu(dev, rows, D_FF)
    for case in cases(dev):
        out[f"attention/{case['kind']}/T{case['t']}/slot{case['slot']}"] = check_attention(case)
    return out


def failures(results: dict) -> list:
    """The limits that `check_all`'s results break, as messages."""
    bad = []
    for name, r in results.items():
        if r.get("sum_equal") is False:
            bad.append(f"{name}: the residual sum differs from x + y")
        if r["max_ulps"] > 1:
            bad.append(f"{name}: {r['max_ulps']} bf16 ulps from the plain version ({r['differ']} elements differ)")
        if name.startswith("attention/"):
            if not (r["values_equal"] and r["untouched_equal"]):
                bad.append(f"{name}: the values written or the slots not written differ from the plain version's")
            if r["key_max_ulps"] > 1 or r["keys_differ_off_ties"]:
                bad.append(f"{name}: the keys written differ by {r['key_max_ulps']} ulps, "
                           f"{r['keys_differ_off_ties']} elements away from a rounding tie")
    return bad


def frame_failures(frame: dict) -> list:
    return [f"frame {key}: logits {v['kernel_err']:.4f} from float32's, past {FRAME_RATIO} x the plain path's "
            f"{v['plain_err']:.4f}" for key, v in frame.items() if not v["kernel_err"] <= FRAME_RATIO * v["plain_err"]]


if __name__ == "__main__":
    results = check_all(torch.device("cuda" if torch.cuda.is_available() else "cpu"))
    for name, figures in results.items():
        print(name, figures)
    print("limits broken:", failures(results) or "none")
