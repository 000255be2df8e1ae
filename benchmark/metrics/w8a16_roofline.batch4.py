"""The W8A16 product's kernel (`csrc/w8a16_matmul.cu`, every launch whose
name holds `w8a16_matmul`) against its bound, in %, over the TTS frame
loop: over the traced paragraph's frame-loop calls, the sum of each call's
bound, over the sum of the kernel's device time there. None where the
kernel never launched or the port counts no frames.

A call's bound is its prefill's (the talker's seven products of each layer
and the code0 head at rows x prompt positions) plus its frames stepped
times a frame's: the talker's seven products of each layer and the code0
head at the call's rows, and the code predictor's seven products of each
layer in each of its 15 passes, the first (the frame's hidden state and
code0's embedding) at twice the rows. The 15 heads are not counted: they
dequantize and multiply in float32 (`models/qwen3_tts._mm_f32`), not in the
kernel. A product's bound is the larger of its bytes over the memory rate
and its operations over the bf16 peak; its bytes: the K x N int8 codes, the
N bf16 scales, x (rows x K bf16) read and y (rows x N bf16) written."""

from benchmark.roofline import PEAK

KERNEL = "w8a16_matmul"
PASSES = 15


def product_bound_s(rows: int, k: int, n: int) -> float:
    nbytes = k * n + 2 * n + 2 * rows * k + 2 * rows * n
    return max(nbytes / PEAK["hbm_byte_s"], 2.0 * rows * k * n / PEAK["bf16_flop_s"])


def stack_bound_s(d: int, s, rows: int) -> float:
    """One pass of `rows` rows through a stack's layers: q, k, v, out, gate, up, down."""
    q, kv = s.heads * s.head_dim, s.kv_heads * s.head_dim
    layer = (product_bound_s(rows, d, q) + 2 * product_bound_s(rows, d, kv) + product_bound_s(rows, q, d)
             + 2 * product_bound_s(rows, d, s.ffn) + product_bound_s(rows, s.ffn, d))
    return s.layers * layer


def talker_bound_s(dims, rows: int) -> float:
    return stack_bound_s(dims.d_model, dims.talker, rows) + product_bound_s(rows, dims.d_model, dims.codec_vocab)


def frame_bound_s(dims, rows: int) -> float:
    predictor = (stack_bound_s(dims.d_model, dims.predictor, 2 * rows)
                 + (PASSES - 1) * stack_bound_s(dims.d_model, dims.predictor, rows))
    return talker_bound_s(dims, rows) + predictor


def read(run):
    sl = run.window.trace
    bound = spent = 0.0
    for call in run.slice_calls("frames") if sl is not None else ():
        if not call.steps:
            return None
        spent += sum(e - s for name, s, e, _ in sl.launched_in([(call.t0, call.t1)]) if KERNEL in name) / 1e6
        bound += talker_bound_s(run.dims, call.rows * call.positions) + call.steps * frame_bound_s(run.dims, call.rows)
    return 100.0 * bound / spent if spent else None
