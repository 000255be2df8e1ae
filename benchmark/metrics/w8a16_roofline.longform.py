"""The W8A16 product's kernel (`csrc/w8a16_matmul.cu`, every launch whose
name holds `w8a16_matmul`) against its bound, in %: over the traced file's
decode calls, the sum of each call's steps times one step's bound at the
call's rows, over the sum of the kernel's device time there. None where
the kernel never launched.

A step's bound sums, over the decoder's layers and their eight W8A16
products (self-attention q, k, v, out; cross-attention q, out; fc1, fc2),
the larger of the product's bytes over the memory rate and its operations
over the bf16 peak. Its bytes: the K x N int8 codes, the N bf16 scales, x
(rows x K bf16) read and y (rows x N bf16) written; the bias is not
counted."""

from benchmark.roofline import PEAK

KERNEL = "w8a16_matmul"


def product_bound_s(rows: int, k: int, n: int) -> float:
    nbytes = k * n + 2 * n + 2 * rows * k + 2 * rows * n
    return max(nbytes / PEAK["hbm_byte_s"], 2.0 * rows * k * n / PEAK["bf16_flop_s"])


def step_bound_s(dims, rows: int) -> float:
    d, f = dims.d_model, dims.decoder_ffn
    layer = 6 * product_bound_s(rows, d, d) + product_bound_s(rows, d, f) + product_bound_s(rows, f, d)
    return dims.decoder_layers * layer


def read(run):
    sl = run.window.trace
    if sl is None:
        return None
    bound = spent = 0.0
    for call in run.slice_calls("decode"):
        spent += sum(e - s for name, s, e, _ in sl.launched_in([(call.t0, call.t1)]) if KERNEL in name) / 1e6
        bound += call.steps * step_bound_s(run.dims, call.rows)
    return 100.0 * bound / spent if spent else None
