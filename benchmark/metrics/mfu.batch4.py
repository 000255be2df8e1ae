"""The whole step's share of the card's bf16 peak, in %: the model
operations of the window's finished paragraphs (the paragraph in flight at
the window's end included) over the window's wall times 989 TFLOP/s.

A paragraph's operations, row by row over the frames it served (the
system's count of each row's frames; the frames a done row steps in its
segment's tail, and the frame buffer past its frames in the vocoder, are
left out): the prompt positions its loop call prefilled, one talker
position a frame, the code predictor's 15 passes and 15 heads a frame, and
the vocoder's transformer and convolutions over its frames. A product of
[rows, k] by [k, n] is 2 rows k n operations; attention over c keys is
4 c x the heads' width a position; a convolution 2 x its output length x
its input channels a group x its output channels x its kernel, a
transposed one 2 x its input length x its channels in and out x its
kernel. Norms, activations, rotary and the sampler are left out."""

from benchmark.roofline import PEAK

PASSES = 15


def stack_position_flops(d: int, s, keys: int) -> float:
    """One position through a stack's layers, attending `keys` keys."""
    q, kv = s.heads * s.head_dim, s.kv_heads * s.head_dim
    layer = 2 * d * q + 2 * 2 * d * kv + 2 * q * d + 3 * 2 * d * s.ffn + 4 * keys * q
    return float(s.layers * layer)


def talker_flops(dims, position: int) -> float:
    """The talker at `position` (0-based), with its code0 logits."""
    return stack_position_flops(dims.d_model, dims.talker, position + 1) + 2.0 * dims.d_model * dims.codec_vocab


def predictor_flops(dims) -> float:
    """A frame's code predictor: positions 0..15, each attending itself and
    the earlier ones, and the 15 heads."""
    d = dims.d_model
    return (sum(stack_position_flops(d, dims.predictor, j + 1) for j in range(PASSES + 1))
            + PASSES * 2.0 * d * dims.codebook)


def vocoder_flops(dims, frames: int) -> float:
    """Code2Wav over `frames` frames of one row."""
    if frames == 0:
        return 0.0
    d, t, c0 = dims.vocoder_dim, frames, dims.decoder_dim
    flops = sum(stack_position_flops(d, dims.vocoder, min(j + 1, dims.window)) for j in range(t))
    length = t
    for f in dims.upsampling:
        flops += 2.0 * length * d * d * f  # transposed conv, k = stride = f
        length *= f
        flops += 2.0 * length * d * 7 + 2 * 2.0 * length * d * 4 * d  # ConvNeXt: depthwise k7, two pointwise
    flops += 2.0 * length * d * c0 * 7
    for i, r in enumerate(dims.rates):
        ci, co = c0 // 2 ** i, c0 // 2 ** (i + 1)
        flops += 2.0 * length * ci * co * 2 * r  # transposed conv, k = 2 stride
        length = length * r - r
        flops += 3 * (2.0 * length * co * co * 7 + 2.0 * length * co * co)  # residual units: k7 and k1
    return flops + 2.0 * length * (c0 // 2 ** len(dims.rates)) * 7


def row_flops(dims, frames: int, prompt_len: int, prefilled: int) -> float:
    prompt = sum(talker_flops(dims, p) for p in range(prompt_len - prefilled, prompt_len))
    talker = sum(talker_flops(dims, prompt_len + f) for f in range(frames))
    return prompt + talker + frames * predictor_flops(dims) + vocoder_flops(dims, frames)


def read(run):
    w = run.window
    flops = 0.0
    for item in w.items:
        a = item.answer
        for n in a.n_frames.tolist():
            flops += row_flops(run.dims, int(n), a.prompt_len, a.prefilled)
    return 100.0 * flops / (w.wall_s * PEAK["bf16_flop_s"]) if flops else None
