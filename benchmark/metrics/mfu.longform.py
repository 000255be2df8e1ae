"""The whole step's share of the card's bf16 peak, in %: the useful model
operations of the window's finished files (every real window's encoder
and cross-KV projection, and its prompt and decoded tokens through the
decoder and the logits; pad rows left out; `roofline.window_flops`), over
the window's wall times 989 TFLOP/s. The windows and tokens are the port's
`TranscriptionTimings` counts of each file."""

from benchmark.roofline import PEAK, window_flops


def read(run):
    w = run.window
    flops = 0.0
    for item in w.items:
        t = item.answer.timings
        windows = int(t.total_decoding_windows)
        if windows:
            flops += windows * window_flops(run.dims, round(t.total_decoding_loops / windows))
    return 100.0 * flops / (w.wall_s * PEAK["bf16_flop_s"]) if flops else None
