"""K2 (`csrc/mha_encoder.cu`, the encoder's attention) against its bound,
in %: over the K2 launches of the traced file's encode calls, the sum of
each launch's bound at its call's rows (`roofline.mha_encoder_bound_s`)
over the sum of its device time."""

from benchmark.roofline import mha_encoder_bound_s

KERNEL = "mha_encoder"


def read(run):
    sl, d = run.window.trace, run.dims
    bound = spent = 0.0
    for call in run.slice_calls("encode") if sl is not None else ():
        for name, s, e, _ in sl.launched_in([(call.t0, call.t1)]):
            if KERNEL in name:
                bound += mha_encoder_bound_s(call.rows, d.encoder_heads, d.n_audio_ctx, d.d_model // d.encoder_heads)
                spent += (e - s) / 1e6
    return 100.0 * bound / spent if spent else None
