"""K3 (`csrc/attention_decode.cu`, the T == 1 cross-attention over the
int8 cross-KV) against its bound, in %: over the K3 launches of the traced
file's decode calls, the sum of each launch's bound at its call's rows
(`roofline.cross_attend_q8_bound_s`) over the sum of its device time."""

from benchmark.roofline import cross_attend_q8_bound_s

KERNEL = "cross_attend_q8"


def read(run):
    sl, d = run.window.trace, run.dims
    bound = spent = 0.0
    for call in run.slice_calls("decode") if sl is not None else ():
        for name, s, e, _ in sl.launched_in([(call.t0, call.t1)]):
            if KERNEL in name:
                bound += cross_attend_q8_bound_s(call.rows, d.decoder_heads, 1, d.n_audio_ctx,
                                                 d.d_model // d.decoder_heads)
                spent += (e - s) / 1e6
    return 100.0 * bound / spent if spent else None
