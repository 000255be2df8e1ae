"""Host milliseconds a TTS paragraph spends capturing its frame's CUDA graph
and instantiating it, over the window (the port's
`decoding/graph.stats_by_device`: capture and instantiation seconds over
captures; one capture a `tts_generate_loop` call, so one a paragraph)."""


def read(run):
    g = run.counters
    return 1e3 * (g["capture_s"] + g["instantiate_s"]) / g["captures"] if g["captures"] else None
