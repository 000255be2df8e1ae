"""Set-up seconds: from the process's start to the first timed request
(imports, CUDA start, the kernels' build or load, the weights made on the
card and quantized, the audio made, the warm-up)."""


def read(run):
    return run.setup_s
