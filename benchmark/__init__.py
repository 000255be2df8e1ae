"""The benchmark of whisperkit_tpu_torch on one NVIDIA H100 (see
`BENCHMARK.json` at the checkout's root and `run.py`). It imports the port
as the system under test and never the JAX package."""
