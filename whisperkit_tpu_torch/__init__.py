"""whisperkit_tpu_torch — the PyTorch/CUDA port of `whisperkit_tpu`.

The JAX package (`whisperkit_tpu/`) is the reference; this package mirrors
its module layout so each function has a counterpart of the same name:

  audio/                  file loading (native FFmpeg decoder or WAV),
                          energy VAD and the VAD chunker
  core/                   configuration, result, timing and error types;
                          device resolution (no silent CPU fallback)
  text/                   languages, special tokens, segments and seek
  models/whisper.py       Whisper encoder/decoder on torch tensors
  ops/mel.py              log-mel (hand-written CUDA kernel + plain torch)
  ops/attention.py        encoder MHA (hand-written CUDA kernel + plain torch)
  ops/attention_decode.py T==1 decode attention kernels (+ plain torch)
  ops/quant.py            W8A16 / W4A16 / W8A8 weights
  decoding/               logits filters, sampler, the decode loop
  pipelines/whisper.py    WhisperPipeline.transcribe
  tools/                  the standard workload, profilers, K2's check

The package imports nothing of `whisperkit_tpu` and no JAX: it keeps its
own copies of the JAX package's framework-free modules (audio, core, text),
trimmed to what the port uses, with the same names, fields and defaults
(`tests/test_torch_isolation.py` holds them against the originals).

Every CUDA kernel lives in `csrc/*.cu`, is compiled with nvcc for sm_90a at
first use (ops/_build.py) and is bound with ctypes. A wrapper runs its
kernel for a CUDA tensor and its plain PyTorch version for a CPU tensor.
Entry points that place tensors take `device="cuda"` by default.
"""

__version__ = "0.1.0"
