"""whisperkit_tpu_torch — the PyTorch/CUDA port of `whisperkit_tpu`.

The JAX package (`whisperkit_tpu/`) is the reference; this package mirrors
its module layout so each function has a counterpart of the same name:

  core/device.py          explicit device resolution (no silent CPU fallback)
  models/whisper.py       Whisper encoder/decoder on torch tensors
  ops/mel.py              log-mel (hand-written CUDA kernel + plain torch)
  ops/attention.py        encoder MHA (hand-written CUDA kernel + plain torch)
  ops/attention_decode.py T==1 decode attention kernels (+ plain torch)
  decoding/               logits filters, sampler, the decode loop
  pipelines/whisper.py    WhisperPipeline.transcribe

Every CUDA kernel lives in `csrc/*.cu`, is compiled with nvcc for sm_90a at
first use (ops/_build.py) and is bound with ctypes. A wrapper runs its
kernel for a CUDA tensor and its plain PyTorch version for a CPU tensor.

The JAX-free modules of the old package (audio front end, text, core
configuration/result types) are imported from `whisperkit_tpu` unchanged.
"""

__version__ = "0.1.0"
