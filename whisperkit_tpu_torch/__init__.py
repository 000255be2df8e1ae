"""whisperkit_tpu_torch — the PyTorch/CUDA port of `whisperkit_tpu`.

The JAX package (`whisperkit_tpu/`) is the reference; this package mirrors
its module layout so each function has a counterpart of the same name:

  audio/                  file loading (native FFmpeg decoder or WAV),
                          energy VAD and the VAD chunker
  core/                   configuration, result, timing and error types;
                          device resolution (no silent CPU fallback), the
                          CUDA probe, model registry and support matrix
  text/                   languages, the BPE tokenizer, segments and seek,
                          word timestamps, result writers
  models/whisper.py       Whisper encoder/decoder on torch tensors
  models/loader.py        HF checkpoint folders (safetensors read by mmap)
  ops/mel.py              log-mel (hand-written CUDA kernel + plain torch)
  ops/attention.py        encoder MHA (hand-written CUDA kernel + plain torch)
  ops/attention_decode.py T==1 decode attention kernels (+ plain torch)
  ops/quant.py            W8A16 / W4A16 / W8A8 weights
  decoding/               logits filters, sampler, the decode loop, beam
                          search, speculative decoding
  pipelines/whisper.py    WhisperPipeline: load_models, transcribe
  pipelines/scheduler.py  continuous batching of windows across requests
  server/                 the OpenAI-compatible Audio API (stdlib HTTP)
  cli/                    python -m whisperkit_tpu_torch.cli transcribe|serve
  tools/                  the standard workload, profilers, kernel checks,
                          a random-weight checkpoint writer

The package imports nothing of `whisperkit_tpu` and no JAX: it keeps its
own copies of the JAX package's framework-free modules (audio, core, text),
with the same names, fields and defaults (`tests/test_torch_isolation.py`
holds them against the originals), and imports no package that the card's
machine lacks (aiohttp, pydantic, safetensors, transformers, orbax;
huggingface_hub only inside the registry's download step).

Every CUDA kernel lives in `csrc/*.cu`, is compiled with nvcc for sm_90a at
first use (ops/_build.py) and is bound with ctypes. A wrapper runs its
kernel for a CUDA tensor and its plain PyTorch version for a CPU tensor.
Entry points that place tensors take `device="cuda"` by default.
"""

__version__ = "0.1.0"
