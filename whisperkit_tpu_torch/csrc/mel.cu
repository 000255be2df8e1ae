// Fused log-mel spectrogram for Hopper (sm_90a).
//
// Replaces the TPU kernel whisperkit_tpu/ops/mel.py::log_mel_spectrogram_pallas
// (_mel_kernel): framing (hop 160, window 400), the Hann-windowed DFT,
// power, the slaney mel projection and log10(max(., 1e-10)) in one pass.
// The per-row max-8 clamp, the (x+4)/4 normalisation and the transpose
// stay in torch, as in the JAX wrapper.
//
// Numerics: every product is a float32 FMA on the CUDA cores. No tensor
// cores and no TF32, so the result matches the JAX path's
// Precision.HIGHEST dots up to summation order.
//
// What bounds it: arithmetic. One 30 s window is 3000 x 400 x 201 x 2 x 2
// = 0.97 GFLOP of DFT plus 0.15 GFLOP of mel; its input is 1.9 MB and its
// output 1.5 MB. The Hann-windowed basis (cos and sin [400, 201] f32,
// 643 KB) is larger than one block's shared memory, so it stays in global
// memory and is read through L2, where it stays resident: each block reads
// it once for FT frames, so FT is the basis reuse factor.
//
// Design: one block per (batch row, tile of FT frames). The block copies
// the contiguous span of the padded signal its frames cover into shared
// memory (frame f is samples [160 f, 160 f + 400) of the padded signal, so
// FT frames need (FT + 2) * 160 samples). Thread k (k < 201) owns frequency
// k and keeps FT real and FT imaginary accumulators in registers; each
// basis element it loads feeds 2 FT FMAs, and the signal sample is a
// shared-memory broadcast. The power spectrum goes to shared memory, and
// the mel projection reads it with one thread per output element.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int N_FREQ = N_FFT / 2 + 1;  // 201
constexpr int FT = 32;                 // frames per block
constexpr int THREADS = 256;
constexpr int MAX_MELS = 128;

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ padded,  // [B, (n_frames + 2) * HOP]
               const float* __restrict__ cos_m,   // [N_FFT, N_FREQ]
               const float* __restrict__ sin_m,   // [N_FFT, N_FREQ]
               const float* __restrict__ mel_w,   // [N_FREQ, n_mels]
               float* __restrict__ out,           // [B, n_frames, n_mels]
               int n_frames, int n_mels) {
  __shared__ float seg[(FT + 2) * HOP];
  __shared__ float power[FT][N_FREQ];

  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * FT;
  const long row_len = (long)(n_frames + 2) * HOP;
  const float* row = padded + (long)blockIdx.y * row_len;

  for (int i = tid; i < (FT + 2) * HOP; i += THREADS) {
    const long idx = (long)f0 * HOP + i;
    seg[i] = idx < row_len ? row[idx] : 0.f;
  }
  __syncthreads();

  if (tid < N_FREQ) {
    float re[FT], im[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    for (int n = 0; n < N_FFT; ++n) {
      const float c = __ldg(cos_m + n * N_FREQ + tid);
      const float s = __ldg(sin_m + n * N_FREQ + tid);
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        const float x = seg[f * HOP + n];
        re[f] = fmaf(x, c, re[f]);
        im[f] = fmaf(x, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < FT; ++f) power[f][tid] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  float* out_rows = out + ((long)blockIdx.y * n_frames + f0) * n_mels;
  for (int o = tid; o < FT * n_mels; o += THREADS) {
    const int f = o / n_mels;
    const int m = o - f * n_mels;
    if (f0 + f >= n_frames) break;  // o only grows, so the rest is out too
    float acc = 0.f;
    for (int k = 0; k < N_FREQ; ++k)
      acc = fmaf(power[f][k], __ldg(mel_w + k * n_mels + m), acc);
    out_rows[o] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

extern "C" int wk_log_mel(const void* padded, const void* cos_m, const void* sin_m,
                          const void* mel_w, void* out, int batch, int n_frames,
                          int n_mels, void* stream) {
  if (batch <= 0 || n_frames <= 0 || n_mels <= 0 || n_mels > MAX_MELS || batch > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n_frames + FT - 1) / FT, batch);
  log_mel_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)padded, (const float*)cos_m, (const float*)sin_m,
      (const float*)mel_w, (float*)out, n_frames, n_mels);
  return (int)cudaGetLastError();
}
