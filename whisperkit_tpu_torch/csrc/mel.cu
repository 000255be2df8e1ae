// Fused log-mel spectrogram for Hopper (sm_90a).
//
// Replaces the TPU kernel whisperkit_tpu/ops/mel.py::log_mel_spectrogram_pallas
// (_mel_kernel): framing (hop 160, window 400), the Hann-windowed DFT,
// power, the slaney mel projection and log10(max(., 1e-10)) in one pass.
// The per-row max-8 clamp, the (x+4)/4 normalisation and the transpose
// stay in torch, as in the JAX wrapper.
//
// What bounds it: arithmetic. One 30 s window is 3000 frames x 400 samples
// x 402 basis columns (cos and sin of 201 frequencies) x 2 = 0.97 GFLOP of
// DFT; its input is 1.9 MB and its output 1.5 MB. The mel projection is
// small: each of the 128 slaney filters spans a few frequencies, so it runs
// on the CUDA cores over each filter's nonzero range only.
//
// Design: the DFT is a matrix product, frames [F, 400] x basis [400, 416],
// on the tensor cores (mma.sync.m16n8k8 in TF32, f32 accumulate). One block
// of 13 warps owns 64 frames of one batch row; warp w owns the frequency
// groups 2w and 2w + 1 (8 frequencies each, 26 groups = 208 columns, the
// last 7 zero): 4 n-tiles (cos and sin of each group, so a thread holds the
// real and imaginary part of the same (frame, frequency) and forms the
// power in registers) by 4 m-tiles of 16 frames. The block stages the
// signal span its frames cover once into shared memory (frame f is
// samples [160 f, 160 f + 400): 66 hops), already split for TF32 (below),
// each hop of 160 samples at a stride of 164 so the A fragments load free
// of bank conflicts (4 hop + k lands lanes on distinct banks). The basis
// comes fragment-ordered from global memory (L2: each block reads its
// 666 KB once, and no two warps read the same part), two k-steps ahead in
// registers. A warp runs its two groups one after the other (the six
// accumulator tiles of both would not fit its registers). The power goes
// to shared memory over the signal, and the mel sums and log10 are
// written straight to the output.
//
// Numerics (3xTF32): TF32 keeps 10 mantissa bits, so a plain TF32 product
// errs by ~2^-11 of each term, far above the float32 the reference keeps
// (Precision.HIGHEST in the JAX path), and a bin 60 dB under its frame's
// peak would lose all its digits. Each operand is split as x = x_hi + x_lo
// with x_hi = tf32(x) and x_lo = tf32(x - x_hi) (together 22 bits), and
// each product is formed as x_hi w_hi + (x_lo w_hi + x_hi w_lo); the
// dropped x_lo w_lo and the residuals are below ~2^-21 of |x w|. The
// tensor cores accumulate in float32 but align each product to the running
// sum, so the two small products accumulate in registers of their own
// (added to the big sum at the end): folded into the big sum they lose
// their low bits, and the result errs nearly like TF32 (so it measured on
// the H100). A DFT coefficient
// then errs by ~2^-21 of sum |x_n w_nk| against float32's ~2^-24, at 3 TF32
// products per float32 one. The on-card check (phase 3 of chip_smoke.py)
// holds the output against the float32 plain version and, on speech-like
// audio, against float64.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int N_FREQ = N_FFT / 2 + 1;    // 201
constexpr int GROUPS = 26;               // frequency groups of 8: 208 columns
constexpr int NTILES = 2 * GROUPS;       // cos and sin of each group
constexpr int KSTEPS = N_FFT / 8;        // k-steps of the m16n8k8 product
constexpr int WARPS = GROUPS / 2;        // 13: two groups a warp
constexpr int THREADS = 32 * WARPS;
constexpr int MF = 64;                   // frames per block: 4 m-tiles
constexpr int HOPS = MF + 2;             // signal hops a block reads
constexpr int HOP_STRIDE = 164;          // float2 per staged hop (160 + 4: skew)
constexpr int P_STRIDE = 212;            // floats per frame of staged power
constexpr int MAX_MELS = 128;
constexpr int SMEM = HOPS * HOP_STRIDE * 8;  // 86,592 B; the power (54 KB) reuses it
static_assert(MF * P_STRIDE * 4 <= SMEM, "power must fit over the staged signal");

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ float2 split(float x) {
  const uint32_t hi = tf32(x);
  return make_float2(__uint_as_float(hi), __uint_as_float(tf32(x - __uint_as_float(hi))));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS, 1)
log_mel_kernel(const float* __restrict__ padded,   // [B, (n_frames + 2) * HOP]
               const float2* __restrict__ basis,   // [KSTEPS, NTILES, 32] B fragments
               const float* __restrict__ mel_w,    // [N_FREQ, n_mels]
               const int2* __restrict__ mel_span,  // [n_mels] nonzero rows [lo, hi) of mel_w
               float* __restrict__ out,            // [B, n_frames, n_mels]
               int n_frames, int n_mels) {
  extern __shared__ __align__(16) float2 seg[];    // [HOPS, HOP_STRIDE] (hi, lo)
  float* power = reinterpret_cast<float*>(seg);    // [MF, P_STRIDE], after the DFT

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int f0 = blockIdx.x * MF;
  const long row_len = (long)(n_frames + 2) * HOP;
  const float* row = padded + (long)blockIdx.y * row_len;

  for (int i = tid; i < HOPS * HOP; i += THREADS) {
    const long idx = (long)f0 * HOP + i;
    seg[(i / HOP) * HOP_STRIDE + i % HOP] = split(idx < row_len ? row[idx] : 0.f);
  }
  __syncthreads();

  // one pass per frequency group (2 warp + q): n-tile j = 0 (cos), 1 (sin)
  // by m-tiles mt (frames 16 mt ..); the big products and the two small
  // ones accumulate apart, or the tensor cores' accumulation, aligned to
  // the running sum, would drop the small ones
  float power_q[2][4][2][2];  // [group][m-tile][row g, g + 8][column 2t, 2t + 1]
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float big[4][2][4], small[4][2][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) big[mt][j][r] = small[mt][j][r] = 0.f;

    const float2* bw = basis + (4 * warp + 2 * q) * 32 + lane;  // + (ks * NTILES + j) * 32
    float2 bq[2][2];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < 2; ++j) bq[p][j] = bw[(p * NTILES + j) * 32];

#pragma unroll 1
    for (int ks0 = 0; ks0 < KSTEPS; ks0 += 2) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int ks = ks0 + p;
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 b0 = split(bq[p][j].x), b1 = split(bq[p][j].y);
          bh[j][0] = __float_as_uint(b0.x); bl[j][0] = __float_as_uint(b0.y);
          bh[j][1] = __float_as_uint(b1.x); bl[j][1] = __float_as_uint(b1.y);
          if (ks + 2 < KSTEPS) bq[p][j] = bw[((ks + 2) * NTILES + j) * 32];
        }
        // A fragment of frame rows 16 mt + g (+ 8), samples 8 ks + t (+ 4):
        // sample k of local frame f is hop f + k / 160, offset k % 160
        const int hop = (8 * ks) / HOP, off = (8 * ks) % HOP + t;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const float2* s = seg + (16 * mt + g + hop) * HOP_STRIDE + off;
          const float2 x0 = s[0], x2 = s[4], x1 = s[8 * HOP_STRIDE], x3 = s[8 * HOP_STRIDE + 4];
          const uint32_t ah[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x), __float_as_uint(x2.x),
                                  __float_as_uint(x3.x)};
          const uint32_t al[4] = {__float_as_uint(x0.y), __float_as_uint(x1.y), __float_as_uint(x2.y),
                                  __float_as_uint(x3.y)};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma_tf32(small[mt][j], al, bh[j][0], bh[j][1]);
            mma_tf32(small[mt][j], ah, bl[j][0], bl[j][1]);
            mma_tf32(big[mt][j], ah, bh[j][0], bh[j][1]);
          }
        }
      }
    }
    // power: C fragment rows g and g + 8 of the m-tile, columns 2t, 2t + 1
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float re = big[mt][0][r] + small[mt][0][r], im = big[mt][1][r] + small[mt][1][r];
        power_q[q][mt][r >> 1][r & 1] = re * re + im * im;
      }
  }
  __syncthreads();  // every warp is done with the signal: the power goes over it

#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      float* p = power + (16 * mt + g) * P_STRIDE + 8 * (2 * warp + q) + 2 * t;
      p[0] = power_q[q][mt][0][0];
      p[1] = power_q[q][mt][0][1];
      p[8 * P_STRIDE] = power_q[q][mt][1][0];
      p[8 * P_STRIDE + 1] = power_q[q][mt][1][1];
    }
  __syncthreads();

  const int frames = min(MF, n_frames - f0);
  float* orow = out + ((long)blockIdx.y * n_frames + f0) * n_mels;
  for (int o = tid; o < frames * n_mels; o += THREADS) {
    const int f = o / n_mels, m = o - f * n_mels;
    const int2 span = mel_span[m];
    const float* p = power + f * P_STRIDE;
    float a = 0.f;
    for (int k = span.x; k < span.y; ++k) a = fmaf(p[k], __ldg(mel_w + k * n_mels + m), a);
    orow[o] = log10f(fmaxf(a, 1e-10f));
  }
}

}  // namespace

extern "C" int wk_log_mel(const void* padded, const void* basis, const void* mel_w,
                          const void* mel_span, void* out, int batch, int n_frames,
                          int n_mels, void* stream) {
  if (batch <= 0 || n_frames <= 0 || n_mels <= 0 || n_mels > MAX_MELS || batch > 65535)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((n_frames + MF - 1) / MF, batch);
  log_mel_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const float*)padded, (const float2*)basis, (const float*)mel_w, (const int2*)mel_span,
      (float*)out, n_frames, n_mels);
  return (int)cudaGetLastError();
}
