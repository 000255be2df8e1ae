// Non-causal multi-head attention for the Whisper encoder, Hopper (sm_90a).
//
// Replaces the TPU kernel whisperkit_tpu/ops/attention.py::mha_encoder_pallas
// (_mha_kernel). Same function and the same rounding points: q is scaled
// by dh^-0.5 and rounded to q's type before the score dot; scores and the
// softmax are float32; probabilities are rounded to v's type before the
// PV product; the output is rounded to q's type. Inputs are bf16 or f32,
// head dim 64.
//
// What bounds it: arithmetic. At the encoder's shape (S = 1500, Dh = 64)
// one (batch, head) is 2 x 2 x 1500^2 x 64 = 0.58 GFLOP against 0.77 MB of
// bf16 Q/K/V/O traffic, about 750 FLOP per byte.
//
// Design (the simple, right first version; scalar float32 FMA, no tensor
// cores): one block per (batch, head, tile of 128 queries), one thread per
// query. The TPU kernel holds all of K and V for a head in VMEM; here K and
// V for one head at S = 1500 would take 384 KB of f32, more than a block's
// 227 KB of shared memory, so the block walks the keys in tiles of 32 that
// it stages in shared memory (as f32), and each thread keeps an online
// softmax (running max, running sum, rescaled f32 accumulator) in registers.
// K and V reads from shared memory are broadcasts: every thread of the
// block reads the same key row. The ragged tail (1500 = 46 x 32 + 28) is
// masked in place; nothing is padded. Rounding the unnormalised
// probability exp(s - m) to v's type stands in for the TPU kernel's
// rounding of the normalised one: the same precision at the same point of
// the computation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DH = 64;
constexpr int BQ = 128;  // queries (threads) per block
constexpr int KT = 32;   // keys per shared-memory tile

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

template <typename T>
__global__ void __launch_bounds__(BQ)
mha_encoder_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out, int S,
                   float scale) {
  __shared__ __align__(16) float ks[KT][DH];
  __shared__ __align__(16) float vs[KT][DH];

  const int tid = threadIdx.x;
  const long bh = (long)blockIdx.z * gridDim.y + blockIdx.y;
  const long base = bh * S * DH;
  const int qi = blockIdx.x * BQ + tid;
  const bool active = qi < S;

  float qv[DH], o[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qv[d] = active ? round_to<T>(to_f<T>(q[base + (long)qi * DH + d]) * scale) : 0.f;
    o[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int n_tiles = (S + KT - 1) / KT;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * KT;
    const int nvalid = min(KT, S - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < KT * DH; e += BQ) {
      const int j = e / DH, d = e % DH;
      const bool ok = j < nvalid;
      const long src = base + (long)(k0 + j) * DH + d;
      ks[j][d] = ok ? to_f<T>(k[src]) : 0.f;
      vs[j][d] = ok ? to_f<T>(v[src]) : 0.f;
    }
    __syncthreads();

    float s[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) s[j] = 0.f;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        s[j] = fmaf(qv[d], kk.x, s[j]);
        s[j] = fmaf(qv[d + 1], kk.y, s[j]);
        s[j] = fmaf(qv[d + 2], kk.z, s[j]);
        s[j] = fmaf(qv[d + 3], kk.w, s[j]);
      }
    }

    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT; ++j)
      if (j < nvalid) tmax = fmaxf(tmax, s[j]);
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);  // 0 on the first tile (m = -inf)
    l *= corr;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] *= corr;

#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j < nvalid) {
        const float p = expf(s[j] - m_new);
        l += p;
        const float pr = round_to<T>(p);
#pragma unroll
        for (int d = 0; d < DH; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
          o[d] = fmaf(pr, vv.x, o[d]);
          o[d + 1] = fmaf(pr, vv.y, o[d + 1]);
          o[d + 2] = fmaf(pr, vv.z, o[d + 2]);
          o[d + 3] = fmaf(pr, vv.w, o[d + 3]);
        }
      }
    }
    m = m_new;
  }

  if (active) {
    T* dst = out + base + (long)qi * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) dst[d] = from_f<T>(o[d] / l);
  }
}

}  // namespace

extern "C" int wk_mha_encoder(const void* q, const void* k, const void* v, void* out,
                              int batch, int heads, int seq, int is_bf16, float scale,
                              void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0 || batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((seq + BQ - 1) / BQ, heads, batch);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    mha_encoder_kernel<__nv_bfloat16><<<grid, BQ, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (__nv_bfloat16*)out, seq, scale);
  } else {
    mha_encoder_kernel<float><<<grid, BQ, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, seq, scale);
  }
  return (int)cudaGetLastError();
}
