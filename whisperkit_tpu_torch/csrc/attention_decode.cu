// Decode-step attention kernels for Hopper (sm_90a): the int8
// cross-attention, and the self-attention over the raw KV cache and over
// the int8 KV cache.
//
// Replaces the TPU kernels in whisperkit_tpu/ops/attention_decode.py:
//   cross_attend_q8_kernel  <- cross_attend_q8_pallas (_cross_decode_kernel)
//   self_attend_kernel      <- self_attend_pallas (_self_decode_kernel)
//   self_attend_q8_kernel   <- self_attend_q8_pallas (_self_decode_q8_kernel)
//
// What bounds them: device-memory bandwidth. Each is a pair of
// matrix-vector products per (batch, head, query row) that reads the whole
// K and V once and does 2 operations per byte read (int8) or 1 per byte
// (self, bf16), far under the card's ~295 operations per byte. At the
// serving shape (B = 32, H = 20) one decode step reads 3.9 GB of int8
// cross-K/V, and up to 1.2 GB of bf16 self-K/V or 0.6 GB of int8 self-K/V
// (plus 38 MB of per-token scales) over all 32 layers.
//
// Design (simple and right first): one block of 256 threads per (batch,
// head[, query row]); B x H = 640 blocks over 132 SMs. Pass 1: each thread
// takes whole key rows (one 64-wide row is 64 B of int8 or 128 B of bf16,
// read with 16-byte loads) and writes its score to shared memory. The
// softmax runs over the shared scores with block reductions. Pass 2: the
// threads split the key axis into groups and each lane owns a slice of the
// 64 channels, so a warp reads whole contiguous rows of V; the groups'
// partial sums meet in shared memory. K and V are each read exactly once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;
constexpr int NT = 256;
constexpr int NWARP = NT / 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Block-wide max / sum; every thread gets the result. `red` holds NWARP floats.
__device__ __forceinline__ float block_max(float x, float* red) {
  x = warp_max(x);
  __syncthreads();  // red may still be read by a previous reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = (threadIdx.x & 31) < NWARP ? red[threadIdx.x & 31] : -INFINITY;
  return warp_max(x);
}

__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = (threadIdx.x & 31) < NWARP ? red[threadIdx.x & 31] : 0.f;
  return warp_sum(x);
}

// ---------------------------------------------------------------------------
// int8 cross-attention (K3). Same math as the JAX reference
// (whisperkit_tpu/ops/attention_decode.py::cross_attend_q8_reference):
//   scores = (qi . k) [int32] * q_scale            f32
//   probs  = softmax(scores)                       f32
//   p_scale = max(max(probs) / 127, 1e-8)
//   pi = clip(rint(probs / p_scale), 0, 127)       round half to even
//   out = (pi . v) [int32] * p_scale * v_scale     f32
// Grid (B*H, T): query rows t > 0 let the prompt prefill run here too.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
cross_attend_q8_kernel(const int8_t* __restrict__ qi,     // [BH, T, DH]
                       const float* __restrict__ q_scale,  // [BH, T]
                       const int8_t* __restrict__ k,       // [BH, S, DH]
                       const int8_t* __restrict__ v,       // [BH, S, DH]
                       const float* __restrict__ v_scale,  // [BH, DH]
                       float* __restrict__ out,            // [BH, T, DH]
                       int T, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);                  // S scores / probs
  signed char* pq = reinterpret_cast<signed char*>(sc + S);    // S int8 probs
  __shared__ int qw[DH / 4];
  __shared__ float red[NWARP];
  __shared__ int vred[NT / 16][DH];

  const int tid = threadIdx.x;
  const long bh = blockIdx.x;
  const long row = bh * T + blockIdx.y;

  if (tid < DH / 4) qw[tid] = reinterpret_cast<const int*>(qi + row * DH)[tid];
  __syncthreads();
  const float qs = q_scale[row];

  const int8_t* kb = k + bh * S * DH;
  float lmax = -INFINITY;
  for (int s = tid; s < S; s += NT) {
    const int4* kr = reinterpret_cast<const int4*>(kb + (long)s * DH);
    int acc = 0;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      const int4 w = kr[c];
      acc = __dp4a(w.x, qw[4 * c + 0], acc);
      acc = __dp4a(w.y, qw[4 * c + 1], acc);
      acc = __dp4a(w.z, qw[4 * c + 2], acc);
      acc = __dp4a(w.w, qw[4 * c + 3], acc);
    }
    const float x = (float)acc * qs;
    sc[s] = x;
    lmax = fmaxf(lmax, x);
  }
  const float mx = block_max(lmax, red);

  float lsum = 0.f;
  for (int s = tid; s < S; s += NT) {
    const float e = expf(sc[s] - mx);
    sc[s] = e;
    lsum += e;
  }
  const float sum = block_sum(lsum, red);

  float lpmax = 0.f;
  for (int s = tid; s < S; s += NT) {
    const float p = sc[s] / sum;
    sc[s] = p;
    lpmax = fmaxf(lpmax, p);
  }
  const float p_scale = fmaxf(block_max(lpmax, red) / 127.f, 1e-8f);

  for (int s = tid; s < S; s += NT) {
    const float r = fminf(fmaxf(rintf(sc[s] / p_scale), 0.f), 127.f);
    pq[s] = (signed char)(int)r;
  }
  __syncthreads();

  // pass 2: 16 groups over the key axis, lane l owns channels 4l .. 4l+3
  const int g = tid >> 4, l = tid & 15;
  const int8_t* vb = v + bh * S * DH;
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  for (int s = g; s < S; s += NT / 16) {
    const int p = pq[s];
    const char4 vv = reinterpret_cast<const char4*>(vb + (long)s * DH)[l];
    a0 += p * vv.x;
    a1 += p * vv.y;
    a2 += p * vv.z;
    a3 += p * vv.w;
  }
  vred[g][4 * l + 0] = a0;
  vred[g][4 * l + 1] = a1;
  vred[g][4 * l + 2] = a2;
  vred[g][4 * l + 3] = a3;
  __syncthreads();
  if (tid < DH) {
    int tot = 0;
#pragma unroll
    for (int i = 0; i < NT / 16; ++i) tot += vred[i][tid];
    out[row * DH + tid] = ((float)tot * p_scale) * v_scale[bh * DH + tid];
  }
}

// ---------------------------------------------------------------------------
// Self-attention over the raw cache (K4). Same math as the JAX kernel:
//   scores = q . k + mask     f32 (q arrives scaled by dh^-0.5)
//   out = softmax(scores) . v f32
// Keys whose mask entry is -inf are not read: their score is -inf either
// way and their probability exactly 0.
// ---------------------------------------------------------------------------
template <typename T> struct Row8;
template <> struct Row8<__nv_bfloat16> {
  // 8 bf16 values from a 16-byte aligned address
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* x) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};
template <> struct Row8<float> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

template <typename T>
__global__ void __launch_bounds__(NT)
self_attend_kernel(const float* __restrict__ q,     // [BH, DH]
                   const T* __restrict__ k,         // [BH, S, DH]
                   const T* __restrict__ v,         // [BH, S, DH]
                   const float* __restrict__ mask,  // [S]
                   float* __restrict__ out,         // [BH, DH]
                   int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);  // S scores / probs
  __shared__ float qv[DH];
  __shared__ float red[NWARP];
  __shared__ float ored[NWARP][DH];

  const int tid = threadIdx.x;
  const long bh = blockIdx.x;
  if (tid < DH) qv[tid] = q[bh * DH + tid];
  __syncthreads();

  const T* kb = k + bh * S * DH;
  float lmax = -INFINITY;
  for (int s = tid; s < S; s += NT) {
    const float mk = mask[s];
    float x = -INFINITY;
    if (mk != -INFINITY) {
      const T* kr = kb + (long)s * DH;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < DH; c += 8) {
        float kk[8];
        Row8<T>::load(kr + c, kk);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(qv[c + i], kk[i], acc);
      }
      x = acc + mk;
    }
    sc[s] = x;
    lmax = fmaxf(lmax, x);
  }
  const float mx = block_max(lmax, red);

  float lsum = 0.f;
  for (int s = tid; s < S; s += NT) {
    const float e = expf(sc[s] - mx);
    sc[s] = e;
    lsum += e;
  }
  const float sum = block_sum(lsum, red);
  for (int s = tid; s < S; s += NT) sc[s] = sc[s] / sum;
  __syncthreads();

  // pass 2: one warp per group of keys, lane owns channels 2 lane, 2 lane + 1
  const int g = tid >> 5, lane = tid & 31;
  const T* vb = v + bh * S * DH;
  float a0 = 0.f, a1 = 0.f;
  for (int s = g; s < S; s += NWARP) {
    const float p = sc[s];
    if (p == 0.f) continue;  // warp-uniform: the whole warp shares s
    const float2 vv = Row8<T>::load2(vb + (long)s * DH + 2 * lane);
    a0 = fmaf(p, vv.x, a0);
    a1 = fmaf(p, vv.y, a1);
  }
  ored[g][2 * lane] = a0;
  ored[g][2 * lane + 1] = a1;
  __syncthreads();
  if (tid < DH) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < NWARP; ++i) tot += ored[i][tid];
    out[bh * DH + tid] = tot;
  }
}

// ---------------------------------------------------------------------------
// Self-attention over the int8 cache with per-token scales (K5). Same math
// as the JAX kernel (_self_decode_q8_kernel) and _attend_self_q8:
//   scores = (qi . k)[int32] * q_scale * k_scale[s] + mask[s]   f32
//   probs  = softmax(scores)                                    f32
//   pw     = probs * v_scale[s]               (fold the per-token V scales)
//   p_scale = max(max(pw) / 127, 1e-8)
//   pi = clip(rint(pw / p_scale), 0, 127)                       round half to even
//   out = (pi . v)[int32] * p_scale                             f32
// Laid out as K3 (int8 __dp4a scores, int8 P.V in int32) over K4's grid
// (one block per (batch, head)). Keys whose mask entry is -inf are not
// read, neither codes nor scales: an unwritten cache row has scale 0, and
// 0 * -inf is never evaluated. Position 0 is always visible, so the row
// max is finite. At B = 32, S = 227 a launch reads 18.6 MB of int8 K/V and
// 1.2 MB of scales, half of K4's bytes; one block per (b, h) row gives
// 640 blocks of 227 keys, too little work each to reach full bandwidth
// (K4 reaches 26% with the same layout). Splitting the key axis is later
// speed work.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
self_attend_q8_kernel(const int8_t* __restrict__ qi,      // [BH, DH]
                      const float* __restrict__ q_scale,  // [BH]
                      const int8_t* __restrict__ k,       // [BH, S, DH]
                      const float* __restrict__ k_scale,  // [BH, S]
                      const int8_t* __restrict__ v,       // [BH, S, DH]
                      const float* __restrict__ v_scale,  // [BH, S]
                      const float* __restrict__ mask,     // [S]
                      float* __restrict__ out,            // [BH, DH]
                      int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);                // S scores / weighted probs
  signed char* pq = reinterpret_cast<signed char*>(sc + S);  // S int8 probs
  __shared__ int qw[DH / 4];
  __shared__ float red[NWARP];
  __shared__ int vred[NT / 16][DH];

  const int tid = threadIdx.x;
  const long bh = blockIdx.x;
  if (tid < DH / 4) qw[tid] = reinterpret_cast<const int*>(qi + bh * DH)[tid];
  __syncthreads();
  const float qs = q_scale[bh];

  const int8_t* kb = k + bh * S * DH;
  const float* ksb = k_scale + bh * S;
  float lmax = -INFINITY;
  for (int s = tid; s < S; s += NT) {
    const float mk = mask[s];
    float x = -INFINITY;
    if (mk != -INFINITY) {
      const int4* kr = reinterpret_cast<const int4*>(kb + (long)s * DH);
      int acc = 0;
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) {
        const int4 w = kr[c];
        acc = __dp4a(w.x, qw[4 * c + 0], acc);
        acc = __dp4a(w.y, qw[4 * c + 1], acc);
        acc = __dp4a(w.z, qw[4 * c + 2], acc);
        acc = __dp4a(w.w, qw[4 * c + 3], acc);
      }
      x = (float)acc * qs * ksb[s] + mk;
    }
    sc[s] = x;
    lmax = fmaxf(lmax, x);
  }
  const float mx = block_max(lmax, red);

  float lsum = 0.f;
  for (int s = tid; s < S; s += NT) {
    const float e = expf(sc[s] - mx);
    sc[s] = e;
    lsum += e;
  }
  const float sum = block_sum(lsum, red);

  const float* vsb = v_scale + bh * S;
  float lpmax = 0.f;
  for (int s = tid; s < S; s += NT) {
    const float e = sc[s];
    const float pw = e > 0.f ? (e / sum) * vsb[s] : 0.f;  // masked keys: no scale read
    sc[s] = pw;
    lpmax = fmaxf(lpmax, pw);
  }
  const float p_scale = fmaxf(block_max(lpmax, red) / 127.f, 1e-8f);

  for (int s = tid; s < S; s += NT) {
    const float r = fminf(fmaxf(rintf(sc[s] / p_scale), 0.f), 127.f);
    pq[s] = (signed char)(int)r;
  }
  __syncthreads();

  // pass 2: 16 groups over the key axis, lane l owns channels 4l .. 4l+3;
  // a zero probability (every masked key) adds nothing, so its row of V is
  // not read
  const int g = tid >> 4, l = tid & 15;
  const int8_t* vb = v + bh * S * DH;
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  for (int s = g; s < S; s += NT / 16) {
    const int p = pq[s];
    if (p == 0) continue;
    const char4 vv = reinterpret_cast<const char4*>(vb + (long)s * DH)[l];
    a0 += p * vv.x;
    a1 += p * vv.y;
    a2 += p * vv.z;
    a3 += p * vv.w;
  }
  vred[g][4 * l + 0] = a0;
  vred[g][4 * l + 1] = a1;
  vred[g][4 * l + 2] = a2;
  vred[g][4 * l + 3] = a3;
  __syncthreads();
  if (tid < DH) {
    int tot = 0;
#pragma unroll
    for (int i = 0; i < NT / 16; ++i) tot += vred[i][tid];
    out[bh * DH + tid] = (float)tot * p_scale;
  }
}

size_t aligned16(size_t n) { return (n + 15) & ~size_t(15); }

}  // namespace

extern "C" int wk_cross_attend_q8(const void* qi, const void* q_scale, const void* k,
                                  const void* v, const void* v_scale, void* out,
                                  int bh, int t, int s, void* stream) {
  if (bh <= 0 || t <= 0 || s <= 0 || t > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = aligned16((size_t)s * (sizeof(float) + 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cross_attend_q8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cross_attend_q8_kernel<<<dim3(bh, t), NT, smem, (cudaStream_t)stream>>>(
      (const int8_t*)qi, (const float*)q_scale, (const int8_t*)k, (const int8_t*)v,
      (const float*)v_scale, (float*)out, t, s);
  return (int)cudaGetLastError();
}

extern "C" int wk_self_attend(const void* q, const void* k, const void* v,
                              const void* mask, void* out, int bh, int s, int is_bf16,
                              void* stream) {
  if (bh <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = aligned16((size_t)s * sizeof(float));
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(self_attend_kernel<__nv_bfloat16>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    self_attend_kernel<__nv_bfloat16><<<bh, NT, smem, st>>>(
        (const float*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const float*)mask, (float*)out, s);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(self_attend_kernel<float>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    self_attend_kernel<float><<<bh, NT, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)mask,
        (float*)out, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int wk_self_attend_q8(const void* qi, const void* q_scale, const void* k,
                                 const void* k_scale, const void* v, const void* v_scale,
                                 const void* mask, void* out, int bh, int s, void* stream) {
  if (bh <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = aligned16((size_t)s * (sizeof(float) + 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        self_attend_q8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  self_attend_q8_kernel<<<bh, NT, smem, (cudaStream_t)stream>>>(
      (const int8_t*)qi, (const float*)q_scale, (const int8_t*)k, (const float*)k_scale,
      (const int8_t*)v, (const float*)v_scale, (const float*)mask, (float*)out, s);
  return (int)cudaGetLastError();
}
