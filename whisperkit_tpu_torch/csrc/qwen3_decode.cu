// The float32 glue of a Qwen3 decode layer pass for Hopper (sm_90a): the
// TTS talker's frame step and the code predictor's passes, a few rows of
// one or two positions each. Three kernels:
//
//   add_rms_norm_kernel      s = bf16(x + y), h = bf16(rmsnorm_f32(s) * g)
//   decode_attention_kernel  per-head q/k RMSNorm + rotary + the cache write
//                            + GQA attention over the cache in place
//   swiglu_kernel            bf16(bf16(silu_f32(gate)) * up)
//
// Replaces no TPU kernel: the JAX package leaves this layer to XLA
// (whisperkit_tpu/models/qwen3_tts.py, _qwen3_layers), which fuses the
// casts, norms and multiplies into the products around them. The port's
// plain version (ops/qwen3_decode.py) runs them as PyTorch ops, ~50
// kernels a layer pass, each a few microseconds of launch and none of
// bytes: at 4-8 rows of 1024 features a pass moves a few tens of KB
// outside the weights and the KV cache.
//
// What bounds them: nothing but launch latency, except the talker's
// attention, which reads its cache, 4 x 8 x ~450 keys x 128 x 2 (K, V) x 2
// bytes = 3.7 MB a layer, 1.1 us at 3.35 TB/s. The design therefore cuts
// the launches a layer pass from ~50 to 4 beside the W8A16 products, and
// splits the talker's key axis over a thread block cluster so that the
// cache read is spread over 256 blocks.
//
// Arithmetic, that of the plain version, rounding point for rounding
// point: the norms' statistics, rotary, the scores, the softmax and P.V in
// float32, each result rounded to bf16 where the plain version rounds it.
// Products and sums that the plain version takes as separate ops are
// written with __fmul_rn/__fadd_rn, so that no fused multiply-add changes
// their rounding; only the order of the float32 sums (the norms' squares,
// the dot products, the softmax's sum, P.V) differs.
//
// None allocates or synchronises: they run inside the frame's CUDA graph.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int NWARP = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// ---------------------------------------------------------------------------
// Residual add + RMSNorm: one block a row, 8 features a thread a chunk, the
// row kept in registers between the sum of squares and the scaling.

constexpr int NORM_CHUNKS = 8;
constexpr int NORM_MAX_D = NORM_CHUNKS * 8 * THREADS;  // 8192 features

__global__ void __launch_bounds__(THREADS) add_rms_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                                                               const bf16* __restrict__ g, bf16* __restrict__ s,
                                                               bf16* __restrict__ h, int d, float eps) {
  __shared__ float warp_sums[NWARP];
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * d;
  float v[NORM_CHUNKS][8];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < NORM_CHUNKS; ++c) {
    const int i = (c * THREADS + tid) * 8;
    if (i < d) {
      unpack8(*reinterpret_cast<const uint4*>(x + base + i), v[c]);
      if (y != nullptr) {  // the residual: x + y in float32, rounded once, as a bf16 add
        float yf[8];
        unpack8(*reinterpret_cast<const uint4*>(y + base + i), yf);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[c][e] = round_bf16(__fadd_rn(v[c][e], yf[e]));
        *reinterpret_cast<uint4*>(s + base + i) = pack8(v[c]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) ss = fmaf(v[c][e], v[c][e], ss);
    }
  }
  ss = warp_sum(ss);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) total += warp_sums[w];
  const float r = rsqrtf(__fadd_rn(total / (float)d, eps));
#pragma unroll
  for (int c = 0; c < NORM_CHUNKS; ++c) {
    const int i = (c * THREADS + tid) * 8;
    if (i < d) {
      float gf[8], o[8];
      unpack8(*reinterpret_cast<const uint4*>(g + i), gf);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = __fmul_rn(__fmul_rn(v[c][e], r), gf[e]);
      *reinterpret_cast<uint4*>(h + base + i) = pack8(o);
    }
  }
}

// ---------------------------------------------------------------------------
// SwiGLU: silu in float32 rounded to bf16, times up rounded again (the
// plain `F.silu(gate) * up` on bf16 tensors); one element a thread.

__global__ void __launch_bounds__(THREADS) swiglu_kernel(const bf16* __restrict__ gate, const bf16* __restrict__ up,
                                                         bf16* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float gf = __bfloat162float(gate[i]);
  const float silu = round_bf16(gf / (1.f + expf(-gf)));
  out[i] = __float2bfloat16_rn(__fmul_rn(silu, __bfloat162float(up[i])));
}

// ---------------------------------------------------------------------------
// Decode attention. One cluster of blocks per (row, KV head); the blocks of
// a cluster split the visible keys between them. A launch is a few
// microseconds of dependent steps, so each block keeps its round trips to
// device memory to two:
//
//  A. finds the visible keys: 1 + the last key that any of its T rows of
//     the additive mask leaves open (the forward's masks are causal, so the
//     rest is -inf and would add exact zeros), and takes its share of them.
//  B. copies its share of the cache's key and value rows into shared
//     memory (cp.async, all in flight at once), the new slots left out,
//     and its share of the mask's rows, and meanwhile normalises and rotates the rep query heads of its KV
//     head at each of the T positions and the T new keys (a warp a vector,
//     4 features a lane; rotary's partner feature, 64 away, is 16 lanes
//     away). The new keys and values go into its shared rows, and the first
//     block of the cluster writes them into the cache at the slot: no block
//     reads them back from the cache, so none waits for that write.
//  C. scores its keys against the nq = T x rep queries: 16 lanes a key
//     row (16 bytes a lane), 8 rows at a time, float32 dot products, times
//     1/sqrt(Dh), plus the mask.
//  D. softmax over the cluster: the blocks' maxima through distributed
//     shared memory, exp, the blocks' sums in rank order, probabilities
//     rounded to bf16.
//  E. P.V over its keys in float32, the key groups' partial sums added in
//     order in shared memory, then the cluster's partials summed in rank
//     order through distributed shared memory, each block storing a share
//     of the outputs, rounded to bf16.
//
// No atomics on the values: a graph's replays give the same bits. A
// cluster of one block (the code predictor's 17 keys) is launched as a plain
// grid, its cluster barriers block barriers.

constexpr int DH = 128;
constexpr int MAX_T = 2;
constexpr int MAX_REP = 4;
constexpr int MAX_NQ = MAX_T * MAX_REP;
constexpr int KEY_LANES = 16;                     // lanes a key row: 8 bf16 each
constexpr int KEY_GROUPS = THREADS / KEY_LANES;   // key rows a block reads at once
constexpr int MAX_CLUSTER = 8;
constexpr int KEYS_A_BLOCK = 64;  // the cluster doubles until each block holds at most this many keys
constexpr int MAX_BLOCK_KEYS = 256;  // the key and value rows a block stages: 128 KB
constexpr int MAX_KEYS = MAX_CLUSTER * MAX_BLOCK_KEYS;

struct AttnArgs {
  const bf16* q;               // [B, T, H, DH]: the q projection
  const bf16* k;               // [B, T, KVH, DH]
  const bf16* v;               // [B, T, KVH, DH]
  const bf16* qnorm;           // [DH]
  const bf16* knorm;           // [DH]
  const float* cos;            // [B, T, DH]: [cos, cos]
  const float* sin;            // [B, T, DH]: [-sin, sin]
  bf16* kc;                    // [B, KVH, S, DH]: this layer's cache, written at the slot
  bf16* vc;
  const long long* slot_ptr;   // the cache slot of position 0, on the device; or null: `slot`
  const float* mask;           // additive, element (b, t, j) at b * mask_b + t * mask_t + j, j < n_keys
  bf16* out;                   // [B, T, H, DH]
  long long mask_b, mask_t;
  int slot, t, h, kvh, s, n_keys, cap;  // cap: the most keys a block takes
  float eps, scale;
};

// the bytes of shared memory a block uses: its key and value rows (bf16),
// then in floats the queries, its max and sum a query, its P.V, the key
// groups' partial P.V, the scores, its mask rows
__host__ __device__ constexpr int attn_smem_bytes(int nq, int t, int cap) {
  return 2 * cap * DH * 2 + 4 * (MAX_NQ * DH + 2 * MAX_NQ + MAX_NQ * DH + KEY_GROUPS * nq * DH + nq * cap + t * cap);
}

// the mask scan's loads in flight at once, a thread
constexpr int SCAN_UNROLL = 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(THREADS) decode_attention_kernel(const __grid_constant__ AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_last[NWARP];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x, ranks = gridDim.x;  // the cluster spans the grid's x
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = a.t, rep = a.h / a.kvh, nq = T * rep, cap = a.cap;
  const int slot = a.slot_ptr != nullptr ? (int)*a.slot_ptr : a.slot;

  bf16* ks = reinterpret_cast<bf16*>(smem_raw);            // [cap][DH]: keys lo .. hi - 1
  bf16* vs = ks + cap * DH;                                 // [cap][DH]
  float* qs = reinterpret_cast<float*>(vs + cap * DH);      // [MAX_NQ][DH]
  float* stat = qs + MAX_NQ * DH;                           // [2][MAX_NQ]: max, sum
  float* part = stat + 2 * MAX_NQ;                          // [MAX_NQ][DH]
  float* red = part + MAX_NQ * DH;                          // [KEY_GROUPS][nq][DH]
  float* sc = red + KEY_GROUPS * nq * DH;                   // [nq][cap]
  float* ms = sc + nq * cap;                                // [T][cap]: the mask over keys lo .. hi - 1
  const bool solo = ranks == 1;
  // the cluster's barrier; a peer's shared memory
  auto cluster_sync = [&]() {
    if (solo)
      __syncthreads();
    else
      cluster.sync();
  };
  auto peer = [&](float* p, int r) { return solo ? p : cluster.map_shared_rank(p, r); };

  // A. the visible keys, and this block's share of them
  const float* mrow = a.mask + b * a.mask_b;  // this row's mask
  int last = -1;
  for (int j0 = tid; j0 < a.n_keys; j0 += SCAN_UNROLL * THREADS) {
    float m[SCAN_UNROLL][MAX_T];
#pragma unroll
    for (int u = 0; u < SCAN_UNROLL; ++u)
#pragma unroll
      for (int t = 0; t < MAX_T; ++t) {
        const int j = j0 + u * THREADS;
        m[u][t] = (t < T && j < a.n_keys) ? mrow[t * a.mask_t + j] : -INFINITY;
      }
#pragma unroll
    for (int u = 0; u < SCAN_UNROLL; ++u)
#pragma unroll
      for (int t = 0; t < MAX_T; ++t)
        if (m[u][t] > -INFINITY) last = max(last, j0 + u * THREADS);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(FULL, last, off));
  if (lane == 0) warp_last[warp] = last;
  __syncthreads();
  int n_vis = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) n_vis = max(n_vis, warp_last[w] + 1);
  const int lo = (int)((long long)rank * n_vis / ranks), hi = (int)((long long)(rank + 1) * n_vis / ranks);
  const int len = hi - lo;

  // B. the cache's rows of the share into shared memory, in flight while
  // the queries and new keys are formed
  const size_t cache0 = ((size_t)b * a.kvh + g) * a.s;  // this (row, KV head)'s first key row
  for (int i = tid; i < len * (DH / 8); i += THREADS) {
    const int j = lo + i / (DH / 8), c = i % (DH / 8);
    if (j < slot || j >= slot + T) {
      cp_async16(ks + (j - lo) * DH + 8 * c, a.kc + (cache0 + j) * DH + 8 * c);
      cp_async16(vs + (j - lo) * DH + 8 * c, a.vc + (cache0 + j) * DH + 8 * c);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = tid; i < T * len; i += THREADS) {
    const int t = i / len, jj = i % len;
    ms[t * cap + jj] = mrow[t * a.mask_t + lo + jj];
  }

  // queries and new keys: RMSNorm over the head, times the norm's weight,
  // rounded; rotary, rounded (the plain version's rope)
  const int e0 = 4 * lane;
  for (int vi = warp; vi < nq + T; vi += NWARP) {
    const bool is_q = vi < nq;
    const int t = is_q ? vi / rep : vi - nq;
    const size_t row = (size_t)b * T + t;
    const bf16* src = is_q ? a.q + (row * a.h + (size_t)g * rep + vi % rep) * DH : a.k + (row * a.kvh + g) * DH;
    const bf16* gn = is_q ? a.qnorm : a.knorm;
    const uint2 xr = *reinterpret_cast<const uint2*>(src + e0);
    const uint2 gr = *reinterpret_cast<const uint2*>(gn + e0);
    const float4 cs = *reinterpret_cast<const float4*>(a.cos + row * DH + e0);
    const float4 sn = *reinterpret_cast<const float4*>(a.sin + row * DH + e0);
    uint2 vr = make_uint2(0u, 0u);
    if (!is_q) vr = *reinterpret_cast<const uint2*>(a.v + (row * a.kvh + g) * DH + e0);
    const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
    const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
    const float2 g01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gr.x));
    const float2 g23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gr.y));
    const float x[4] = {x01.x, x01.y, x23.x, x23.y}, gw[4] = {g01.x, g01.y, g23.x, g23.y};
    const float c4[4] = {cs.x, cs.y, cs.z, cs.w}, s4[4] = {sn.x, sn.y, sn.z, sn.w};
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) ss = fmaf(x[i], x[i], ss);
    ss = warp_sum(ss);
    const float r = rsqrtf(__fadd_rn(ss / (float)DH, a.eps));
    float nrm[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) nrm[i] = round_bf16(__fmul_rn(__fmul_rn(x[i], r), gw[i]));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float other = __shfl_xor_sync(FULL, nrm[i], 16);  // feature e0 + i -/+ 64
      y[i] = round_bf16(__fadd_rn(__fmul_rn(nrm[i], c4[i]), __fmul_rn(other, s4[i])));
    }
    if (is_q) {
      *reinterpret_cast<float4*>(qs + vi * DH + e0) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      __nv_bfloat162 kk[2] = {__floats2bfloat162_rn(y[0], y[1]), __floats2bfloat162_rn(y[2], y[3])};
      const uint2 kr = *reinterpret_cast<const uint2*>(kk);
      const int j = slot + t;
      if (j >= lo && j < hi) {  // this block's row of the new key
        *reinterpret_cast<uint2*>(ks + (j - lo) * DH + e0) = kr;
        *reinterpret_cast<uint2*>(vs + (j - lo) * DH + e0) = vr;
      }
      if (rank == 0 && j >= 0 && j < a.s) {
        *reinterpret_cast<uint2*>(a.kc + (cache0 + j) * DH + e0) = kr;
        *reinterpret_cast<uint2*>(a.vc + (cache0 + j) * DH + e0) = vr;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // C. scores
  const int kg = tid / KEY_LANES, sub = tid % KEY_LANES;
  {
    float qr[MAX_NQ][8];
#pragma unroll
    for (int i = 0; i < MAX_NQ; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[i][e] = i < nq ? qs[i * DH + 8 * sub + e] : 0.f;
    for (int j0 = 0; j0 < len; j0 += KEY_GROUPS) {
      const int jj = j0 + kg;
      float kf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (jj < len) unpack8(*reinterpret_cast<const uint4*>(ks + jj * DH + 8 * sub), kf);
      float d[MAX_NQ];
#pragma unroll
      for (int i = 0; i < MAX_NQ; ++i) {
        d[i] = 0.f;
        if (i < nq) {  // the same for the whole block
#pragma unroll
          for (int e = 0; e < 8; ++e) d[i] = fmaf(qr[i][e], kf[e], d[i]);
#pragma unroll
          for (int off = KEY_LANES / 2; off > 0; off >>= 1) d[i] += __shfl_xor_sync(FULL, d[i], off);
        }
      }
#pragma unroll
      for (int i = 0; i < MAX_NQ; ++i)
        if (i < nq && sub == i && jj < len)
          sc[i * cap + jj] = __fadd_rn(__fmul_rn(d[i], a.scale), ms[(i / rep) * cap + jj]);
    }
  }
  __syncthreads();

  // D. the softmax over the cluster's keys
  for (int i = warp; i < nq; i += NWARP) {
    float m = -INFINITY;
    for (int j = lane; j < len; j += 32) m = fmaxf(m, sc[i * cap + j]);
    m = warp_max(m);
    if (lane == 0) stat[i] = m;
  }
  cluster_sync();  // every block's maxima
  for (int i = warp; i < nq; i += NWARP) {
    float mx = -INFINITY;
    for (int r = 0; r < ranks; ++r) mx = fmaxf(mx, *peer(stat + i, r));
    float sum = 0.f;
    for (int j = lane; j < len; j += 32) {
      const float e = expf(sc[i * cap + j] - mx);
      sc[i * cap + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) stat[MAX_NQ + i] = sum;
  }
  cluster_sync();  // every block's sums
  for (int i = warp; i < nq; i += NWARP) {
    float total = 0.f;
    for (int r = 0; r < ranks; ++r) total += *peer(stat + MAX_NQ + i, r);
    for (int j = lane; j < len; j += 32) sc[i * cap + j] = round_bf16(sc[i * cap + j] / total);
  }
  __syncthreads();

  // E. P.V
  {
    float acc[MAX_NQ][8];
#pragma unroll
    for (int i = 0; i < MAX_NQ; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
    for (int jj = kg; jj < len; jj += KEY_GROUPS) {
      float vf[8];
      unpack8(*reinterpret_cast<const uint4*>(vs + jj * DH + 8 * sub), vf);
#pragma unroll
      for (int i = 0; i < MAX_NQ; ++i) {
        if (i < nq) {
          const float p = sc[i * cap + jj];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(p, vf[e], acc[i][e]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAX_NQ; ++i) {
      if (i < nq) {
        float* dst = red + (kg * nq + i) * DH + 8 * sub;
        *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nq * DH; idx += THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < KEY_GROUPS; ++k2) sum += red[k2 * nq * DH + idx];
    part[idx] = sum;
  }
  cluster_sync();  // every block's partial P.V
  const int n_out = nq * DH, o_lo = rank * n_out / ranks, o_hi = (rank + 1) * n_out / ranks;
  for (int idx = o_lo + tid; idx < o_hi; idx += THREADS) {
    float v[MAX_CLUSTER];  // every rank's load in flight at once
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < ranks) v[r] = *peer(part + idx, r);
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < ranks) sum += v[r];
    const int i = idx / DH, e = idx % DH, t = i / rep;
    a.out[(((size_t)b * T + t) * a.h + (size_t)g * rep + i % rep) * DH + e] = __float2bfloat16_rn(sum);
  }
  if (!solo) cluster.sync();  // the peers have read this block's shared memory
}

bool aligned16(const void* p) { return ((uintptr_t)p % 16) == 0; }

}  // namespace

// x, y, s, h [rows, d] bf16, g [d] bf16, contiguous, 16-byte aligned; y
// null: h = norm(x) and s is not written. d a multiple of 8, at most 8192.
extern "C" int wk_qwen3_add_rms_norm(const void* x, const void* y, const void* g, void* s, void* h, int rows, int d,
                                     float eps, void* stream) {
  if (rows < 1 || d < 8 || d % 8 || d > NORM_MAX_D || !aligned16(x) || !aligned16(y) || !aligned16(g) ||
      !aligned16(s) || !aligned16(h) || (y != nullptr && s == nullptr))
    return (int)cudaErrorInvalidValue;
  add_rms_norm_kernel<<<rows, THREADS, 0, (cudaStream_t)stream>>>((const bf16*)x, (const bf16*)y, (const bf16*)g,
                                                                   (bf16*)s, (bf16*)h, d, eps);
  return (int)cudaGetLastError();
}

// gate, up, out [n] bf16, contiguous.
extern "C" int wk_qwen3_swiglu(const void* gate, const void* up, void* out, long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swiglu_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>((const bf16*)gate, (const bf16*)up,
                                                                         (bf16*)out, n);
  return (int)cudaGetLastError();
}

// q [B, T, H, 128], k, v [B, T, KVH, 128], qnorm, knorm [128], kc, vc [B,
// KVH, S, 128], out [B, T, H, 128] bf16; cos, sin [B, T, 128] float32; all
// contiguous and 16-byte aligned. The slot of position 0: *slot_ptr (int64
// on the device) when slot_ptr is not null, else `slot`. mask float32,
// element (b, t, j) at b * mask_b + t * mask_t + j for j < n_keys <= S.
// 1 <= T <= 2, H a multiple of KVH, H / KVH <= 4, n_keys <= 2048.
extern "C" int wk_qwen3_decode_attention(const void* q, const void* k, const void* v, const void* qnorm,
                                         const void* knorm, const void* cos, const void* sin, void* kc, void* vc,
                                         const void* slot_ptr, int slot, const void* mask, long long mask_b,
                                         long long mask_t, void* out, int batch, int t, int h, int kvh, int s,
                                         int n_keys, float eps, float scale, void* stream) {
  if (batch < 1 || t < 1 || t > MAX_T || kvh < 1 || h % kvh || h / kvh > MAX_REP || n_keys < 1 || n_keys > s ||
      n_keys > MAX_KEYS || mask == nullptr)
    return (int)cudaErrorInvalidValue;
  const void* vec[] = {q, k, v, qnorm, knorm, cos, sin, kc, vc, out};
  for (const void* p : vec)
    if (p == nullptr || !aligned16(p)) return (int)cudaErrorInvalidValue;
  int ranks = 1;
  while (ranks < MAX_CLUSTER && ranks * KEYS_A_BLOCK < n_keys) ranks *= 2;
  AttnArgs args{};
  args.q = (const bf16*)q;
  args.k = (const bf16*)k;
  args.v = (const bf16*)v;
  args.qnorm = (const bf16*)qnorm;
  args.knorm = (const bf16*)knorm;
  args.cos = (const float*)cos;
  args.sin = (const float*)sin;
  args.kc = (bf16*)kc;
  args.vc = (bf16*)vc;
  args.slot_ptr = (const long long*)slot_ptr;
  args.mask = (const float*)mask;
  args.out = (bf16*)out;
  args.mask_b = mask_b;
  args.mask_t = mask_t;
  args.slot = slot;
  args.t = t;
  args.h = h;
  args.kvh = kvh;
  args.s = s;
  args.n_keys = n_keys;
  args.cap = (n_keys + ranks - 1) / ranks;
  args.eps = eps;
  args.scale = scale;
  const int smem = attn_smem_bytes(t * (h / kvh), t, args.cap);
  // set on each call, on the current device: the shared memory above the default 48 KB
  cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ranks, (unsigned)kvh, (unsigned)batch);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, decode_attention_kernel, args);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
