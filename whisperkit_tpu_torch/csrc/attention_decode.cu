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
// K3 (simple and right first): one block of 256 threads per (batch, head,
// query row); B x H = 640 blocks over 132 SMs. Pass 1: each thread takes
// whole key rows (one 64-wide row is 64 B of int8, read with 16-byte loads)
// and writes its score to shared memory. The softmax runs over the shared
// scores with block reductions. Pass 2: the threads split the key axis
// into groups and each lane owns a slice of the 64 channels, so a warp
// reads whole contiguous rows of V; the groups' partial sums meet in shared
// memory. K and V are each read exactly once.
//
// K3's probs form (word timestamps) is the same kernel, which also writes
// the f32 softmax it forms for the rows of the heads a head-to-slot map
// names: see its section below.
//
// K4 splits each row's key axis among the block's warps and stages V in
// shared memory: see its section below. K5 keeps one softmax per row and
// has its K and V rows, up to the last visible key, copied into shared
// memory by the Tensor Memory Accelerator (cp.async.bulk on mbarriers) at
// the block's start, so V lands while the scores and the softmax are
// formed: see its section below.

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
//
// The probs form (PROBS = true, word timestamps): the block of (b, h, t)
// also stores its f32 `probs` row, as the softmax pass forms it, to
// probs + b * sb + slot[h] * sa + t * st when slot[h] >= 0 (the alignment
// buffer's layout, written in place). The store takes the value the pass
// already holds in a register, beside its shared-memory write, so nothing
// else in the block changes: the int8 output is bit for bit the plain
// form's. It adds at most S * 4 bytes of writes to a row's 2 * S * 64 bytes
// of int8 K/V reads (+3% for every head of a layer, +0.3% for one head).
// ---------------------------------------------------------------------------
constexpr int MAX_HEADS = 64;

struct HeadSlots {  // slot of each head in the probs output, -1 for none
  signed char slot[MAX_HEADS];
};

struct ProbsOut {
  float* probs;
  long long sb, sa, st;  // strides (floats) of batch, slot and query row
  int n_head;
  HeadSlots heads;
};

template <bool PROBS>
__global__ void __launch_bounds__(NT)
cross_attend_q8_kernel(const int8_t* __restrict__ qi,     // [BH, T, DH]
                       const float* __restrict__ q_scale,  // [BH, T]
                       const int8_t* __restrict__ k,       // [BH, S, DH]
                       const int8_t* __restrict__ v,       // [BH, S, DH]
                       const float* __restrict__ v_scale,  // [BH, DH]
                       float* __restrict__ out,            // [BH, T, DH]
                       int T, int S, const __grid_constant__ ProbsOut po) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);                  // S scores / probs
  signed char* pq = reinterpret_cast<signed char*>(sc + S);    // S int8 probs
  __shared__ int qw[DH / 4];
  __shared__ float red[NWARP];
  __shared__ int vred[NT / 16][DH];

  __shared__ int slot_s;  // the probs form: this row's slot, -1 for none

  const int tid = threadIdx.x;
  const long bh = blockIdx.x;
  const long row = bh * T + blockIdx.y;

  if (tid < DH / 4) qw[tid] = reinterpret_cast<const int*>(qi + row * DH)[tid];
  // the head's slot, read by one thread of the second warp straight from
  // the parameter bank: `__grid_constant__` lets the index be computed at
  // run time without a copy of the struct on every thread's stack, and one
  // reader keeps the registers of the other threads as the plain form's
  // (either copy measured 20-27% slower on the H100)
  if (PROBS && tid == 32) slot_s = po.heads.slot[bh % po.n_head];
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

  float* prow = nullptr;  // this row's probs, when its head has a slot
  if (PROBS && slot_s >= 0)
    prow = po.probs + (bh / po.n_head) * po.sb + slot_s * po.sa + blockIdx.y * po.st;
  float lpmax = 0.f;
  for (int s = tid; s < S; s += NT) {
    const float p = sc[s] / sum;
    sc[s] = p;
    if (PROBS && prow) prow[s] = p;  // coalesced: thread s, float s
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
// Self-attention over the raw cache (K4): one block of SPLIT_NW warps per
// (batch, head) row, the key axis split among the warps.
//
// What bounds it: device-memory bandwidth, and at these sizes the chain of
// latencies before it. At S = 224 a row is 57 KB of bf16 K/V; a launch
// moves 36.7 MB over 640 rows, 11 us at 3.35 TB/s. So the design keeps few
// round trips to device memory on the path and all 640 rows resident in one
// wave (5 blocks per SM on 132 SMs: under 45 KB of shared memory and 48
// registers a thread):
//
//   1. The mask row goes to shared memory and the block learns n, one past
//      the last visible key (one barrier). Keys past n are never read, nor
//      any masked key inside [0, n): the mask is any additive row.
//   2. [0, n) splits into SPLIT_NW contiguous chunks of a multiple of 4
//      keys, the last ragged (ops/attention_decode.py::split_chunks); warp w
//      owns chunk w.
//   3. K is read straight into registers, whole rows coalesced: a 128-B bf16
//      row is 8 lanes x 16 B, 4 rows per warp load, 4 loads in flight a
//      lane; the dot is reduced across the row's 8 lanes with shuffles.
//   4. As soon as its scores are in, each warp requests its visible V rows
//      into shared memory with cp.async (the whole chunk at once), and they
//      arrive while it takes its max m_w and sum l_w of exp(x - m_w).
//      Requesting V at the block's start instead, beside K, measured slower
//      on the H100: the K loads, which the scores wait for, then queue
//      behind V.
//   5. Each warp forms its unnormalised partial P.V from the staged rows;
//      one barrier merges the warps' (m_w, l_w, partial) with the weights
//      exp(m_w - m), and the output is divided by the row's sum at the end.
// ---------------------------------------------------------------------------
constexpr int SPLIT_NW = 8;  // warps per block: attention_decode.SPLIT_WARPS
constexpr int SNT = SPLIT_NW * 32;
constexpr int MAX_SELF_KEYS = 512;  // attention_decode.MAX_SELF_KEYS

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Steps 1 and 2: copy the mask row to `msk`, return this warp's chunk
// [c0, c1) (empty when c1 <= c0).
__device__ __forceinline__ int2 split_chunk(const float* __restrict__ mask, float* msk, int* warp_hi, int S) {
  const int tid = threadIdx.x;
  int hi = 0;
  for (int s = tid; s < S; s += SNT) {
    const float m = mask[s];
    msk[s] = m;
    if (m != -INFINITY) hi = s + 1;
  }
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((tid & 31) == 0) warp_hi[tid >> 5] = hi;
  __syncthreads();
  int n = 0;
#pragma unroll
  for (int i = 0; i < SPLIT_NW; ++i) n = max(n, warp_hi[i]);
  const int size = 4 * ((n + 4 * SPLIT_NW - 1) / (4 * SPLIT_NW));
  const int c0 = (tid >> 5) * size;
  return make_int2(c0, min(n, c0 + size));
}

// One key row's 8 channels of one lane (16 B of bf16, 32 B of f32)
template <typename T> struct KRow;
template <> struct KRow<__nv_bfloat16> {
  static constexpr int BATCH = 4;  // row loads in flight per lane
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { u = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ float dot(const float* qv) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc = fmaf(qv[2 * i], f.x, acc);
      acc = fmaf(qv[2 * i + 1], f.y, acc);
    }
    return acc;
  }
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};
template <> struct KRow<float> {
  static constexpr int BATCH = 2;
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ float dot(const float* qv) const {
    float acc = 0.f;
    acc = fmaf(qv[0], a.x, acc); acc = fmaf(qv[1], a.y, acc);
    acc = fmaf(qv[2], a.z, acc); acc = fmaf(qv[3], a.w, acc);
    acc = fmaf(qv[4], b.x, acc); acc = fmaf(qv[5], b.y, acc);
    acc = fmaf(qv[6], b.z, acc); acc = fmaf(qv[7], b.w, acc);
    return acc;
  }
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

// ---------------------------------------------------------------------------
// K4: self-attention over the raw cache. Same math as the JAX kernel
// (_self_decode_kernel):
//   scores = q . k + mask     f32 (q arrives scaled by dh^-0.5)
//   out = softmax(scores) . v f32
// in the split form: out = sum_w e^(m_w - m) P_w.V_w / sum_w e^(m_w - m) l_w.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(SNT, 5)
self_attend_kernel(const float* __restrict__ q,     // [BH, DH]
                   const T* __restrict__ k,         // [BH, S, DH]
                   const T* __restrict__ v,         // [BH, S, DH]
                   const float* __restrict__ mask,  // [S]
                   float* __restrict__ out,         // [BH, DH]
                   int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* vst = reinterpret_cast<T*>(smem);                          // [S, DH] staged V rows
  float* sc = reinterpret_cast<float*>(vst + (size_t)S * DH);  // [S] scores, then exps
  float* msk = sc + S;                                          // [S] the mask row
  __shared__ int warp_hi[SPLIT_NW];
  __shared__ float red_m[SPLIT_NW], red_l[SPLIT_NW];
  __shared__ float red_o[SPLIT_NW][DH];

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long bh = blockIdx.x;
  const int2 chunk = split_chunk(mask, msk, warp_hi, S);
  const int c0 = chunk.x, c1 = chunk.y;

  // step 3: lane group g (8 lanes) scores rows c0 + g, c0 + g + 4, ...;
  // lane `sub` of the group owns channels 8 sub .. 8 sub + 7
  const int g = lane >> 3, sub = lane & 7;
  float qv[8];
  {
    const float4 a = reinterpret_cast<const float4*>(q + bh * DH + 8 * sub)[0];
    const float4 b = reinterpret_cast<const float4*>(q + bh * DH + 8 * sub)[1];
    qv[0] = a.x; qv[1] = a.y; qv[2] = a.z; qv[3] = a.w;
    qv[4] = b.x; qv[5] = b.y; qv[6] = b.z; qv[7] = b.w;
  }
  constexpr int BATCH = KRow<T>::BATCH;
  const T* kb = k + bh * S * DH + 8 * sub;
  float m_w = -INFINITY;
  for (int r0 = c0; r0 < c1; r0 += 4 * BATCH) {
    KRow<T> rows[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int r = r0 + 4 * j + g;
      if (r < c1 && msk[r] != -INFINITY) rows[j].load(kb + (long)r * DH);
      else rows[j].zero();
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int r = r0 + 4 * j + g;
      float acc = rows[j].dot(qv);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      if (r < c1) {
        const float x = msk[r] != -INFINITY ? acc + msk[r] : -INFINITY;
        if (sub == 0) sc[r] = x;
        m_w = fmaxf(m_w, x);
      }
    }
  }
  // step 4: this warp's visible V rows, 16-byte pieces
  constexpr int PIECE = 16 / sizeof(T), PIECES = DH / PIECE;
  const T* vb = v + bh * S * DH;
  for (int i = lane; i < (c1 - c0) * PIECES; i += 32) {
    const int r = c0 + i / PIECES, off = r * DH + (i % PIECES) * PIECE;
    if (msk[r] != -INFINITY) cp_async16(vst + off, vb + off);
  }
  m_w = warp_max(m_w);
  __syncwarp();

  // exps and their sum over the chunk (0 for masked keys)
  float l_w = 0.f;
  for (int r = c0 + lane; r < c1; r += 32) {
    const float e = m_w == -INFINITY ? 0.f : expf(sc[r] - m_w);
    sc[r] = e;
    l_w += e;
  }
  l_w = warp_sum(l_w);
  cp_async_wait_all();
  __syncwarp();

  // step 5: the warp's partial P.V from the staged rows; lane owns channels
  // 2 lane, 2 lane + 1; a zero probability (every masked key) adds nothing,
  // and its row was not staged
  float o0 = 0.f, o1 = 0.f;
  for (int r = c0; r < c1; ++r) {
    const float p = sc[r];
    if (p == 0.f) continue;  // warp-uniform
    const float2 vv = KRow<T>::load2(vst + r * DH + 2 * lane);
    o0 = fmaf(p, vv.x, o0);
    o1 = fmaf(p, vv.y, o1);
  }
  if (lane == 0) {
    red_m[w] = m_w;
    red_l[w] = l_w;
  }
  red_o[w][2 * lane] = o0;
  red_o[w][2 * lane + 1] = o1;
  __syncthreads();
  if (tid < DH) {
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < SPLIT_NW; ++i) m = fmaxf(m, red_m[i]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int i = 0; i < SPLIT_NW; ++i) {
      const float c = red_m[i] == -INFINITY ? 0.f : expf(red_m[i] - m);
      l = fmaf(c, red_l[i], l);
      o = fmaf(c, red_o[i][tid], o);
    }
    out[bh * DH + tid] = o / l;  // no visible key: 0 / 0, as the softmax of all -inf
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
// One block of NT threads per (batch, head) row.
//
// What bounds it: at the main path's sizes, the chain of latencies. A row
// is 2 · 224 · 64 B of int8 K/V and 2 · 224 · 4 B of scales; a launch at
// B = 32 moves 19.5 MB, 5.9 us at 3.35 TB/s with every key visible, half
// that at S/2. One p_scale for the whole row means no P.V work can start
// before the row's softmax is done, so splitting the keys among warps (as
// K4 does) shortens loops but not the chain. What shortens it is taking
// the V round trip off it:
//
//   1. Warp 0 reads the mask row and finds n, one past the last visible
//      key; its lane 0 at once asks the Tensor Memory Accelerator for two
//      bulk copies into shared memory, K rows [0, n) and V rows [0, n)
//      (cp.async.bulk, n · 64 B each), each completing on its own mbarrier.
//      Keys past n are never read.
//   2. Meanwhile every thread reads the mask entries of its keys (thread t
//      owns keys t and t + NT) and, for the visible ones only, their K and V
//      scales with plain loads: a scale row starts at bh · S · 4 bytes, not
//      16-byte aligned for every S, and a masked key's scale (0 or NaN in an
//      unwritten row) is never read, so 0 · -inf is never formed.
//   3. Once K has landed: the scores from shared memory with __dp4a (the
//      16-byte chunks of a row taken in a rotated order, free of bank
//      conflicts), then the softmax, the weighted probabilities and their
//      requantization in the order of operations of the form this one
//      replaced: the output is bit for bit the same. Each block reduction
//      has a buffer of its own, so it takes one barrier.
//   4. V has landed meanwhile: P.V from shared memory in int32 (exact in any
//      order); the two 16-lane groups of a warp meet by a shuffle, the warps
//      in shared memory.
//
// Shared memory: 2 · S · 64 + S bytes, 28.9 KB at S = 224 (5 blocks on an
// SM, all 640 rows of B = 32 resident at once), 66 KB at MAX_SELF_KEYS.
// On the H100 (chip_smoke.py phase 3, B = 32, S = 224, by device time):
// 0.0057 ms with the mask open to S/2 and 0.0096 ms to S - 1, 52% and 61%
// of the bandwidth bound, against 0.0075 and 0.0107 ms for the form this
// one replaced (K3's layout: the K rows, then the scales, then the V rows
// after the softmax, each a round trip of its own). Inside the int8 decode
// step's graph (tools/profile_step.py, positions 192-223) it takes
// 0.0100-0.0111 ms (0.0110 at S - 1, against 0.0096 back to back): each
// layer's cache comes cold. Forms with 128 or 64 threads, with K read
// straight into registers, with every scale read whatever the mask, or
// with an L2 prefetch of the first rows before the mask is read measured
// no faster.
// ---------------------------------------------------------------------------
constexpr int Q8_KPT = MAX_SELF_KEYS / NT;  // keys a thread owns: t, t + NT, ...

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// make the barriers' initialisation visible to the copy engine
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once, and expect `bytes` more to land before the phase completes
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// block_max / block_sum over a `red` no other reduction uses: one barrier
__device__ __forceinline__ float block_max_once(float x, float* red) {
  x = warp_max(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = (threadIdx.x & 31) < NWARP ? red[threadIdx.x & 31] : -INFINITY;
  return warp_max(x);
}

__device__ __forceinline__ float block_sum_once(float x, float* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = (threadIdx.x & 31) < NWARP ? red[threadIdx.x & 31] : 0.f;
  return warp_sum(x);
}

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
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* kst = reinterpret_cast<int8_t*>(smem);                         // [S, DH] staged K rows
  int8_t* vst = kst + (size_t)S * DH;                                    // [S, DH] staged V rows
  signed char* pq = reinterpret_cast<signed char*>(vst + (size_t)S * DH);  // [S] int8 probs
  __shared__ __align__(8) uint64_t landed[2];  // K rows, V rows
  __shared__ __align__(16) int qw[DH / 4];
  __shared__ int n_s;
  __shared__ float red[3][NWARP];
  __shared__ int vred[NWARP][DH];

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long bh = blockIdx.x;

  // step 1
  if (w == 0) {
    int hi = 0;
#pragma unroll
    for (int i = 0; i < MAX_SELF_KEYS / 32; ++i) {
      const int s = lane + 32 * i;
      if (s < S && mask[s] != -INFINITY) hi = s + 1;
    }
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      n_s = hi;
      mbar_init(&landed[0]);
      mbar_init(&landed[1]);
      mbar_init_fence();
      const uint32_t bytes = (uint32_t)hi * DH;
      mbar_arrive_expect(&landed[0], bytes);
      mbar_arrive_expect(&landed[1], bytes);
      if (bytes) {
        bulk_copy(kst, k + bh * S * DH, bytes, &landed[0]);
        bulk_copy(vst, v + bh * S * DH, bytes, &landed[1]);
      }
    }
  } else if (w == 1 && lane < DH / 4) {
    qw[lane] = reinterpret_cast<const int*>(qi + bh * DH)[lane];
  }

  // step 2
  const float qs = q_scale[bh];
  const float* ksb = k_scale + bh * S;
  const float* vsb = v_scale + bh * S;
  float mk[Q8_KPT], ks[Q8_KPT], vs[Q8_KPT];
#pragma unroll
  for (int i = 0; i < Q8_KPT; ++i) {
    const int s = tid + NT * i;
    mk[i] = s < S ? mask[s] : -INFINITY;
    ks[i] = vs[i] = 0.f;
    if (mk[i] != -INFINITY) {
      ks[i] = ksb[s];
      vs[i] = vsb[s];
    }
  }
  __syncthreads();  // n, qw and the barriers
  const int n = n_s;

  // step 3
  mbar_wait(&landed[0], 0);
  const int rot = (lane >> 1) & 3;  // lanes 2j, 2j + 1 start at chunk j mod 4
  const int4* q4 = reinterpret_cast<const int4*>(qw);
  float x[Q8_KPT];
  float lmax = -INFINITY;
#pragma unroll
  for (int i = 0; i < Q8_KPT; ++i) {
    const int s = tid + NT * i;
    x[i] = -INFINITY;
    if (mk[i] != -INFINITY) {
      const int4* kr = reinterpret_cast<const int4*>(kst + s * DH);
      int acc = 0;
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) {
        const int cc = (c + rot) & 3;
        const int4 kv = kr[cc], qv = q4[cc];
        acc = __dp4a(kv.x, qv.x, acc);
        acc = __dp4a(kv.y, qv.y, acc);
        acc = __dp4a(kv.z, qv.z, acc);
        acc = __dp4a(kv.w, qv.w, acc);
      }
      x[i] = (float)acc * qs * ks[i] + mk[i];
    }
    lmax = fmaxf(lmax, x[i]);
  }
  const float mx = block_max_once(lmax, red[0]);

  float e[Q8_KPT];
  float lsum = 0.f;
#pragma unroll
  for (int i = 0; i < Q8_KPT; ++i) {
    e[i] = expf(x[i] - mx);
    lsum += e[i];
  }
  const float sum = block_sum_once(lsum, red[1]);

  float pw[Q8_KPT];
  float lpmax = 0.f;
#pragma unroll
  for (int i = 0; i < Q8_KPT; ++i) {
    pw[i] = e[i] > 0.f ? (e[i] / sum) * vs[i] : 0.f;  // masked keys: no scale read
    lpmax = fmaxf(lpmax, pw[i]);
  }
  const float p_scale = fmaxf(block_max_once(lpmax, red[2]) / 127.f, 1e-8f);
#pragma unroll
  for (int i = 0; i < Q8_KPT; ++i) {
    const int s = tid + NT * i;
    if (s < n) pq[s] = (signed char)(int)fminf(fmaxf(rintf(pw[i] / p_scale), 0.f), 127.f);
  }
  __syncthreads();

  // step 4: 16 groups over the key axis, lane l of a group owns channels
  // 4l .. 4l+3, so a warp reads two whole rows
  mbar_wait(&landed[1], 0);
  const int g = tid >> 4, l = tid & 15;
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  for (int s = g; s < n; s += NT / 16) {
    const int p = pq[s];
    const char4 vv = reinterpret_cast<const char4*>(vst + s * DH)[l];
    a0 += p * vv.x;
    a1 += p * vv.y;
    a2 += p * vv.z;
    a3 += p * vv.w;
  }
  a0 += __shfl_xor_sync(0xffffffffu, a0, 16);
  a1 += __shfl_xor_sync(0xffffffffu, a1, 16);
  a2 += __shfl_xor_sync(0xffffffffu, a2, 16);
  a3 += __shfl_xor_sync(0xffffffffu, a3, 16);
  if (lane < 16) {
    vred[w][4 * l + 0] = a0;
    vred[w][4 * l + 1] = a1;
    vred[w][4 * l + 2] = a2;
    vred[w][4 * l + 3] = a3;
  }
  __syncthreads();
  if (tid < DH) {
    int tot = 0;
#pragma unroll
    for (int i = 0; i < NWARP; ++i) tot += vred[i][tid];
    out[bh * DH + tid] = (float)tot * p_scale;
  }
}

size_t aligned16(size_t n) { return (n + 15) & ~size_t(15); }

}  // namespace

template <bool PROBS>
static int launch_cross_attend_q8(const void* qi, const void* q_scale, const void* k, const void* v,
                                  const void* v_scale, void* out, int bh, int t, int s,
                                  const ProbsOut& po, cudaStream_t st) {
  if (bh <= 0 || t <= 0 || s <= 0 || t > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = aligned16((size_t)s * (sizeof(float) + 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cross_attend_q8_kernel<PROBS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cross_attend_q8_kernel<PROBS><<<dim3(bh, t), NT, smem, st>>>(
      (const int8_t*)qi, (const float*)q_scale, (const int8_t*)k, (const int8_t*)v,
      (const float*)v_scale, (float*)out, t, s, po);
  return (int)cudaGetLastError();
}

extern "C" int wk_cross_attend_q8(const void* qi, const void* q_scale, const void* k,
                                  const void* v, const void* v_scale, void* out,
                                  int bh, int t, int s, void* stream) {
  return launch_cross_attend_q8<false>(qi, q_scale, k, v, v_scale, out, bh, t, s, ProbsOut{},
                                       (cudaStream_t)stream);
}

// K3's probs form: `head_slot` (host memory, n_head entries) holds each
// head's slot in `probs`, -1 for a head whose probabilities are not kept;
// `strides` (host memory) the strides of batch, slot and query row in floats.
extern "C" int wk_cross_attend_q8_probs(const void* qi, const void* q_scale, const void* k,
                                        const void* v, const void* v_scale, void* out,
                                        int bh, int t, int s, void* probs, int n_head,
                                        const signed char* head_slot, const long long* strides,
                                        void* stream) {
  if (probs == nullptr || n_head <= 0 || n_head > MAX_HEADS || bh % n_head)
    return (int)cudaErrorInvalidValue;
  ProbsOut po{(float*)probs, strides[0], strides[1], strides[2], n_head, {}};
  for (int h = 0; h < MAX_HEADS; ++h) po.heads.slot[h] = h < n_head ? head_slot[h] : -1;
  return launch_cross_attend_q8<true>(qi, q_scale, k, v, v_scale, out, bh, t, s, po,
                                      (cudaStream_t)stream);
}

// Allow `smem` bytes of dynamic shared memory, and ask for the smallest
// shared-memory carveout that holds 5 such blocks on an SM: the rest of the
// SM's 256 KB stays L1, which holds the K rows in flight to registers. Once
// per kernel and size: `*done` holds the largest size set so far.
template <typename Kernel>
static cudaError_t configure(Kernel kernel, size_t smem, size_t* done) {
  if (smem <= *done) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) {
    const size_t max_shared = 228 * 1024, per_block = smem + attr.sharedSizeBytes + 1024;
    const size_t percent = (5 * per_block * 100 + max_shared - 1) / max_shared;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             percent < 100 ? (int)percent : 100);
  }
  if (e == cudaSuccess) *done = smem;
  return e;
}

template <typename T>
static int launch_self_attend(const void* q, const void* k, const void* v, const void* mask, void* out,
                       int bh, int s, cudaStream_t st) {
  static size_t done = 0;
  // staged V rows, the scores and the mask row
  const size_t smem = (size_t)s * DH * sizeof(T) + 2 * (size_t)s * sizeof(float);
  cudaError_t e = configure(self_attend_kernel<T>, smem, &done);
  if (e != cudaSuccess) return (int)e;
  self_attend_kernel<T><<<bh, SNT, smem, st>>>((const float*)q, (const T*)k, (const T*)v,
                                                (const float*)mask, (float*)out, s);
  return (int)cudaGetLastError();
}

extern "C" int wk_self_attend(const void* q, const void* k, const void* v,
                              const void* mask, void* out, int bh, int s, int is_bf16,
                              void* stream) {
  if (bh <= 0 || s <= 0 || s > MAX_SELF_KEYS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_self_attend<__nv_bfloat16>(q, k, v, mask, out, bh, s, st)
                 : launch_self_attend<float>(q, k, v, mask, out, bh, s, st);
}

extern "C" int wk_self_attend_q8(const void* qi, const void* q_scale, const void* k,
                                 const void* k_scale, const void* v, const void* v_scale,
                                 const void* mask, void* out, int bh, int s, void* stream) {
  if (bh <= 0 || s <= 0 || s > MAX_SELF_KEYS) return (int)cudaErrorInvalidValue;
  // the bulk copies need 16-byte aligned rows: the wrapper checks k and v
  if (((uintptr_t)k | (uintptr_t)v) % 16) return (int)cudaErrorMisalignedAddress;
  static size_t done = 0;
  // staged K and V rows, the int8 probabilities
  const size_t smem = aligned16(2 * (size_t)s * DH + s);
  cudaError_t e = configure(self_attend_q8_kernel, smem, &done);
  if (e != cudaSuccess) return (int)e;
  self_attend_q8_kernel<<<bh, NT, smem, (cudaStream_t)stream>>>(
      (const int8_t*)qi, (const float*)q_scale, (const int8_t*)k, (const float*)k_scale,
      (const int8_t*)v, (const float*)v_scale, (const float*)mask, (float*)out, s);
  return (int)cudaGetLastError();
}
