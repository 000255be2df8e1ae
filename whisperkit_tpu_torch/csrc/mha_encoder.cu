// Non-causal multi-head attention for the Whisper encoder, Hopper (sm_90a).
//
// Replaces the TPU kernel whisperkit_tpu/ops/attention.py::mha_encoder_pallas
// (_mha_kernel). Same function and the same rounding points: q is scaled
// by dh^-0.5 and rounded to q's type before the score dot; scores and the
// softmax are float32; the (unnormalised) probability is rounded to v's
// type before the PV product; the output is rounded to q's type. Head dim
// 64. q is [B, H, SQ, 64] and k/v [B, H, SK, 64], each with a contiguous
// last dimension and any strides for B, H and the rows (the head-split
// views of the q/k/v projections; bf16: bases and strides multiples of 16
// bytes, as TMA requires); SQ = SK = 1500 in the encoder, SQ < SK in its
// sequence-parallel mode (each rank's own query rows over all the keys).
// The work tiles cover the query rows, the key loop and its masking the
// key rows. The output is written in the [B, SQ, H, 64] layout, so that
// merging the heads back is a view.
//
// What bounds it: arithmetic, twice over. At the encoder's shape (S = 1500,
// Dh = 64) one (batch, head) is 4 x 1500^2 x 64 = 0.58 GFLOP against 0.77 MB
// of bf16 Q/K/V/O traffic, about 750 FLOP per byte; the tensor-core bound
// at B = 32, H = 20 is 368.6 GFLOP / 989 TFLOP/s = 0.373 ms. At Dh = 64 the
// softmax's 1.44e9 exp evaluations (B = 32) take about as long on the
// special function units (16 per SM per clock: 1.44e9 / (132 x 16 x
// 1.83 GHz) = 0.37 ms) as the products on the tensor cores, and the FP32
// work around each exp (scale, max, sum, bf16 pack) comes on top. A kernel
// that runs the two one after the other cannot pass half the bound.
//
// bf16: the FlashAttention-3 form, three warpgroups a block (one per SM:
// a persistent grid, each block walking work tiles of BM = 128 query rows
// of one (b, h), i, i + gridDim.x, ...):
//
//   * a producer warpgroup, its registers lowered to 24 (setmaxnreg.dec),
//     in which one thread issues every load through the Tensor Memory
//     Accelerator: each tile's Q (128 rows), then its K and V tiles of
//     BN = 128 keys through a ring of STAGES = 2 buffers, each with a full
//     and an empty mbarrier per tensor (Q has its own pair, so that the
//     next tile's Q lands while the consumers finish the current one). The
//     three tensor maps (4-D over the strided view: dims {64, S, H, B},
//     byte strides {s, h, b}, box {64, rows, 1, 1}, 128-byte swizzle) are
//     encoded on the host for every call and passed as __grid_constant__
//     parameters; TMA fills rows past SQ or SK with zeros (keys past SK are
//     still masked to -inf: the zero fill is not the mask) and query rows
//     past SQ are never stored;
//   * two consumer warpgroups, registers raised to 240 (setmaxnreg.inc),
//     each owning 64 of the tile's query rows. S = Q K^T is wgmma
//     m64n128k16 with Q and the K tile both read from shared memory,
//     K-major, through 128B-swizzle descriptors. q's scale dh^-0.5 = 2^-3
//     is a power of two, so q scaled and rounded to bf16 is q times the
//     scale exactly, and so is every partial sum of the score dot: the
//     scale is applied in f32 in the exponent's factor, the same numbers
//     as scaling q first (the launcher refuses a scale that is not a power
//     of two). O += P V is wgmma m64n64k16 with P packed to bf16 in
//     registers (the score accumulator's fragments are the A fragments, no
//     trip through shared memory) and the V tile read MN-major (the
//     transpose bit). A stage goes back to the producer only after the
//     wgmma that read it has completed (wgmma.wait_group).
//
// What the design does about each bound: the tensor cores are fed by
// wgmma, the only path to their full rate, from tiles that TMA lands
// without a register or an instruction of the consumers. The exp work is
// overlapped with the products twice: within a warpgroup, tile t's S
// product is issued together with tile t-1's P V product (O's rescale by
// tile t-1's factors runs between the two issues, while the S product
// runs), and tile t's softmax runs while that P V product is still in
// flight; across the two warpgroups, named barriers hand the tensor cores
// from one to the other (ping-pong; the turn passes when the S product is
// done), so one warpgroup's exp2 and row sums run while the other's
// products run. The persistent grid hides each tile's start (Q and the
// first K/V tile in flight) behind the previous tile's last products and
// stores.
//
// Measured on the card (PERF.md §6-7): ptxas allocates the consumers
// at most the launch's 168 registers a thread; Q as a register operand
// (the RS form) spilled and serialised the wgmmas, and so did a second P
// buffer that would let P's bf16 pack run before P V completes, and exps
// on the FMA pipe by a polynomial; P through shared memory (stmatrix, an
// SS P V) was slower; a key tile of 64 was slower than 128, a third stage
// no faster. What holds the kernel near 40% of the tensor-core bound is
// the softmax, the longest phase of a key tile: the two warpgroups'
// softmaxes overlap on the 16 exp units while the tensor cores wait.
//
// Online softmax: each thread holds two query rows (g and g + 8 of its
// warp's 16); the running max and sum stay in registers in f32, the tile's
// row max is reduced across the quad of threads that share a row, and the
// thread's share of the row sum is carried across tiles and reduced over
// the quad at the end. exp is ex2.approx of fmaf(s, log2 e, -m log2 e): one
// rounding of the exponent's argument (relative error ~2^-24 of |m| log2 e,
// below 1e-5 of p for |m| < 100) plus ex2's 2 ulp, both far below the 2^-9
// of the bf16 rounding of p that follows, so the result stays within the
// bf16 tolerance of the plain version. A row's result depends on its own
// data alone, whatever block or warp computes it: the split form's rows
// are bit-equal to the same rows of the full launch.
//
// f32: a scalar kernel (one thread per query, f32 FMA, 32-key tiles in
// shared memory): tensor cores would mean TF32, outside the f32 parity
// of 2e-5.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;

struct Strides {
  long long b, h, s;  // elements
};

// ---------------------------------------------------------------------------
// f32: scalar kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 128;  // queries (threads) per block
constexpr int KT = 32;   // keys per shared-memory tile

__global__ void __launch_bounds__(BQ)
mha_encoder_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       Strides qs, Strides ks, Strides vs, int SQ, int SK, int H,
                       float scale) {
  __shared__ __align__(16) float ksm[KT][DH];
  __shared__ __align__(16) float vsm[KT][DH];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const int qi = blockIdx.x * BQ + tid;
  const bool active = qi < SQ;

  float qv[DH], o[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qv[d] = active ? qb[(long long)qi * qs.s + d] * scale : 0.f;
    o[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int n_tiles = (SK + KT - 1) / KT;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * KT;
    const int nvalid = min(KT, SK - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < KT * DH; e += BQ) {
      const int j = e / DH, d = e % DH;
      const bool ok = j < nvalid;
      ksm[j][d] = ok ? kb[(long long)(k0 + j) * ks.s + d] : 0.f;
      vsm[j][d] = ok ? vb[(long long)(k0 + j) * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) s[j] = 0.f;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(&ksm[j][d]);
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
#pragma unroll
        for (int d = 0; d < DH; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vsm[j][d]);
          o[d] = fmaf(p, vv.x, o[d]);
          o[d + 1] = fmaf(p, vv.y, o[d + 1]);
          o[d + 2] = fmaf(p, vv.z, o[d + 2]);
          o[d + 3] = fmaf(p, vv.w, o[d + 3]);
        }
      }
    }
    m = m_new;
  }

  if (active) {
    float* dst = out + ((long long)(b * SQ + qi) * H + h) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) dst[d] = o[d] / l;
  }
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised TMA + wgmma kernel
// ---------------------------------------------------------------------------

constexpr int WG = 128;                // threads per warpgroup
constexpr int BM = 128;                // query rows per block, 64 per consumer warpgroup
constexpr int BN = 128;                // keys per K/V tile
constexpr int STAGES = 2;              // K/V ring depth
constexpr int NT = 3 * WG;             // two consumer warpgroups, then the producer
constexpr int ROW_BYTES = DH * 2;      // one 64-wide bf16 row: one 128-byte swizzle row
constexpr int Q_BYTES = BM * ROW_BYTES;
constexpr int KV_BYTES = BN * ROW_BYTES;
constexpr int BAR_OFFSET = Q_BYTES + 2 * STAGES * KV_BYTES;
constexpr int N_BARS = 2 + 4 * STAGES;  // q_full, q_empty, k_full[], v_full[], k_empty[], v_empty[]
// + 1024: the tiles start on a 1024-byte boundary (the swizzle's period)
constexpr int SMEM_BYTES = BAR_OFFSET + 8 * N_BARS + 1024;
constexpr int CONSUMER_WARPS = 8;      // arrivals that empty a stage: lane 0 of each
// registers a thread: the producer gives up what the consumers take
// (128 x 24 + 256 x 240 = 384 x 168, the launch's allocation)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int NJ = BN / 8;             // n = 8 column blocks of the score tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Bf16Params {
  __nv_bfloat16* o;
  int SQ, SK, H, B;  // query rows, key rows, heads, batch
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive once, and expect `bytes` more to land before the phase completes
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// -- TMA ---------------------------------------------------------------------

// one box {64, rows, 1, 1} at (0, row, h, b) of a 4-D map into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int row, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(h), "r"(b), "r"(bar)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

// descriptor of a 1024-byte-aligned tile of 128-byte rows, 128B swizzle:
// 8-row groups 1024 bytes apart (the stride byte offset); the leading byte
// offset is not read at these widths (one swizzle atom across)
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the wgmma fences and waits around it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WK_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WK_F16(d, i) WK_F4(d, i), WK_F4(d, i + 4), WK_F4(d, i + 8), WK_F4(d, i + 12)

// d (64 x 128, f32) (+)= A (64 x 16, bf16) * B (16 x 128, bf16), both from
// shared memory, K-major
__device__ __forceinline__ void wgmma_n128_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WK_F16(d, 0), WK_F16(d, 16), WK_F16(d, 32), WK_F16(d, 48)
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

// d (64 x 64, f32) += a (64 x 16, bf16, registers) * B (16 x 64, bf16,
// shared memory, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WK_F16(d, 0), WK_F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef WK_F16
#undef WK_F4

// S (64 x BN) = Q (the warpgroup's 64 rows at `q_tile`) K^T over the K
// tile at `k_tile`, both K-major: k-step kk starts 32 bytes further into
// the swizzled rows
__device__ __forceinline__ void score_product(float (&s)[BN / 2], uint32_t q_tile, uint32_t k_tile) {
  const uint64_t desc_q = tile_desc(q_tile), desc_k = tile_desc(k_tile);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_n128_ss(s, desc_q + 2 * kk, desc_k + 2 * kk, kk);
}

// O (64 x 64) += P (64 x BN, bf16 fragments) V over the V tile at
// `v_tile`, MN-major: k-step kk (16 keys) starts 2048 bytes further
__device__ __forceinline__ void value_product(float (&o)[32], const uint32_t (&pf)[BN / 16][4], uint32_t v_tile) {
  const uint64_t desc = tile_desc(v_tile);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) wgmma_n64_rs(o, pf[kk], desc + (2048 >> 4) * kk);
}

// -- the softmax -------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the two consumer warpgroups take turns at the tensor cores: warpgroup w
// waits on named barrier 1 + w, which the other one's arrival opens
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// The online-softmax step of one score tile in place: mask keys at or past
// `kv_valid`, move the row max, turn s into p = exp(s - m), add the
// thread's share of p to its row sums; returns the rescale factors of O
// (0 on the first tile, where m was -inf).
__device__ __forceinline__ float2 softmax_tile(float (&s)[BN / 2], float (&m)[2], float (&l)[2], int tq,
                                               int kv_valid, float l2e) {
  if (kv_valid < BN) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j * 8 + 2 * tq + (e & 1) >= kv_valid) s[j * 4 + e] = -INFINITY;
  }
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j * 4], s[j * 4 + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[j * 4 + 2], s[j * 4 + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
  // exp2(0) = 1 where the max did not move
  const float2 corr = make_float2(ex2((m[0] - mx0) * l2e), ex2((m[1] - mx1) * l2e));
  m[0] = mx0;
  m[1] = mx1;
  const float ms0 = mx0 * l2e, ms1 = mx1 * l2e;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    s[j * 4] = ex2(fmaf(s[j * 4], l2e, -ms0));
    s[j * 4 + 1] = ex2(fmaf(s[j * 4 + 1], l2e, -ms0));
    s[j * 4 + 2] = ex2(fmaf(s[j * 4 + 2], l2e, -ms1));
    s[j * 4 + 3] = ex2(fmaf(s[j * 4 + 3], l2e, -ms1));
    sum0 += s[j * 4] + s[j * 4 + 1];
    sum1 += s[j * 4 + 2] + s[j * 4 + 3];
  }
  l[0] = l[0] * corr.x + sum0;
  l[1] = l[1] * corr.y + sum1;
  return corr;
}

// p (f32, the score accumulator's layout) → the bf16 A fragments of P V:
// k-step kk takes column blocks 2kk and 2kk + 1
__device__ __forceinline__ void pack_p(uint32_t (&pf)[BN / 16][4], const float (&s)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pf[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);      // row g, keys 16kk + 2tq
    pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);  // row g + 8
    pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);  // row g, keys 16kk + 8 + 2tq
    pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);  // row g + 8
  }
}

__device__ __forceinline__ void rescale(float (&o)[32], float2 c) {
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    o[d * 4] *= c.x;
    o[d * 4 + 1] *= c.x;
    o[d * 4 + 2] *= c.y;
    o[d * 4 + 3] *= c.y;
  }
}

// release a stage to the producer: lane 0 of each consumer warp, after
// the warpgroup's wgmma that read it has completed
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// One work tile: BM query rows of one (b, h), from the block's sequence
// (the query-tile index fastest, so that neighbouring blocks read the same
// head's K and V out of L2).
struct Tile {
  int q0, h, b;
};

__device__ __forceinline__ Tile tile_of(int i, int n_q_tiles, int heads) {
  return {(i % n_q_tiles) * BM, (i / n_q_tiles) % heads, i / (n_q_tiles * heads)};
}

// the block's mbarriers (shared-memory addresses): Q's full and empty,
// then a full and an empty one for each stage of K and of V
struct Bars {
  uint32_t base;
  __device__ uint32_t q_full() const { return base; }
  __device__ uint32_t q_empty() const { return base + 8; }
  __device__ uint32_t k_full(int st) const { return base + 8 * (2 + st); }
  __device__ uint32_t v_full(int st) const { return base + 8 * (2 + STAGES + st); }
  __device__ uint32_t k_empty(int st) const { return base + 8 * (2 + 2 * STAGES + st); }
  __device__ uint32_t v_empty(int st) const { return base + 8 * (2 + 3 * STAGES + st); }
};

// position i of the K/V ring, counted over the block's whole run: its
// stage and the parity of its round
__device__ __forceinline__ int stage_of(int i) { return i % STAGES; }
__device__ __forceinline__ uint32_t round_of(int i) { return (i / STAGES) & 1; }

__device__ __forceinline__ void producer(const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                         const Bf16Params& p, uint32_t sQ, uint32_t sK, uint32_t sV, Bars bar,
                                         int n_kv, int n_q_tiles, int n_work) {
  int it = 0;  // K/V ring position
  for (int w = 0, i = blockIdx.x; i < n_work; ++w, i += gridDim.x) {
    const Tile tile = tile_of(i, n_q_tiles, p.H);
    mbar_wait(bar.q_empty(), (w & 1) ^ 1);  // the first wait finds Q's buffer empty
    mbar_arrive_expect(bar.q_full(), Q_BYTES);
    tma_load(sQ, tm_q, bar.q_full(), tile.q0, tile.h, tile.b);
    for (int t = 0; t < n_kv; ++t, ++it) {
      const int st = stage_of(it);
      const uint32_t parity = round_of(it) ^ 1;  // so does each stage's first wait
      mbar_wait(bar.k_empty(st), parity);
      mbar_arrive_expect(bar.k_full(st), KV_BYTES);
      tma_load(sK + st * KV_BYTES, tm_k, bar.k_full(st), t * BN, tile.h, tile.b);
      mbar_wait(bar.v_empty(st), parity);
      mbar_arrive_expect(bar.v_full(st), KV_BYTES);
      tma_load(sV + st * KV_BYTES, tm_v, bar.v_full(st), t * BN, tile.h, tile.b);
    }
  }
}

__device__ __forceinline__ void consumer(const Bf16Params& p, uint32_t sQ, uint32_t sK, uint32_t sV, Bars bar,
                                         int wg, int n_kv, int n_q_tiles, int n_work) {
  const int wt = threadIdx.x % WG, warp = wt >> 5, lane = wt & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row group and column pair
  const uint32_t sQw = sQ + wg * 64 * ROW_BYTES;  // this warpgroup's 64 rows of Q
  // q's scale, dh^-0.5 = 2^-3, is a power of two: q scaled and rounded to
  // bf16 is q times the scale exactly, and so is every partial sum of the
  // score dot; the scale goes into the exponent's factor instead
  const float l2e = p.scale * LOG2E;
  float s[BN / 2], o[32];
  uint32_t pf[BN / 16][4];
  if (wg == 1) turn_pass(wg);  // warpgroup 0 takes the first turn

  int it = 0;  // K/V ring position, the producer's sequence
  for (int w = 0, i = blockIdx.x; i < n_work; ++w, i += gridDim.x) {
    const bool last_work = i + gridDim.x >= n_work;
#pragma unroll
    for (int k = 0; k < 32; ++k) o[k] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running row max (rows g, g + 8)
    float l[2] = {0.f, 0.f};              // running row sum, this thread's columns
    mbar_wait(bar.q_full(), w & 1);

    // key tile 0: its score product alone
    mbar_wait(bar.k_full(stage_of(it)), round_of(it));
    turn_wait(wg);
    wgmma_fence();
    score_product(s, sQw, sK + stage_of(it) * KV_BYTES);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(s);
    release(bar.k_empty(stage_of(it)), lane);
    if (n_kv == 1) release(bar.q_empty(), lane);
    softmax_tile(s, m, l, tq, p.SK, l2e);
    pack_p(pf, s);

    // key tile t: its score product with tile t-1's P V in one turn, t's
    // softmax while that P V runs. O takes tile t-1's rescale between the
    // two products, while the score product runs.
    float2 corr = make_float2(1.f, 1.f);
    for (int t = 1; t < n_kv; ++t) {
      const int cur = it + t, prev = cur - 1;
      mbar_wait(bar.k_full(stage_of(cur)), round_of(cur));
      mbar_wait(bar.v_full(stage_of(prev)), round_of(prev));
      turn_wait(wg);
      fence_regs(o);
      wgmma_fence();
      score_product(s, sQw, sK + stage_of(cur) * KV_BYTES);
      wgmma_commit();
      rescale(o, corr);
      fence_regs(o);
      wgmma_fence();
      value_product(o, pf, sV + stage_of(prev) * KV_BYTES);
      wgmma_commit();
      wgmma_wait<1>();  // the score product is done, P V may still run
      // the other warpgroup's turn opens once this score product is done,
      // so that its softmax starts later and overlaps this one's less
      turn_pass(wg);
      fence_regs(s);
      release(bar.k_empty(stage_of(cur)), lane);
      if (t == n_kv - 1) release(bar.q_empty(), lane);  // Q's last reader is done
      corr = softmax_tile(s, m, l, tq, p.SK - t * BN, l2e);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(s);
      release(bar.v_empty(stage_of(prev)), lane);
      pack_p(pf, s);
    }
    rescale(o, corr);

    // the last key tile's P V; the block's very last turn opens nothing
    const int lst = it + n_kv - 1;
    mbar_wait(bar.v_full(stage_of(lst)), round_of(lst));
    turn_wait(wg);
    fence_regs(o);
    wgmma_fence();
    value_product(o, pf, sV + stage_of(lst) * KV_BYTES);
    wgmma_commit();
    if (wg == 0 || !last_work) turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(o);
    release(bar.v_empty(stage_of(lst)), lane);
    it += n_kv;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(FULL, l[r], 1);
      l[r] += __shfl_xor_sync(FULL, l[r], 2);
    }
    const Tile tile = tile_of(i, n_q_tiles, p.H);
    const int row0 = tile.q0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;
    const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
    __nv_bfloat16* o0 = p.o + ((long long)(tile.b * p.SQ + row0) * p.H + tile.h) * DH;
    __nv_bfloat16* o1 = p.o + ((long long)(tile.b * p.SQ + row1) * p.H + tile.h) * DH;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int col = d * 8 + 2 * tq;
      if (row0 < p.SQ)
        *reinterpret_cast<__nv_bfloat162*>(o0 + col) = __floats2bfloat162_rn(o[d * 4] * inv0, o[d * 4 + 1] * inv0);
      if (row1 < p.SQ)
        *reinterpret_cast<__nv_bfloat162*>(o1 + col) = __floats2bfloat162_rn(o[d * 4 + 2] * inv1, o[d * 4 + 3] * inv1);
    }
  }
}

// A persistent grid: block i takes work tiles i, i + gridDim.x, ..., so
// that the producer loads the next tile's Q and first K/V tiles while the
// consumers finish the last P V and the stores of the current one.
__global__ void __launch_bounds__(NT, 1)
    mha_encoder_bf16_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, const Bf16Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;  // Q, BM rows
  const uint32_t sK = sQ + Q_BYTES;             // STAGES K tiles of BN rows
  const uint32_t sV = sK + STAGES * KV_BYTES;   // STAGES V tiles
  const Bars bar{sQ + BAR_OFFSET};
  const int n_kv = (p.SK + BN - 1) / BN;
  const int n_q_tiles = (p.SQ + BM - 1) / BM;
  const int n_work = n_q_tiles * p.H * p.B;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(bar.q_full(), 1);
    mbar_init(bar.q_empty(), CONSUMER_WARPS);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar.k_full(st), 1);
      mbar_init(bar.v_full(st), 1);
      mbar_init(bar.k_empty(st), CONSUMER_WARPS);
      mbar_init(bar.v_empty(st), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x == 2 * WG) producer(&tm_q, &tm_k, &tm_v, p, sQ, sK, sV, bar, n_kv, n_q_tiles, n_work);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    consumer(p, sQ, sK, sV, bar, wg, n_kv, n_q_tiles, n_work);
  }
}

// -- tensor maps ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                                      &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? (EncodeTiled)f : nullptr;
  }();
  return fn;
}

// The map of one of q, k, v [B, H, rows, 64] (element strides B, H, rows):
// dims {64, rows, H, B}, byte strides {rows, H, B}, box {64, box_rows, 1,
// 1}, 128B swizzle, zero fill. A dimension of size 1 takes the packed
// stride (its coordinate is always 0; torch gives such a dimension any
// stride). ops/attention.py::tensor_map_args
// computes the same arguments and refuses what TMA refuses.
int encode_map(CUtensorMap* map, const void* base, const long long* st, int batch, int heads, int rows,
               int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t row_bytes = rows == 1 ? ROW_BYTES : (cuuint64_t)st[2] * 2;
  const cuuint64_t head_bytes = heads == 1 ? row_bytes * rows : (cuuint64_t)st[1] * 2;
  const cuuint64_t batch_bytes = batch == 1 ? head_bytes * heads : (cuuint64_t)st[0] * 2;
  const cuuint64_t dims[4] = {DH, (cuuint64_t)rows, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {row_bytes, head_bytes, batch_bytes};
  const cuuint32_t box[4] = {DH, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                          unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace


// strides: the B, H and S strides (elements) of q, k and v, in that order
extern "C" int wk_mha_encoder(const void* q, const void* k, const void* v, void* out,
                              const long long* strides, int batch, int heads, int seq_q,
                              int seq_k, int is_bf16, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_q <= 0 || seq_k <= 0 || batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    CUtensorMap tm_q, tm_k, tm_v;
    int err = encode_map(&tm_q, q, strides, batch, heads, seq_q, BM);
    if (!err) err = encode_map(&tm_k, k, strides + 3, batch, heads, seq_k, BN);
    if (!err) err = encode_map(&tm_v, v, strides + 6, batch, heads, seq_k, BN);
    if (err) return err;
    // the kernel folds the scale into the exponent: exact only for a power of two
    int exponent;
    if (frexpf(scale, &exponent) != 0.5f) return (int)cudaErrorInvalidValue;
    int device, n_sm;
    cudaError_t cerr = cudaGetDevice(&device);
    if (cerr == cudaSuccess) cerr = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (cerr == cudaSuccess)
      cerr = cudaFuncSetAttribute(mha_encoder_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (cerr != cudaSuccess) return (int)cerr;
    const Bf16Params p{(__nv_bfloat16*)out, seq_q, seq_k, heads, batch, scale};
    const long long n_work = (long long)((seq_q + BM - 1) / BM) * heads * batch;
    if (n_work > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int grid = (int)(n_work < n_sm ? n_work : n_sm);  // one block per SM, each looping over tiles
    mha_encoder_bf16_kernel<<<grid, NT, SMEM_BYTES, st>>>(tm_q, tm_k, tm_v, p);
  } else {
    const Strides qs{strides[0], strides[1], strides[2]};
    const Strides ks{strides[3], strides[4], strides[5]};
    const Strides vs{strides[6], strides[7], strides[8]};
    dim3 grid((seq_q + BQ - 1) / BQ, heads, batch);
    mha_encoder_f32_kernel<<<grid, BQ, 0, st>>>((const float*)q, (const float*)k,
                                                 (const float*)v, (float*)out, qs, ks, vs, seq_q,
                                                 seq_k, heads, scale);
  }
  return (int)cudaGetLastError();
}
