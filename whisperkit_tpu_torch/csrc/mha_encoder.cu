// Non-causal multi-head attention for the Whisper encoder, Hopper (sm_90a).
//
// Replaces the TPU kernel whisperkit_tpu/ops/attention.py::mha_encoder_pallas
// (_mha_kernel). Same function and the same rounding points: q is scaled
// by dh^-0.5 and rounded to q's type before the score dot; scores and the
// softmax are float32; the (unnormalised) probability is rounded to v's
// type before the PV product; the output is rounded to q's type. Head dim
// 64. q is [B, H, SQ, 64] and k/v [B, H, SK, 64], each with a contiguous
// last dimension and any strides for B, H and the rows (the head-split
// views of the q/k/v projections); SQ = SK = 1500 in the encoder, SQ < SK
// in its sequence-parallel mode (each rank's own query rows over all the
// keys). The grid covers the query rows, the key loop and its masking the
// key rows. The output is written in the [B, SQ, H, 64] layout, so that
// merging the heads back is a view.
//
// What bounds it: arithmetic. At the encoder's shape (S = 1500, Dh = 64)
// one (batch, head) is 4 x 1500^2 x 64 = 0.58 GFLOP against 0.77 MB of
// bf16 Q/K/V/O traffic, about 750 FLOP per byte; the bound at B = 32,
// H = 20 is 368.6 GFLOP / 989 TFLOP/s = 0.373 ms. At Dh = 64 the softmax's
// 1.44e9 exp evaluations (B = 32) take about as long on the special
// function units (16 per SM per clock) as the products on the tensor cores.
//
// bf16: tensor cores, mma.sync.m16n8k16 (bf16 in, f32 accumulate) fed by
// ldmatrix, in the FlashAttention-2 form. One block of 8 warps owns 128
// query rows, 16 per warp. Q is staged once per block (cp.async) and held
// in registers as A fragments. K and V walk the keys in tiles of 64 through
// a ring of STAGES buffers in shared memory, filled with cp.async (16-byte
// copies, zero fill past SK) one tile ahead of the tile being computed; rows
// of 128 bytes are stored with their 16-byte chunks XOR-swizzled by the row
// index, so that ldmatrix reads are free of bank conflicts. Per tile and
// warp: S = Q K^T as 4 x 8 mma (K read as the col-major B operand), the
// online softmax on the accumulator fragments, then O += P V as 4 x 8 mma,
// where the score accumulator's fragments are repacked in registers as the
// A operand (no trip through shared memory) and V is read with
// ldmatrix.trans as the B operand.
//
// Online softmax: each thread holds two query rows (g and g + 8 of its
// warp's 16); the running max and sum stay in registers in f32, the tile's
// row max is reduced across the quad of threads that share a row, and the
// accumulator is rescaled only when the max moved (warp-uniform test).
// exp is exp2f of fmaf(s, log2 e, -m log2 e): one rounding of the
// exponent's argument (relative error ~2^-24 of |m| log2 e, below 1e-5 of p
// for |m| < 100) plus exp2f's 2 ulp, both far below the 2^-9 of the bf16
// rounding of p that follows, so the result stays within the bf16
// tolerance of the plain version. Keys past SK score -inf in the last tile
// (the zero fill is not the mask); query rows past SQ are computed on zero
// rows and never stored; nothing is padded in device memory.
//
// Overlap of exp with the products: no explicit ping-pong; the overlap
// comes from the warp schedulers interleaving the 16 resident warps (two
// blocks per SM) whose MMA and softmax phases are not synchronised.
// wgmma (the warpgroup form) and TMA are the next step.
//
// f32: a scalar kernel (one thread per query, f32 FMA, 32-key tiles in
// shared memory): tensor cores would mean TF32, outside the f32 parity
// of 2e-5.

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
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int BM = 128;               // query rows per block
constexpr int BN = 64;                // keys per K/V tile
constexpr int NWARPS = BM / 16;       // one warp per 16 query rows
constexpr int NT = NWARPS * 32;       // 256 threads
constexpr int STAGES = 2;             // K/V ring depth
constexpr int SMEM_BYTES = (BM + 2 * STAGES * BN) * DH * 2;  // 48 KB
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Bf16Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  Strides qs, ks, vs;
  int SQ, SK, H;  // query rows, key rows, heads
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of (row, 16-byte chunk) in a tile of 64-wide bf16 rows,
// chunks XOR-swizzled by the row index
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * DH + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: zero-fill the 16 bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS x 64 bf16 rows from global (row stride `rs` elements) into a
// swizzled shared tile; rows at or past `nvalid` are zero-filled
template <int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sm, const __nv_bfloat16* g, long long rs,
                                          int nvalid, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / NT; ++i) {
    const int c = tid + i * NT;
    const int r = c >> 3, ch = c & 7;
    const bool ok = r < nvalid;
    const __nv_bfloat16* src = ok ? g + r * rs + ch * 8 : g;
    cp_async16(smem_u32(sm + swz(r, ch)), src, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 values times `s`, each rounded back to bf16
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack_bf16(f.x * s, f.y * s);
}

__global__ void __launch_bounds__(NT, 2) mha_encoder_bf16_kernel(const Bf16Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BM x 64
  __nv_bfloat16* sK = sQ + BM * DH;                                 // STAGES x BN x 64
  __nv_bfloat16* sV = sK + STAGES * BN * DH;                        // STAGES x BN x 64

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row group and column pair
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int SQ = p.SQ, SK = p.SK;
  const __nv_bfloat16* qg = p.q + b * p.qs.b + h * p.qs.h + (long long)q0 * p.qs.s;
  const __nv_bfloat16* kg = p.k + b * p.ks.b + h * p.ks.h;
  const __nv_bfloat16* vg = p.v + b * p.vs.b + h * p.vs.h;
  const int n_tiles = (SK + BN - 1) / BN;

  // prologue: Q with K/V tile 0 in the first group, then tiles 1 .. STAGES-2
  load_tile<BM>(sQ, qg, p.qs.s, SQ - q0, tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) {
      load_tile<BN>(sK + st * BN * DH, kg + (long long)st * BN * p.ks.s, p.ks.s, SK - st * BN, tid);
      load_tile<BN>(sV + st * BN * DH, vg + (long long)st * BN * p.vs.s, p.vs.s, SK - st * BN, tid);
    }
    cp_async_commit();
  }

  uint32_t qf[4][4];  // A fragments of the warp's 16 x 64 scaled Q
  float o[8][4];      // O accumulator, 16 x 64 (8 tiles of n = 8)
#pragma unroll
  for (int d = 0; d < 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max (rows g, g + 8)
  float l[2] = {0.f, 0.f};              // running row sum, this thread's columns

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t (and Q) have landed
    __syncthreads();              // visible to all; every warp is done with tile t-1
    {
      const int nt = t + STAGES - 1;  // refill the buffer tile t-1 used
      if (nt < n_tiles) {
        const int st = nt % STAGES;
        load_tile<BN>(sK + st * BN * DH, kg + (long long)nt * BN * p.ks.s, p.ks.s, SK - nt * BN, tid);
        load_tile<BN>(sV + st * BN * DH, vg + (long long)nt * BN * p.vs.s, p.vs.s, SK - nt * BN, tid);
      }
      cp_async_commit();
    }
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int r = warp * 16 + (lane & 15), ch = kk * 2 + (lane >> 4);
        ldsm_x4(smem_u32(sQ + swz(r, ch)), qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) qf[kk][i] = scale_bf16x2(qf[kk][i], p.scale);
      }
    }
    const __nv_bfloat16* ks = sK + (t % STAGES) * BN * DH;
    const __nv_bfloat16* vs = sV + (t % STAGES) * BN * DH;

    // S = Q K^T: 16 x 64 per warp, 8 tiles of n = 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int r = jp * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int ch = kk * 2 + ((lane >> 3) & 1);
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(ks + swz(r, ch)), b0, b1, b2, b3);
        mma_bf16(s[2 * jp], qf[kk], b0, b1);
        mma_bf16(s[2 * jp + 1], qf[kk], b2, b3);
      }
    }

    // keys past SK score -inf (only the ragged last tile has them)
    const int kv_valid = SK - t * BN;
    if (kv_valid < BN) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * 8 + 2 * tq + (e & 1) >= kv_valid) s[j][e] = -INFINITY;
    }

    // online softmax: the tile's row max over the quad, rescale if it moved
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    }
    if (__any_sync(FULL, mx[0] > m[0] || mx[1] > m[1])) {
      // exp2(0) = 1 where the max did not move; 0 on the first tile (m = -inf)
      const float c0 = exp2f((m[0] - mx[0]) * LOG2E), c1 = exp2f((m[1] - mx[1]) * LOG2E);
      l[0] *= c0;
      l[1] *= c1;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        o[d][0] *= c0;
        o[d][1] *= c0;
        o[d][2] *= c1;
        o[d][3] *= c1;
      }
    }
    m[0] = mx[0];
    m[1] = mx[1];
    const float ms0 = m[0] * LOG2E, ms1 = m[1] * LOG2E;

    // p = exp(s - m), summed in f32, rounded to bf16 as the A operand of P V
    uint32_t pf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(fmaf(s[j][0], LOG2E, -ms0));
      const float p1 = exp2f(fmaf(s[j][1], LOG2E, -ms0));
      const float p2 = exp2f(fmaf(s[j][2], LOG2E, -ms1));
      const float p3 = exp2f(fmaf(s[j][3], LOG2E, -ms1));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);      // row g
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);  // row g + 8
    }

    // O += P V: V [keys, 64] read transposed as the col-major B operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        const int r = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int ch = dp * 2 + (lane >> 4);
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(vs + swz(r, ch)), b0, b1, b2, b3);
        mma_bf16(o[2 * dp], pf[kk], b0, b1);
        mma_bf16(o[2 * dp + 1], pf[kk], b2, b3);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
  }
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  __nv_bfloat16* o0 = p.o + ((long long)(b * SQ + row0) * p.H + h) * DH;
  __nv_bfloat16* o1 = p.o + ((long long)(b * SQ + row1) * p.H + h) * DH;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int col = d * 8 + 2 * tq;
    if (row0 < SQ)
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
          __floats2bfloat162_rn(o[d][0] * inv0, o[d][1] * inv0);
    if (row1 < SQ)
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
          __floats2bfloat162_rn(o[d][2] * inv1, o[d][3] * inv1);
  }
}

}  // namespace

// strides: the B, H and S strides (elements) of q, k and v, in that order
extern "C" int wk_mha_encoder(const void* q, const void* k, const void* v, void* out,
                              const long long* strides, int batch, int heads, int seq_q,
                              int seq_k, int is_bf16, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_q <= 0 || seq_k <= 0 || batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    cudaError_t err = cudaFuncSetAttribute(
        mha_encoder_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const Bf16Params p{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                       (const __nv_bfloat16*)v, (__nv_bfloat16*)out, qs, ks, vs,
                       seq_q, seq_k, heads, scale};
    dim3 grid((seq_q + BM - 1) / BM, heads, batch);
    mha_encoder_bf16_kernel<<<grid, NT, SMEM_BYTES, st>>>(p);
  } else {
    dim3 grid((seq_q + BQ - 1) / BQ, heads, batch);
    mha_encoder_f32_kernel<<<grid, BQ, 0, st>>>((const float*)q, (const float*)k,
                                                 (const float*)v, (float*)out, qs, ks, vs, seq_q,
                                                 seq_k, heads, scale);
  }
  return (int)cudaGetLastError();
}
