// The W8A16 product of the decode step for Hopper (sm_90a): y = x @ w for
// a few rows of bf16 x and a weight stored as int8 codes with a bf16 scale
// per output column ({"w_q": int8 [in, out], "scale": bf16 [out]}), the
// codes read once from device memory and dequantized in registers; the
// bf16 weight never goes to device memory.
//
// Replaces no TPU kernel: the JAX package leaves this product to XLA
// (whisperkit_tpu/ops/quant.py, quantized_matmul), which fuses the dequant
// into the matmul. The port's plain version (ops/quant.py,
// quantized_matmul_reference) writes the whole bf16 weight to device memory
// on every call and hands it to cuBLAS: it reads the codes, writes twice
// their bytes and reads those back.
//
// What bounds it: device-memory bandwidth. At 32 rows the product does 64
// operations per byte of codes, under the card's ~295 bf16 operations per
// byte, so the least time is the codes (in x out bytes), the scales, x and
// y over 3.35 TB/s: 0.49-0.54 us for a 1280 x 1280 linear at 1-32 rows,
// 1.96-2.08 us for 1280 x 5120 or 5120 x 1280 (large-v3's decoder: 22.9 M
// codes a layer, 0.22 ms a step over 32 layers).
//
// Arithmetic, that of the plain version: each weight element is
// bf16(float(code) * float(scale)), rounded once to nearest even (the
// product is exact in float32), bit-equal to dequantize_weight's operand;
// the tensor cores multiply it with x in bf16 and accumulate in float32
// (mma.sync m16n8k16); the sum is rounded once to bf16. Only the order of
// the float32 sum differs from cuBLAS's. A bias, where the caller folds it,
// is added to that bf16 product in float32 and rounded again: the plain
// `y + b`'s two roundings.
//
// Design. The tensor cores take the weight as the A operand (16 output
// columns a tile, the mma's rows) and x as B (8 rows of x a tile), so one
// dequantized fragment serves every row of x. A block of 4 warps owns 64
// output columns (16 a warp) over a slice of the input features, in stages
// of 64 features: cp.async copies each stage's codes (64 x 64 bytes) and
// x's rows (rows x 64 bf16) into a shared-memory ring, up to NS - 1 stages
// ahead, so on the decode step's shapes a block's whole slice is in flight
// at once. ldmatrix.trans reads a warp's codes as 8 x 8 tiles of byte
// pairs: each thread gets, for two neighbouring columns, the codes of two
// consecutive features, so the A fragment's row g holds column 2g and row
// g + 8 column 2g + 1, and each thread keeps its two columns' scales in
// registers for the whole slice. Codes become floats by the exponent trick
// (0x4B000000 | (code ^ 0x80), minus 2^23 + 128). A stage gives each warp
// four steps of 16 features, and the loads of up to four tiles of x go
// out before their products: with 4 warps a block and about one block an
// SM, the kernel is bound by latency, not by instruction throughput, and
// each chain of dependent loads and products has to overlap the others. Rows of x are
// padded to a multiple of 8 with zeros; padded rows are computed and not
// stored.
//
// Split K, so that a 1280-column product still fills the card's 132 SMs:
// the blocks of one column tile form a thread block cluster of up to 16
// along the input features (more than 8 needs the non-portable size), as
// many as bring the grid to two blocks an SM while each block keeps two
// stages. Each writes its float32 partial tile to its own shared memory;
// after a cluster barrier each block sums a share of the tile's outputs
// over the cluster's blocks in rank order through distributed shared
// memory (all ranks' loads in flight at once), rounds and stores it, and a
// second, relaxed barrier keeps every block's shared memory alive until
// its peers have read it. No atomics: a graph's replays give the same
// bits. The reduction costs a fixed ~1.5 us a launch on the card, a
// third of a 1280 x 1280 product's time at 32 rows.
//
// One launch may take up to three products that share x (the decoder's
// self-attention q, k and v): their column tiles share the grid. The kernel
// allocates nothing and never synchronises, so it runs inside the decode
// step's CUDA graph.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int BN = 64;            // output columns a block: 16 a warp
constexpr int KT = 64;            // input features a stage
constexpr int CODE_ROW_BYTES = BN;     // a stage's row of codes
constexpr int X_ROW_BYTES = 2 * KT;    // a stage's row of x
constexpr int RED_STRIDE = BN + 4;  // floats a row of the partial tile (no bank conflicts)
constexpr int MAX_SEGS = 3;
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_ROWS = 256;

struct Seg {
  const int8_t* w;             // [k, n] codes
  const __nv_bfloat16* scale;  // [n]
  const __nv_bfloat16* bias;   // [n], or null
  __nv_bfloat16* y;            // [m, n]
  int n;
  int tile0;  // the segment's first column tile in the grid
};

struct Args {
  const __nv_bfloat16* x;  // [m, k]
  int m, k;
  Seg seg[MAX_SEGS];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offsets of 16-byte piece c of row r in a stage's rows of codes
// (64 bytes) and of x (128 bytes): the pieces are permuted by rows so that
// the 8 rows an ldmatrix reads hit 32 different banks
__device__ __forceinline__ int swz64(int r, int c) { return r * CODE_ROW_BYTES + ((c ^ ((r >> 1) & 3)) << 4); }
__device__ __forceinline__ int swz128(int r, int c) { return r * X_ROW_BYTES + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// code byte `b` of `u` (codes biased by 0x80) as an exact float
__device__ __forceinline__ float code_at(uint32_t u, int b) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | b)) - 8388736.f;  // 2^23 + 128
}

// bytes lo and hi of u times s, each rounded once to bf16; lo in the low half
__device__ __forceinline__ uint32_t dequant2(uint32_t u, int lo, int hi, float s) {
  __nv_bfloat162 w = __floats2bfloat162_rn(code_at(u, lo) * s, code_at(u, hi) * s);
  return *reinterpret_cast<uint32_t*>(&w);
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;  // H100 SXM
  return n;
}

template <int NT>
struct Layout {
  static constexpr int CODE_BYTES = KT * BN;
  static constexpr int STAGE_BYTES = CODE_BYTES + 8 * NT * X_ROW_BYTES;
  static constexpr int RED_BYTES = 8 * NT * RED_STRIDE * 4;
  static constexpr int NS = NT <= 4 ? 6 : NT <= 8 ? 4 : 3;  // stages in the ring
  static constexpr int TG = NT >= 16 ? 2 : 4;              // tiles of x whose products overlap
  static constexpr int RING_BYTES = NS * STAGE_BYTES;
  static constexpr int SMEM = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
};

// NT: tiles of 8 rows of x the block holds (rows <= 8 NT).
template <int NT>
__global__ void __launch_bounds__(THREADS) w8a16_matmul_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Layout<NT>;
  constexpr int NS = L::NS, TG = L::TG;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;

  int si = 0;
#pragma unroll
  for (int i = 1; i < MAX_SEGS; ++i)
    if (a.seg[i].n > 0 && (int)blockIdx.x >= a.seg[i].tile0) si = i;
  const Seg& sg = a.seg[si];
  const int n = sg.n, col0 = ((int)blockIdx.x - sg.tile0) * BN;
  const int m = a.m, k = a.k;
  const int live_rows = (m + 7) & ~7;

  // this block's stages of the input features
  const int splits = (int)gridDim.y, total = k / KT;
  const int st_beg = (int)blockIdx.y * total / splits, st_end = ((int)blockIdx.y + 1) * total / splits;
  const int nst = st_end - st_beg;

  // the thread's two columns and their scales
  const int wcol = warp * 16 + 2 * g;
  const __nv_bfloat162 s2 = *reinterpret_cast<const __nv_bfloat162*>(sg.scale + col0 + wcol);
  const float s_lo = __low2float(s2), s_hi = __high2float(s2);

  auto load_stage = [&](int s, int slot) {
    unsigned char* base = smem + slot * L::STAGE_BYTES;
    const int k0 = (st_beg + s) * KT;
#pragma unroll
    for (int i = tid; i < KT * 4; i += THREADS) {  // codes: 64 rows x 4 pieces of 16 bytes
      const int r = i >> 2, c = i & 3;
      cp_async16(smem_addr(base + swz64(r, c)), sg.w + (size_t)(k0 + r) * n + col0 + 16 * c, 16);
    }
    unsigned char* xs = base + L::CODE_BYTES;
    for (int i = tid; i < 8 * live_rows; i += THREADS) {  // x: 8 pieces a row
      const int r = i >> 3, c = i & 7;
      const bool valid = r < m;
      const __nv_bfloat16* src = a.x + (valid ? (size_t)r * k + k0 + 8 * c : 0);
      cp_async16(smem_addr(xs + swz128(r, c)), src, valid ? 16 : 0);  // zeros past the last row
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nst) load_stage(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < nst; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // stage i landed for every thread; slot (i - 1) % NS is free
    if (i + NS - 1 < nst) load_stage(i + NS - 1, (i + NS - 1) % NS);
    cp_async_commit();

    const unsigned char* base = smem + (i % NS) * L::STAGE_BYTES;
    // the warp's 64 x 16 codes, 32 features a load: register j of raw[f]
    // holds features 32f + 8j + 2q, + 1 of columns 2g, 2g + 1 (bytes:
    // (f0, c0), (f0, c1), (f1, c0), (f1, c1))
    uint32_t raw[2][4];
#pragma unroll
    for (int f = 0; f < 2; ++f) ldsm_x4_trans(raw[f], smem_addr(base + swz64(32 * f + lane, warp)));
    uint32_t af[4][4];  // the A fragments of the stage's four steps of 16 features
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint32_t u0 = raw[h >> 1][2 * (h & 1)] ^ 0x80808080u, u1 = raw[h >> 1][2 * (h & 1) + 1] ^ 0x80808080u;
      af[h][0] = dequant2(u0, 0, 2, s_lo);  // row g: column 2g, features 2q, 2q + 1
      af[h][1] = dequant2(u0, 1, 3, s_hi);  // row g + 8: column 2g + 1
      af[h][2] = dequant2(u1, 0, 2, s_lo);  // features 2q + 8, 2q + 9
      af[h][3] = dequant2(u1, 1, 3, s_hi);
    }
    const unsigned char* xs = base + L::CODE_BYTES;
    // TG tiles of 8 rows at a time: their loads, then their products, so
    // that the latencies overlap
#pragma unroll
    for (int t0 = 0; t0 < NT; t0 += TG) {
      uint32_t bf[TG][2][4];  // rows 8t .. 8t + 7 of x; bf[u][f][j]: features 32f + 8j .. + 7
#pragma unroll
      for (int u = 0; u < TG; ++u)
#pragma unroll
        for (int f = 0; f < 2; ++f)
          if (t0 + u < NT && 8 * (t0 + u) < m)
            ldsm_x4(bf[u][f], smem_addr(xs + swz128(8 * (t0 + u) + (lane & 7), 4 * f + (lane >> 3))));
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int u = 0; u < TG; ++u)
          if (t0 + u < NT && 8 * (t0 + u) < m)
            mma_bf16(acc[t0 + u], af[h], bf[u][h >> 1][2 * (h & 1)], bf[u][h >> 1][2 * (h & 1) + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial tile takes its place

  // acc[t]: rows 8t + 2q, 8t + 2q + 1 of x; {0, 1} column 2g, {2, 3} column 2g + 1
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (8 * t < m) {
      float* at = red + (8 * t + 2 * q) * RED_STRIDE + wcol;
      *reinterpret_cast<float2*>(at) = make_float2(acc[t][0], acc[t][2]);
      *reinterpret_cast<float2*>(at + RED_STRIDE) = make_float2(acc[t][1], acc[t][3]);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partial tile is written

  // this block's share of the tile's column pairs, summed in rank order
  const int ranks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int pairs = m * (BN / 2), lo = rank * pairs / ranks, hi = (rank + 1) * pairs / ranks;
  for (int p = lo + tid; p < hi; p += THREADS) {
    const int r = p / (BN / 2), c = 2 * (p % (BN / 2));
    float2* mine = reinterpret_cast<float2*>(red + r * RED_STRIDE + c);
    float2 v[MAX_CLUSTER];  // every rank's load in flight at once
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j)
      if (j < ranks) v[j] = *cluster.map_shared_rank(mine, j);
    float2 sum = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j) {
      if (j < ranks) {
        sum.x += v[j].x;
        sum.y += v[j].y;
      }
    }
    __nv_bfloat162 out = __floats2bfloat162_rn(sum.x, sum.y);
    if (sg.bias != nullptr) {
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(sg.bias + col0 + c);
      out = __floats2bfloat162_rn(__low2float(out) + __low2float(b), __high2float(out) + __high2float(b));
    }
    *reinterpret_cast<__nv_bfloat162*>(sg.y + (size_t)r * n + col0 + c) = out;
  }
  // the peers have read this block's partial tile: their loads returned
  // before the stores that use them, so a relaxed arrive suffices
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int NT>
cudaError_t launch(const Args& args, int tiles, cudaStream_t stream) {
  using L = Layout<NT>;
  // split the input features over a cluster of blocks until the grid holds
  // two blocks an SM, each block keeping two stages
  static const int sms = sm_count();
  int splits = 1;
  while (splits < MAX_CLUSTER && tiles * splits < 2 * sms && 4 * splits <= args.k / KT) splits *= 2;
  // set on each call, on the current device: the shared memory above the
  // default 48 KB, clusters above the portable 8
  cudaError_t e = cudaFuncSetAttribute(w8a16_matmul_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       L::SMEM);
  if (e == cudaSuccess && splits > 8)
    e = cudaFuncSetAttribute(w8a16_matmul_kernel<NT>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles, (unsigned)splits, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, w8a16_matmul_kernel<NT>, args);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// x [m, k] bf16; for each of up to three products sharing x: codes w_i
// [k, n_i] int8, scale_i [n_i] bf16, bias_i [n_i] bf16 or null, out y_i
// [m, n_i] bf16; n_i = 0 ends the list. All row-major and contiguous;
// 1 <= m <= 256, k a multiple of 64, each n_i a multiple of 64; x and the
// codes 16-byte aligned, the scales, biases and outputs 4-byte aligned.
extern "C" int wk_w8a16_matmul(const void* x, int m, int k,
                               const void* w0, const void* s0, const void* b0, void* y0, int n0,
                               const void* w1, const void* s1, const void* b1, void* y1, int n1,
                               const void* w2, const void* s2, const void* b2, void* y2, int n2,
                               void* stream) {
  if (m < 1 || m > MAX_ROWS || k < KT || k % KT || ((uintptr_t)x % 16)) return (int)cudaErrorInvalidValue;
  Args args{};
  args.x = (const __nv_bfloat16*)x;
  args.m = m;
  args.k = k;
  const void* ws[MAX_SEGS] = {w0, w1, w2};
  const void* ss[MAX_SEGS] = {s0, s1, s2};
  const void* bs[MAX_SEGS] = {b0, b1, b2};
  void* ys[MAX_SEGS] = {y0, y1, y2};
  const int ns[MAX_SEGS] = {n0, n1, n2};
  int tiles = 0;
  for (int i = 0; i < MAX_SEGS; ++i) {
    if (ns[i] == 0) break;
    if (ns[i] < 0 || ns[i] % BN || ((uintptr_t)ws[i] % 16) || ((uintptr_t)ss[i] % 4) || ((uintptr_t)bs[i] % 4) ||
        ((uintptr_t)ys[i] % 4))
      return (int)cudaErrorInvalidValue;
    args.seg[i] = Seg{(const int8_t*)ws[i], (const __nv_bfloat16*)ss[i], (const __nv_bfloat16*)bs[i],
                      (__nv_bfloat16*)ys[i], ns[i], tiles};
    tiles += ns[i] / BN;
  }
  if (tiles == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (m <= 8) return (int)launch<1>(args, tiles, st);
  if (m <= 16) return (int)launch<2>(args, tiles, st);
  if (m <= 32) return (int)launch<4>(args, tiles, st);
  if (m <= 64) return (int)launch<8>(args, tiles, st);
  if (m <= 128) return (int)launch<16>(args, tiles, st);
  if (m <= 160) return (int)launch<20>(args, tiles, st);
  return (int)launch<32>(args, tiles, st);
}
