// The tensor-parallel group's all-reduce on the device, for Hopper (sm_90a).
//
// Replaces no TPU kernel. It is the port's counterpart of the psum that
// XLA inserts for the JAX package's tp axis (whisperkit_tpu/parallel/
// sharding.py): the ranks of one group are threads of one process
// (parallel/mesh.py), each launching onto its own stream, on replicas of
// one card or on cards with peer access, and a rank's step must run as a
// CUDA graph, so the collective cannot be a host barrier or NCCL (one
// process per rank, never two ranks on one device).
//
// What it computes: every rank writes ((x_0 + x_1) + x_2) + ... in rank
// order, rounding to the working type after every add (bf16 rounds to
// nearest even, as torch.add on bf16 does), or the element-wise maximum
// (NaN-propagating, as torch.maximum). So every rank holds the same bits,
// those of the rank-ordered fold in parallel/group.py.
//
// Protocol (one launch per call of at most `slot_bytes`; the wrapper
// chunks larger tensors):
//   * each rank owns, at fixed addresses for the group's life, a staging
//     buffer of two slots, an inbox of flags [MAX_BLOCKS][MAX_RANKS] and a
//     control word {seq, count, err}; the host owns a mapped word array
//     {abort, err of rank 0, ...}.
//   * the launch reads seq from its control word and takes s = seq + 1:
//     the sequence is advanced by the kernel itself (its last block to
//     finish), so an eager call and a graph replay pair up with no host
//     input, as long as every rank makes the same calls in the same order.
//   * block b copies its range of x into slot s & 1 of its own staging,
//     then publishes s into inbox[b][rank] of every rank (st.release.sys
//     after a system fence), waits until every rank's inbox[b][p] >= s
//     (ld.acquire.sys), and sums the ranks' slots over its range in rank
//     order (L2-coherent loads: a peer wrote them after this SM may have
//     cached the lines).
//   * slot reuse: a rank writes slot s & 1 again at call s + 2 only after
//     its own call s + 1 saw every peer's flag for s + 1, i.e. after every
//     peer had started call s + 1 and so finished call s (each rank's
//     calls are ordered on its stream), so no peer still reads it.
//   * bounded spin: a waiting thread polls the host's abort word every 64
//     polls and gives up after `timeout_ns` (%globaltimer). On either it
//     writes its error into its control word and the host words and sets
//     the abort word, so the peers' waits end too; every later launch of
//     the rank exits at once until the host resets the group
//     (TPGroup.reset), and the host raises GroupAborted where it syncs.
//
// What bounds it: at the decode step's shape (B = 32 rows of 1280 bf16,
// 80 KB) the bytes are nothing (each rank reads tp x 80 KB and writes
// 80 KB: ~0.07 us at 3.35 TB/s); a call costs the flag round trip between
// the ranks, a few microseconds. At the encoder's shape (32 x 1500 x 1280
// bf16, 123 MB a rank, in 16 MB chunks) it is bandwidth: the design moves
// each byte through the staging buffer once more than the bound counts.
// Up to 32 blocks of 512 threads keep the staging copy and the reduction
// wide while leaving the SMs for the peers' kernels, which on replicas of
// one card must run beside the waiting blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int MAX_RANKS = 8;
constexpr int MAX_BLOCKS = 32;
constexpr int NT = 512;

enum { DT_BF16 = 0, DT_F32 = 1, DT_F64 = 2 };
enum { OP_SUM = 0, OP_MAX = 1 };
enum { ERR_TIMEOUT = 1, ERR_ABORTED = 2 };

struct Ctrl {
  unsigned long long seq;  // the last call this rank completed
  unsigned int count;      // blocks of the current call that have finished
  unsigned int err;        // sticky: the rank's first failure
};

struct Args {
  uint8_t* stage[MAX_RANKS];               // each rank's two staging slots
  unsigned long long* inbox[MAX_RANKS];    // each rank's flags [MAX_BLOCKS][MAX_RANKS]
  Ctrl* ctrl;                              // this rank's
  volatile int* host;                      // mapped: [0] abort, [1 + r] rank r's error
  const void* x;
  void* y;
  long long n;           // elements of this call
  long long slot_bytes;  // bytes of one staging slot
  long long timeout_ns;
  int rank, tp;
};

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// one rounded step of the fold, as torch.add / torch.maximum compute it
__device__ __forceinline__ __nv_bfloat16 step(__nv_bfloat16 a, __nv_bfloat16 b, int op) {
  const float fa = __bfloat162float(a), fb = __bfloat162float(b);
  if (op == OP_MAX) return (isnan(fa) || fa > fb) ? a : b;
  return __float2bfloat16_rn(__fadd_rn(fa, fb));
}
__device__ __forceinline__ float step(float a, float b, int op) {
  if (op == OP_MAX) return (isnan(a) || a > b) ? a : b;
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double step(double a, double b, int op) {
  if (op == OP_MAX) return (isnan(a) || a > b) ? a : b;
  return __dadd_rn(a, b);
}

// VEC elements of T in one load: 16 bytes, or one element
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float ld1(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ld1(const double* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ld1(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// a pack of a peer's staging, through L2 (ld.global.cg)
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_cg(const Pack<T, VEC>* p) {
  Pack<T, VEC> out;
  if constexpr (VEC > 1) {
    static_assert(sizeof(Pack<T, VEC>) == 16, "a pack is 16 bytes");
    const int4 raw = __ldcg(reinterpret_cast<const int4*>(p));
    memcpy(&out, &raw, 16);
  } else {
    out.v[0] = ld1(reinterpret_cast<const T*>(p));
  }
  return out;
}

__device__ void fail(const Args& a, int code) {
  atomicCAS(&a.ctrl->err, 0u, (unsigned)code);
  a.host[1 + a.rank] = code;
  a.host[0] = 1;  // end the peers' waits too
  __threadfence_system();
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NT) tp_all_reduce_kernel(Args a, int op) {
  using P = Pack<T, VEC>;
  __shared__ unsigned long long s_seq;
  __shared__ int s_err;
  if (threadIdx.x == 0) {
    s_seq = a.ctrl->seq + 1;
    s_err = a.ctrl->err ? -1 : 0;
  }
  __syncthreads();
  if (s_err) return;  // a failed group stays failed until the host resets it
  const unsigned long long seq = s_seq;
  const int b = blockIdx.x;
  const long long units = a.n / VEC;
  const long long per = (units + gridDim.x - 1) / gridDim.x;
  const long long lo = (long long)b * per;
  const long long hi = lo + per < units ? lo + per : units;
  const size_t slot = (size_t)(seq & 1) * (size_t)a.slot_bytes;

  // 1. this rank's range into its staging slot
  P* mine = reinterpret_cast<P*>(a.stage[a.rank] + slot);
  const P* x = reinterpret_cast<const P*>(a.x);
  for (long long i = lo + threadIdx.x; i < hi; i += NT) mine[i] = x[i];
  __syncthreads();

  // 2. publish it to every rank, then wait for every rank's
  if (threadIdx.x < a.tp) {
    __threadfence_system();
    st_release(a.inbox[threadIdx.x] + b * MAX_RANKS + a.rank, seq);
    const unsigned long long* flag = a.inbox[a.rank] + b * MAX_RANKS + threadIdx.x;
    if (ld_acquire(flag) < seq) {
      const unsigned long long t0 = now_ns();
      unsigned int polls = 0;
      while (ld_acquire(flag) < seq) {
        if ((++polls & 63u) == 0) {
          if (a.host[0]) {
            atomicExch(&s_err, ERR_ABORTED);
            break;
          }
          if (now_ns() - t0 > (unsigned long long)a.timeout_ns) {
            atomicExch(&s_err, ERR_TIMEOUT);
            break;
          }
        }
      }
    }
    __threadfence_system();
  }
  __syncthreads();
  if (s_err) {
    if (threadIdx.x == 0) fail(a, s_err);
    return;
  }

  // 3. the ranks' slots folded in rank order
  P* y = reinterpret_cast<P*>(a.y);
  for (long long i = lo + threadIdx.x; i < hi; i += NT) {
    P acc = load_cg(reinterpret_cast<const P*>(a.stage[0] + slot) + i);
    for (int p = 1; p < a.tp; ++p) {
      const P v = load_cg(reinterpret_cast<const P*>(a.stage[p] + slot) + i);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc.v[k] = step(acc.v[k], v.v[k], op);
    }
    y[i] = acc;
  }

  // 4. the last block to finish advances the rank's sequence
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&a.ctrl->count, 1u) == gridDim.x - 1) {
      a.ctrl->count = 0;
      a.ctrl->seq = seq;
      __threadfence();
    }
  }
}

template <typename T>
cudaError_t launch(const Args& a, int op, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = ((uintptr_t)a.x % 16 == 0) && ((uintptr_t)a.y % 16 == 0) && a.n % VEC == 0;
  const long long units = vec ? a.n / VEC : a.n;
  long long grid = (units + NT - 1) / NT;
  grid = grid < 1 ? 1 : (grid > MAX_BLOCKS ? MAX_BLOCKS : grid);
  if (vec)
    tp_all_reduce_kernel<T, VEC><<<(int)grid, NT, 0, stream>>>(a, op);
  else
    tp_all_reduce_kernel<T, 1><<<(int)grid, NT, 0, stream>>>(a, op);
  return cudaGetLastError();
}

}  // namespace

// One all-reduce call of rank `rank` of `tp`: `stages` and `inboxes` (host
// arrays of tp device pointers) are every rank's staging buffer and inbox,
// `ctrl` this rank's control word, `host` the group's mapped word array.
// x and y hold n elements of `dtype` (0 bf16, 1 f32, 2 f64); `op` 0 sums,
// 1 takes the maximum (f32 only). n x the element size must fit one slot.
extern "C" int wk_tp_all_reduce(const long long* stages, const long long* inboxes, int tp, int rank,
                                void* ctrl, void* host, const void* x, void* y, long long n,
                                int dtype, int op, long long slot_bytes, long long timeout_ns,
                                void* stream) {
  if (tp < 1 || tp > MAX_RANKS || rank < 0 || rank >= tp || n <= 0 || slot_bytes % 16)
    return (int)cudaErrorInvalidValue;
  const long long es = dtype == DT_BF16 ? 2 : dtype == DT_F32 ? 4 : dtype == DT_F64 ? 8 : 0;
  if (!es || (op != OP_SUM && op != OP_MAX) || (op == OP_MAX && dtype != DT_F32) ||
      n * es > slot_bytes)
    return (int)cudaErrorInvalidValue;
  Args a{};
  for (int r = 0; r < tp; ++r) {
    a.stage[r] = (uint8_t*)stages[r];
    a.inbox[r] = (unsigned long long*)inboxes[r];
  }
  a.ctrl = (Ctrl*)ctrl;
  a.host = (volatile int*)host;
  a.x = x;
  a.y = y;
  a.n = n;
  a.slot_bytes = slot_bytes;
  a.timeout_ns = timeout_ns;
  a.rank = rank;
  a.tp = tp;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_BF16) return (int)launch<__nv_bfloat16>(a, op, st);
  if (dtype == DT_F32) return (int)launch<float>(a, op, st);
  return (int)launch<double>(a, op, st);
}

// Let device `dev` read and write device `peer`'s memory; the calling
// thread's current device is kept. Returns -1 where the hardware has no
// path between them, else the CUDA status (an access already enabled is 0).
extern "C" int wk_tp_enable_peer(int dev, int peer) {
  int prev = 0, can = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return -1;
  e = cudaSetDevice(dev);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return (int)e;
}

// `bytes` of zeroed page-locked host memory, mapped for every device:
// its host address in *host and its device address in *dev.
extern "C" int wk_tp_host_alloc(long long bytes, void** host, void** dev) {
  cudaError_t e = cudaHostAlloc(host, (size_t)bytes, cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return (int)e;
  memset(*host, 0, (size_t)bytes);
  return (int)cudaHostGetDevicePointer(dev, *host, 0);
}

extern "C" int wk_tp_host_free(void* host) { return (int)cudaFreeHost(host); }

