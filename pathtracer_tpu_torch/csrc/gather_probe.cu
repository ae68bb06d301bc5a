// Gather probes P1-P5 for Hopper: the two memory operations of the BVH32
// traversal (kernel K2, csrc/bvhw.cu) in isolation.
//
// Replace the TPU Pallas probes of tools/probe_pallas_gather.py: k_take
// (P1) and k_getitem (P2, the same function written with another idiom),
// k_lane (P3), k_scalar (P4) and k_stack / run_stack (P5). Each computes
// what its plain PyTorch version in pathtracer_tpu_torch/probes/gather.py
// computes, bit for bit (they only move words).
//
//   gather_rows      (P1, P2) out[n, c] = table[idx[n], c] on a row-major
//                    (M, W) table: one thread per (lane, column), so a
//                    warp reads 32 / W whole rows, each W words contiguous;
//   gather_cols      (P3) out[c, n] = table_t[c, idx[n]] on the
//                    column-major (W, M) table: one thread per lane in
//                    64-thread blocks, its W loads (M words apart) all in
//                    flight before its first store;
//   gather_rows_warp (P4) one warp per output row with a warp-uniform
//                    index: the SIMT form of a scalar-index row loop, and
//                    what a warp-cooperative node fetch would pay in K2;
//   stack_push_read  (P5) a per-thread stack of `depth` floats, a column
//                    of a slab in shared memory, written at a dynamic
//                    index sp[n] and read back there: what K2's short
//                    stack costs.
//
// What bounds them on an H100: memory latency and the launch, not
// bandwidth. The probe's table is 65,536 x 8 f32 = 2 MB and stays in the
// 50 MB L2 across calls; 8,192 lanes read 256 KB. A one-lane launch takes
// most of a probe's device time; to keep the latency above it short, P3
// and P5 put 64 threads in a block: 128 blocks at 8,192 lanes, work on
// almost every SM. P5's push and read go through shared memory, each
// thread of a warp in a bank of its own.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDepth = 64;
// threads a block of gather_cols and stack_push_read (probe_variants.py
// builds other sizes)
#ifndef P3_THREADS
#define P3_THREADS 64
#endif
#ifndef P5_THREADS
#define P5_THREADS 64
#endif
static_assert(P5_THREADS * kMaxDepth * 4 <= 48 * 1024,
              "the stack slab must fit the default shared memory");

__global__ void gather_rows_kernel(const float* __restrict__ table,
                                   const int32_t* __restrict__ idx, int n,
                                   int m, int w, float* __restrict__ out) {
  const long k = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long)n * w) return;
  const int lane = (int)(k / w);
  const int c = (int)(k - (long)lane * w);
  const int row = idx[lane];
  if ((unsigned)row >= (unsigned)m) __trap();
  out[k] = table[(long)row * w + c];
}

// One thread per lane, all W of its table loads issued before its first
// store: W is a template parameter (8, the probe's width; 0 is the loop
// for any other width). A warp's idx load and each of its W stores are 32
// consecutive words; its W table loads are the only scattered sectors.
template <int WT>
__global__ void gather_cols_kernel(const float* __restrict__ table_t,
                                   const int32_t* __restrict__ idx, int n,
                                   int m, int w, float* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int row = idx[lane];
  if ((unsigned)row >= (unsigned)m) __trap();
  if constexpr (WT > 0) {
    float vals[WT];
#pragma unroll
    for (int c = 0; c < WT; ++c) vals[c] = table_t[c * (long)m + row];
#pragma unroll
    for (int c = 0; c < WT; ++c) out[(long)c * n + lane] = vals[c];
  } else {
    for (int c = 0; c < w; ++c) {
      out[(long)c * n + lane] = table_t[c * (long)m + row];
    }
  }
}

__global__ void gather_rows_warp_kernel(const float* __restrict__ table,
                                        const int32_t* __restrict__ idx,
                                        int n, int m, int w,
                                        float* __restrict__ out) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;
  const int row = idx[warp];  // the same index in every thread of the warp
  if ((unsigned)row >= (unsigned)m) __trap();
  for (int c = lane; c < w; c += 32) {
    out[(long)warp * w + c] = table[(long)row * w + c];
  }
}

// Each thread's stack is a column of a (depth, blockDim.x) slab of
// dynamic shared memory: entry k of thread t at k * blockDim.x + t, in
// bank t mod 32 whatever k, so a warp's push and read at 32 run-time
// indices are free of bank conflicts. `volatile` keeps the store and the
// load: the compiler cannot forward v to out. The slab is not zeroed: no
// output reads an entry this thread did not write.
__global__ void stack_push_read_kernel(const int32_t* __restrict__ sp,
                                       const float* __restrict__ v, int n,
                                       int depth, float* __restrict__ out) {
  extern __shared__ float slab[];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  volatile float* col = slab + threadIdx.x;
  const int s = sp[lane];
  if ((unsigned)s >= (unsigned)depth) __trap();
  col[s * blockDim.x] = v[lane];
  out[lane] = col[s * blockDim.x];
}

int blocks_for(long threads) {
  return (int)((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C launchers, called through pylaunch.c. All pointers are device
// pointers; an index outside its table (or sp outside [0, depth)) stops
// the kernel with a trap. Each launches on `stream` and returns the
// launch's cudaError_t (0 = cudaSuccess) without synchronising.
extern "C" int pt_gather_rows_launch(const float* table, const int32_t* idx,
                                     int n, int m, int w, float* out,
                                     void* stream) {
  gather_rows_kernel<<<blocks_for((long)n * w), kThreads, 0,
                       (cudaStream_t)stream>>>(table, idx, n, m, w, out);
  return (int)cudaGetLastError();
}

extern "C" int pt_gather_cols_launch(const float* table_t, const int32_t* idx,
                                     int n, int m, int w, float* out,
                                     void* stream) {
  const int blocks = (n + P3_THREADS - 1) / P3_THREADS;
  if (w == 8) {
    gather_cols_kernel<8><<<blocks, P3_THREADS, 0, (cudaStream_t)stream>>>(
        table_t, idx, n, m, w, out);
  } else {
    gather_cols_kernel<0><<<blocks, P3_THREADS, 0, (cudaStream_t)stream>>>(
        table_t, idx, n, m, w, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int pt_gather_rows_warp_launch(const float* table,
                                          const int32_t* idx, int n, int m,
                                          int w, float* out, void* stream) {
  gather_rows_warp_kernel<<<blocks_for(32L * n), kThreads, 0,
                            (cudaStream_t)stream>>>(table, idx, n, m, w, out);
  return (int)cudaGetLastError();
}

extern "C" int pt_stack_push_read_launch(const int32_t* sp, const float* v,
                                         int n, int depth, float* out,
                                         void* stream) {
  if (depth < 1 || depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  const int blocks = (n + P5_THREADS - 1) / P5_THREADS;
  const size_t slab = sizeof(float) * depth * P5_THREADS;
  stack_push_read_kernel<<<blocks, P5_THREADS, slab, (cudaStream_t)stream>>>(
      sp, v, n, depth, out);
  return (int)cudaGetLastError();
}
