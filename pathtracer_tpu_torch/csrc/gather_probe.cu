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
//                    column-major (W, M) table: one thread per lane,
//                    reading W words M apart (a warp's reads of one column
//                    are scattered, like the TPU's lane-dim gather);
//   gather_rows_warp (P4) one warp per output row with a warp-uniform
//                    index: the SIMT form of a scalar-index row loop, and
//                    what a warp-cooperative node fetch would pay in K2;
//   stack_push_read  (P5) a per-thread stack of `depth` floats in local
//                    memory, zeroed, written at a dynamic index sp[n] and
//                    read back there: what K2's short stack costs.
//
// What bounds them on an H100: memory latency, not bandwidth. The probe's
// table is 65,536 x 8 f32 = 2 MB and stays in the 50 MB L2 across calls;
// 8,192 lanes read 256 KB. The stack lives in local memory, which is
// cached in L1; `volatile` keeps the compiler from forwarding the stored
// value to the load, so the probe pays for the round trip K2's dynamic
// stack index forces.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDepth = 64;

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

__global__ void gather_cols_kernel(const float* __restrict__ table_t,
                                   const int32_t* __restrict__ idx, int n,
                                   int m, int w, float* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int row = idx[lane];
  if ((unsigned)row >= (unsigned)m) __trap();
  for (int c = 0; c < w; ++c) {
    out[(long)c * n + lane] = table_t[c * (long)m + row];
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

__global__ void stack_push_read_kernel(const int32_t* __restrict__ sp,
                                       const float* __restrict__ v, int n,
                                       int depth, float* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  volatile float stack[kMaxDepth];
  for (int k = 0; k < depth; ++k) stack[k] = 0.f;
  const int s = sp[lane];
  if ((unsigned)s >= (unsigned)depth) __trap();
  stack[s] = v[lane];
  out[lane] = stack[s];
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
  gather_cols_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      table_t, idx, n, m, w, out);
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
  stack_push_read_kernel<<<blocks_for(n), kThreads, 0,
                           (cudaStream_t)stream>>>(sp, v, n, depth, out);
  return (int)cudaGetLastError();
}
