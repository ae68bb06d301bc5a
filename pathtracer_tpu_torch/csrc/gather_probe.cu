// Gather probes P1-P5 for Hopper: the two memory operations of the BVH32
// traversal (kernel K2, csrc/bvhw.cu) in isolation.
//
// Replace the TPU Pallas probes of tools/probe_pallas_gather.py: k_take
// (P1) and k_getitem (P2, the same function written with another idiom),
// k_lane (P3), k_scalar (P4) and k_stack / run_stack (P5). Each computes
// what its plain PyTorch version in pathtracer_tpu_torch/probes/gather.py
// computes, bit for bit (they only move words).
//
//   gather_rows      (P1, P2) out[n, :] = table[idx[n], :] on a row-major
//                    (M, W) table: at W = 8, with table and out 16-byte
//                    aligned, one thread per float4 of the output in
//                    128-thread blocks (two a row; 128 blocks at 8,192
//                    lanes): one idx load, one LDG.128 and one STG.128 a
//                    thread, a warp's stores 512 consecutive bytes. Any
//                    other width or alignment takes a 2-D grid of words
//                    (lanes along x, columns along y);
//   gather_cols      (P3) out[c, n] = table_t[c, idx[n]] on the
//                    column-major (W, M) table: one thread per lane in
//                    64-thread blocks, its W loads (M words apart) all in
//                    flight before its first store;
//   gather_rows_warp (P4) as gather_rows, a warp a run of P4_ROWS = 16
//                    rows in 128-thread blocks (128 blocks at 8,192
//                    lanes): lane l loads the run's index l (one coalesced
//                    load), then pairs of lanes copy a row each, a float4
//                    a lane, 16 rows a pass, each pair taking its row's
//                    index from the lane that holds it by __shfl_sync: the
//                    SIMT form of a scalar index shared by the lanes, and
//                    the fetch K2 would make with several rays a warp;
//   stack_push_read  (P5) a per-thread stack of `depth` floats, a column
//                    of a slab in shared memory, written at a dynamic
//                    index sp[n] and read back there: what K2's short
//                    stack costs.
//
// What bounds them on an H100: memory latency and the launch, not
// bandwidth. The probe's table is 65,536 x 8 f32 = 2 MB and stays in the
// 50 MB L2 across calls; 8,192 lanes read 256 KB. A one-lane launch takes
// most of a probe's device time; to keep the latency above it short,
// every kernel here gives each thread its loads before its stores and
// launches 128 blocks at 8,192 lanes, work on almost every SM: 64 threads
// a block for P3 and P5, 128 for P1 (a thread a float4) and P4. P5's
// push and read go through shared memory, each thread of a warp in a bank
// of its own.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDepth = 64;
constexpr unsigned kFullMask = 0xffffffffu;
// threads a block of each kernel and rows a warp of gather_rows_warp
// (probe_variants.py builds other sizes)
#ifndef P1_THREADS
#define P1_THREADS 128
#endif
#ifndef P3_THREADS
#define P3_THREADS 64
#endif
#ifndef P4_THREADS
#define P4_THREADS 128
#endif
#ifndef P4_ROWS
#define P4_ROWS 16
#endif
#ifndef P5_THREADS
#define P5_THREADS 64
#endif
static_assert(P5_THREADS * kMaxDepth * 4 <= 48 * 1024,
              "the stack slab must fit the default shared memory");
static_assert(P4_THREADS % 32 == 0, "gather_rows_warp runs whole warps");
static_assert(P4_ROWS >= 1 && P4_ROWS <= 32,
              "a warp's row indices fit its lanes");

// One thread per float4 of the output, V = W / 4 threads a row: the
// launcher takes it only where table and out are 16-byte aligned, so every
// row starts on 16 bytes. V is a template parameter (2, the probe's width
// of 8, the one it launches): the divisions by V are shifts. Each thread
// loads its lane's index (the V threads of a row load the same word), one
// LDG.128 and one STG.128; a warp stores 512 consecutive bytes.
template <int V>
__global__ void gather_rows_kernel(const float4* __restrict__ table,
                                   const int32_t* __restrict__ idx, int n,
                                   int m, float4* __restrict__ out) {
  const long k = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long)n * V) return;
  const int lane = (int)(k / V);
  const int row = idx[lane];
  if ((unsigned)row >= (unsigned)m) __trap();
  out[k] = table[(long)row * V + (int)(k % V)];
}

// Any other width or alignment: one thread per (lane, column) on a 2-D
// grid, lanes along x and columns along y (a grid-stride loop past 65,535
// columns), so no thread divides.
__global__ void gather_rows_words_kernel(const float* __restrict__ table,
                                         const int32_t* __restrict__ idx,
                                         int n, int m, int w,
                                         float* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int row = idx[lane];
  if ((unsigned)row >= (unsigned)m) __trap();
  for (int c = blockIdx.y; c < w; c += gridDim.y) {
    out[(long)lane * w + c] = table[(long)row * w + c];
  }
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

// A warp copies the run of P4_ROWS output rows that starts at `base`. Lane
// l < P4_ROWS loads idx[base + l] (one coalesced load for the run); each
// row's index then reaches the lanes that copy the row by __shfl_sync from
// the lane that holds it. W is a template parameter: 8, the probe's width,
// on 16-byte aligned pointers (the launcher checks): pairs of lanes a row,
// a float4 each, 16 rows a pass, every table load of a thread issued
// before its first store; 0 is the loop for any other width or alignment
// (a row at a time, lanes along the columns). A ragged last run keeps all
// 32 lanes to the shuffles and guards only its loads and stores.
template <int WT>
__global__ void gather_rows_warp_kernel(const float* __restrict__ table,
                                        const int32_t* __restrict__ idx,
                                        int n, int m, int w,
                                        float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long base =
      ((long)blockIdx.x * blockDim.x + threadIdx.x) / 32 * P4_ROWS;
  if (base >= n) return;  // the whole warp: base is one value in a warp
  const long left = n - base;
  const int rows = left < P4_ROWS ? (int)left : P4_ROWS;
  int mine = 0;
  if (lane < rows) {
    mine = idx[base + lane];
    if ((unsigned)mine >= (unsigned)m) __trap();
  }
  if constexpr (WT > 0) {
    constexpr int kVec = WT / 4;       // lanes a row, a float4 each
    constexpr int kGroup = 32 / kVec;  // rows a pass
    constexpr int kPasses = (P4_ROWS + kGroup - 1) / kGroup;
    static_assert(WT % 4 == 0 && 32 % kVec == 0, "whole rows a pass");
    const int g = lane / kVec, h = lane % kVec;
    const float4* t4 = reinterpret_cast<const float4*>(table);
    float4* o4 = reinterpret_cast<float4*>(out);
    float4 vals[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = p * kGroup + g;
      const int row = __shfl_sync(kFullMask, mine, r);
      if (r < rows) vals[p] = t4[(long)row * kVec + h];
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = p * kGroup + g;
      if (r < rows) o4[(base + r) * kVec + h] = vals[p];
    }
  } else {
    for (int r = 0; r < rows; ++r) {  // rows is one value in a warp
      const int row = __shfl_sync(kFullMask, mine, r);
      for (int c = lane; c < w; c += 32) {
        out[(base + r) * w + c] = table[(long)row * w + c];
      }
    }
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

bool aligned16(const float* a, const float* b) {
  return (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
}

}  // namespace

// Plain C launchers, called through pylaunch.c. All pointers are device
// pointers; an index outside its table (or sp outside [0, depth)) stops
// the kernel with a trap. Each launches on `stream` and returns the
// launch's cudaError_t (0 = cudaSuccess) without synchronising.
extern "C" int pt_gather_rows_launch(const float* table, const int32_t* idx,
                                     int n, int m, int w, float* out,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  // float4 at W = 8 where every row starts on 16 bytes, both pointers
  // 16-byte aligned (a view at an offset may not be); else words
  if (w == 8 && aligned16(table, out)) {
    gather_rows_kernel<2>
        <<<(int)((2L * n + P1_THREADS - 1) / P1_THREADS), P1_THREADS, 0,
           s>>>(reinterpret_cast<const float4*>(table), idx, n, m,
                reinterpret_cast<float4*>(out));
  } else {
    const dim3 grid((int)(((long)n + P1_THREADS - 1) / P1_THREADS),
                    w < 65535 ? w : 65535);
    gather_rows_words_kernel<<<grid, P1_THREADS, 0, s>>>(table, idx, n, m, w,
                                                         out);
  }
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
  constexpr long kRowsABlock = P4_ROWS * (P4_THREADS / 32);
  const int blocks = (int)(((long)n + kRowsABlock - 1) / kRowsABlock);
  cudaStream_t s = (cudaStream_t)stream;
  if (w == 8 && aligned16(table, out)) {
    gather_rows_warp_kernel<8><<<blocks, P4_THREADS, 0, s>>>(table, idx, n, m,
                                                             w, out);
  } else {
    gather_rows_warp_kernel<0><<<blocks, P4_THREADS, 0, s>>>(table, idx, n, m,
                                                             w, out);
  }
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
