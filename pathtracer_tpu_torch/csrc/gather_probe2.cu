// Gather probes P6-P9 for Hopper: the decomposed per-lane gathers that
// the TPU needed because Mosaic had no general vector gather.
//
// Replace the TPU Pallas probes of tools/probe_pallas_gather2.py: k_sub
// (P6, :62), k_lane (P7, :81), k_two (P8, :102) and k_mxu (P9, :145). Each
// computes what its plain PyTorch version in
// pathtracer_tpu_torch/probes/gather2.py computes, bit for bit (they move
// words, and P9 adds exact zeros). Rows are kLanes = 128 wide, the TPU's
// lane width, as in the tool.
//
//   gather_sublane (P6) out[s, l] = data[idx[s, l], l]: one thread per
//                  output. The (548, 128) table is 280,576 bytes, more
//                  than the 227 KB of shared memory a block can hold (the
//                  TPU kept it in VMEM), so reads go through L1 / L2
//                  (__ldg); it stays in the 50 MB L2 across calls.
//   gather_lane    (P7) out[s, l] = data[s, idx[s, l]]: one block of 128
//                  threads per row; the row (512 B) is staged in shared
//                  memory and thread l reads row[idx[s, l]]. The Hopper
//                  form of the TPU's lane shuffle: a warp shuffle reaches
//                  only 32 lanes.
//   gather_two_step (P8) the TPU body as written: chunk = idx >> 7,
//                  lp = idx & 127, cas[s, l] = chunk[s, lp[s, l]],
//                  t2[s, l] = flat2[cas[s, l], l], out[s, l] = t2[s, lp[s, l]].
//                  One block per row; chunk, then t2, are staged in shared
//                  memory, so the three gathers are one kernel. (This is
//                  not flat[idx]: the tool's decomposition is only right
//                  where a row's lanes share their chunk.)
//   onehot_matmul  (P9) out = onehot(idx) @ tbl, (rows, 128) x (128, 128):
//                  the product is computed here, in FP32 multiplies and
//                  adds (kept apart by -fmad=false) over k in ascending
//                  order, with the 64 KB table in shared memory and the
//                  one-hot built in registers. No tensor cores, no cuBLAS.
//                  Exact: every output sums one product 1 * x and 127
//                  products 0 * x.
//
// What bounds them on an H100: P6-P8 move under 0.35 MB, far below the
// launch overhead of a few microseconds. P9 writes 4 MiB (1.25 us at
// 3.35 TB/s) and performs 2 * 8,192 * 128 * 128 = 268 MFLOP (4.0 us at
// the 67 TFLOP/s FP32 rate): the FP32 arithmetic sets its bound. Each
// thread keeps a column of 16 rows in registers per pass over the table,
// so a shared-memory read feeds 16 multiply-adds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kMxuRowsPerBlock = 64;
constexpr int kMxuRowsPerPass = 16;
constexpr int kMxuSmemBytes = kLanes * kLanes * 4 + kMxuRowsPerBlock * 4;

__global__ void gather_sublane_kernel(const float* __restrict__ data,
                                      const int32_t* __restrict__ idx,
                                      int n_out, int c,
                                      float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_out) return;
  const int l = k & (kLanes - 1);
  const int row = idx[k];
  if ((unsigned)row >= (unsigned)c) __trap();
  out[k] = __ldg(data + (long)row * kLanes + l);
}

__global__ void gather_lane_kernel(const float* __restrict__ data,
                                   const int32_t* __restrict__ idx,
                                   float* __restrict__ out) {
  __shared__ float row[kLanes];
  const long base = (long)blockIdx.x * kLanes;
  const int l = threadIdx.x;
  row[l] = data[base + l];
  __syncthreads();
  const int src = idx[base + l];
  if ((unsigned)src >= (unsigned)kLanes) __trap();
  out[base + l] = row[src];
}

__global__ void gather_two_step_kernel(const float* __restrict__ flat2,
                                       const int32_t* __restrict__ idx,
                                       int c, float* __restrict__ out) {
  __shared__ int32_t chunk[kLanes];
  __shared__ float t2[kLanes];
  const long base = (long)blockIdx.x * kLanes;
  const int l = threadIdx.x;
  const int i = idx[base + l];
  if (i < 0 || i >= c * kLanes) __trap();
  const int lp = i & (kLanes - 1);
  chunk[l] = i >> 7;
  __syncthreads();
  const int cas = chunk[lp];  // the chunk of the lane this lane reads
  t2[l] = flat2[(long)cas * kLanes + l];
  __syncthreads();
  out[base + l] = t2[lp];
}

__global__ void onehot_matmul_kernel(const float* __restrict__ tbl,
                                     const int32_t* __restrict__ idx,
                                     int n_rows, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* table = smem;                                 // (128, 128)
  int32_t* rows = (int32_t*)(smem + kLanes * kLanes);  // this block's idx
  const int col = threadIdx.x;
  const int row0 = blockIdx.x * kMxuRowsPerBlock;
  for (int k = col; k < kLanes * kLanes; k += kLanes) table[k] = tbl[k];
  for (int r = col; r < kMxuRowsPerBlock; r += kLanes) {
    const int g = row0 + r;
    int v = 0;
    if (g < n_rows) {
      v = idx[g];
      if ((unsigned)v >= (unsigned)kLanes) __trap();
    }
    rows[r] = v;
  }
  __syncthreads();
  for (int r0 = 0; r0 < kMxuRowsPerBlock; r0 += kMxuRowsPerPass) {
    float acc[kMxuRowsPerPass];
    int hot[kMxuRowsPerPass];
#pragma unroll
    for (int r = 0; r < kMxuRowsPerPass; ++r) {
      acc[r] = 0.f;
      hot[r] = rows[r0 + r];
    }
    for (int k = 0; k < kLanes; ++k) {
      const float t = table[k * kLanes + col];
#pragma unroll
      for (int r = 0; r < kMxuRowsPerPass; ++r) {
        const float onehot = hot[r] == k ? 1.f : 0.f;
        acc[r] = acc[r] + onehot * t;
      }
    }
#pragma unroll
    for (int r = 0; r < kMxuRowsPerPass; ++r) {
      const int g = row0 + r0 + r;
      if (g < n_rows) out[(long)g * kLanes + col] = acc[r];
    }
  }
}

int blocks_for(long threads) {
  return (int)((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C launchers for ctypes. All pointers are device pointers; `rows`
// is the number of 128-lane index rows. An index outside its table stops
// the kernel with a trap. Each launches on `stream` and returns the
// launch's cudaError_t (0 = cudaSuccess) without synchronising.
extern "C" int pt_gather_sublane_launch(const float* data, const int32_t* idx,
                                        int rows, int c, float* out,
                                        void* stream) {
  const int n_out = rows * kLanes;
  if (n_out == 0) return 0;
  gather_sublane_kernel<<<blocks_for(n_out), kThreads, 0,
                          (cudaStream_t)stream>>>(data, idx, n_out, c, out);
  return (int)cudaGetLastError();
}

extern "C" int pt_gather_lane_launch(const float* data, const int32_t* idx,
                                     int rows, float* out, void* stream) {
  if (rows == 0) return 0;
  gather_lane_kernel<<<rows, kLanes, 0, (cudaStream_t)stream>>>(data, idx,
                                                                out);
  return (int)cudaGetLastError();
}

extern "C" int pt_gather_two_step_launch(const float* flat2,
                                         const int32_t* idx, int rows, int c,
                                         float* out, void* stream) {
  if (rows == 0) return 0;
  gather_two_step_kernel<<<rows, kLanes, 0, (cudaStream_t)stream>>>(
      flat2, idx, c, out);
  return (int)cudaGetLastError();
}

extern "C" int pt_onehot_matmul_launch(const float* tbl, const int32_t* idx,
                                       int n_rows, float* out, void* stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        onehot_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMxuSmemBytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  if (n_rows == 0) return 0;
  const int blocks = (n_rows + kMxuRowsPerBlock - 1) / kMxuRowsPerBlock;
  onehot_matmul_kernel<<<blocks, kLanes, kMxuSmemBytes,
                         (cudaStream_t)stream>>>(tbl, idx, n_rows, out);
  return (int)cudaGetLastError();
}
