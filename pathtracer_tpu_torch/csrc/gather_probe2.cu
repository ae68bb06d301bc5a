// Gather probes P6-P9 for Hopper: the decomposed per-lane gathers that
// the TPU needed because Mosaic had no general vector gather.
//
// Replace the TPU Pallas probes of tools/probe_pallas_gather2.py: k_sub
// (P6, :62), k_lane (P7, :81), k_two (P8, :102) and k_mxu (P9, :145). Each
// computes what its plain PyTorch version in
// pathtracer_tpu_torch/probes/gather2.py computes, bit for bit (they move
// words; P9's closed form is the FP32 product's value). Rows are kLanes =
// 128 wide, the TPU's lane width, as in the tool.
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
//   onehot_matmul  (P9) out = onehot(idx) @ tbl, (rows, 128) x (128, 128),
//                  computed without arithmetic. The FP32 product sums, per
//                  output, one product 1 * tbl[idx[r], j] and 127 products
//                  0 * tbl[k, j]: each of those is a signed zero, or NaN
//                  where tbl[k, j] is inf or NaN. So, bit for bit off NaN
//                  (the ascending-k sum from +0, cuBLAS's FP32 GEMM and
//                  the TPU body's f32 jnp.dot all give it):
//                    out[r, j] = NaN  if column j holds a non-finite entry
//                                     in a row other than idx[r],
//                              = tbl[idx[r], j] + 0.0f otherwise
//                  (+ 0.0f turns -0 into +0 and keeps an inf or NaN of the
//                  selected row). No tensor cores, no cuBLAS.
//
// What bounds them on an H100: P6-P8 move under 0.35 MB, far below the
// launch overhead of a few microseconds. P9 is a row copy: it reads the 64
// KB table and 32 KB of indices and writes 4 MiB (4,292,608 bytes, 1.28 us
// at 3.35 TB/s), so bytes bound it. Its design: each block owns 256 output
// rows and one group of 32 columns (a 16 KB slice of the table) with 1,024
// threads. It stages that slice in shared memory with one 16-byte load a
// thread, counts each column's non-finite entries there (a shared atomic
// only for a non-finite entry), replaces every staged entry by the product's
// value for its row, then writes its rows' 128-byte segments with one
// 16-byte store a thread and row (eight threads a segment, so a warp writes
// four whole cache lines). The slice holds every row the block copies and
// every entry its column flags need, so the table is read 16 KB a block (2
// MB of L2 reads at the probe's 8,192 rows, half the output), not 64 KB a
// block: a block that staged the whole table to count its columns would read
// 8.4 MB. Plain 16-byte loads stage it: a bulk (TMA) copy would save
// registers, not time, and the counting reads the values anyway. 8,192 rows
// make 32 x 4 = 128 blocks, one wave on the 132 SMs; the slice is static
// shared memory under 48 KB, so the launch needs no opt-in on any device.
// The loads of the slice and the indices must arrive before the first store,
// so a block's start is latency that no store hides; 1,024 threads a block
// measured faster on an H100 than 512 or 256, than 16- or 64-column groups,
// and than reading each output row from the table in L2 instead of from the
// staged slice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kP9Cols = 32;                     // columns a block owns
constexpr int kP9Vec = kP9Cols / 4;             // float4s a row segment
constexpr int kP9Rows = 256;                    // rows a block owns
constexpr int kP9Threads = 1024;
constexpr int kP9SliceIters = kLanes * kP9Vec / kP9Threads;   // 1
constexpr int kP9RowIters = kP9Rows * kP9Vec / kP9Threads;    // 2

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

// inf or NaN: every exponent bit set
__device__ __forceinline__ int nonfinite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

__global__ void __launch_bounds__(kP9Threads)
onehot_matmul_kernel(const float* __restrict__ tbl,
                     const int32_t* __restrict__ idx, int n_rows,
                     float* __restrict__ out) {
  __shared__ float4 slice[kLanes * kP9Vec];  // (128 rows, 32 columns)
  __shared__ int bad[kP9Cols];  // non-finite entries of each column
  const int t = threadIdx.x;
  const int col0 = blockIdx.y * kP9Cols;
  const int row0 = blockIdx.x * kP9Rows;
  // issue every global load at once: this thread's indices, its slice
  int k[kP9RowIters];
#pragma unroll
  for (int i = 0; i < kP9RowIters; ++i) {
    const int r = row0 + (t + i * kP9Threads) / kP9Vec;
    k[i] = r < n_rows ? __ldg(idx + r) : 0;
  }
  float4 v[kP9SliceIters];
#pragma unroll
  for (int i = 0; i < kP9SliceIters; ++i) {
    const int e = t + i * kP9Threads;
    v[i] = __ldg(reinterpret_cast<const float4*>(
                     tbl + (e / kP9Vec) * kLanes + col0) + e % kP9Vec);
  }
  if (t < kP9Cols) bad[t] = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kP9SliceIters; ++i) {
    const int c = (t + i * kP9Threads) % kP9Vec * 4;
    if (nonfinite(v[i].x)) atomicAdd(&bad[c + 0], 1);
    if (nonfinite(v[i].y)) atomicAdd(&bad[c + 1], 1);
    if (nonfinite(v[i].z)) atomicAdd(&bad[c + 2], 1);
    if (nonfinite(v[i].w)) atomicAdd(&bad[c + 3], 1);
  }
  __syncthreads();
  // each staged entry becomes the product's value for a row selecting it
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int i = 0; i < kP9SliceIters; ++i) {
    const int e = t + i * kP9Threads;
    const int c = e % kP9Vec * 4;
    float4 p = v[i];
    p.x = bad[c + 0] > nonfinite(p.x) ? nan : __fadd_rn(p.x, 0.0f);
    p.y = bad[c + 1] > nonfinite(p.y) ? nan : __fadd_rn(p.y, 0.0f);
    p.z = bad[c + 2] > nonfinite(p.z) ? nan : __fadd_rn(p.z, 0.0f);
    p.w = bad[c + 3] > nonfinite(p.w) ? nan : __fadd_rn(p.w, 0.0f);
    slice[e] = p;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kP9RowIters; ++i) {
    const int e = t + i * kP9Threads;
    const int r = row0 + e / kP9Vec;
    if (r >= n_rows) break;
    if ((unsigned)k[i] >= (unsigned)kLanes) __trap();
    reinterpret_cast<float4*>(out + (long)r * kLanes + col0)[e % kP9Vec] =
        slice[k[i] * kP9Vec + e % kP9Vec];
  }
}

int blocks_for(long threads) {
  return (int)((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C launchers, called through pylaunch.c. All pointers are device
// pointers; `rows` is the number of 128-lane index rows. An index outside
// its table stops the kernel with a trap. Each launches on `stream` and
// returns the launch's cudaError_t (0 = cudaSuccess) without
// synchronising.
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
  if (n_rows == 0) return 0;
  const dim3 grid((n_rows + kP9Rows - 1) / kP9Rows, kLanes / kP9Cols);
  onehot_matmul_kernel<<<grid, kP9Threads, 0, (cudaStream_t)stream>>>(
      tbl, idx, n_rows, out);
  return (int)cudaGetLastError();
}
