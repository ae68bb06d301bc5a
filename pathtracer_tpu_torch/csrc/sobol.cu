// Kernel K7 (sobol_index, sobol_draw): the Sobol' sampler's sample index
// and its draws, a thread a lane, for Hopper.
//
// It replaces no Pallas kernel. It replaces the XLA chain of
// pathtracer_tpu/ops/sobol.py (sobol_index, sobol_sample_dim,
// sobol_sample_dim2: a masked XOR a table word, left to XLA's fusion),
// which eager PyTorch runs as pathtracer_tpu_torch/ops/sobol.py's
// bit-matrix chain: an (N, 52) int64 matrix of the index bits, its product
// with the table row ((N, 2, 52) for a pair) and an XOR reduction by
// strided halving, ~0.6 GB (one dimension) to ~0.87 GB (a pair) of device
// traffic a draw at 130,732 lanes. It computes exactly what the plain
// functions of pathtracer_tpu_torch/ops/sobol.py compute:
//   * sobol_index (once a band-frame): each lane's 64-bit sample index as
//     (lo, hi) words, the XOR of the inverse-vdc row's words at the set
//     bits of b_base ^ delta (32 bits), XORed with the frame's shifted
//     words;
//   * sobol_draw (once a draw): one dimension (sobol_sample_dim) or two
//     consecutive ones (sobol_sample_dim2), the XOR of the generator row's
//     words at the 52 low index bits (32 of lo, 20 of hi), XORed with the
//     lane's scramble (none: the camera's unscrambled dimensions), as a
//     float in [0, 1).
//
// What bounds it on an H100: bytes a lane at 3.35 TB/s, and the launch. A
// draw lane reads its index words (2 x 8 B, int64 as the plain chain keeps
// them) and its scramble (8 B) and writes 4 B a dimension: 28-32 B a lane
// against the chain's ~6.6 KB. The table row (52 words; 104 for a pair)
// is the same for every lane: a block stages it in shared memory once,
// and the threads' reads of one word there broadcast. The arithmetic, 52
// or 104 masked XORs a lane, runs in registers. The frame's words come as
// values, or, inside a CUDA graph, as 0-d int64 tensors read on the
// device (a pointer), so a capture copies nothing from the host.
//
// Bit-exactness with the plain chain: XOR is exact and its order free; the
// conversion is _to_unit's: the 32-bit word to float rounded to nearest
// even (int64 -> float32 of a value below 2^32; __uint2float_rn), times
// 2^-32 (exact), then the smaller of that and ONE_MINUS_EPSILON. Every
// lane is drawn, padding and dead lanes included, as the plain chain
// draws them. A dimension past the table's last reads the last row, a
// pair past the last but one the last two (sobol_sample_dim / _dim2's
// clamp, first_row).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define K7_THREADS 256
// set bits of b_base ^ delta (the index kernel's loop)
#define INDEX_BITS 32
// index bits a dimension reads: 32 of lo, then 20 of hi (a table row)
#define ROW_WORDS 52
// core/math.py ONE_MINUS_EPSILON: the float below 1
#define ONE_MINUS_EPSILON 0x1.fffffep-1f

namespace {

constexpr int kThreads = K7_THREADS;

// the frame's words (delta, shifted lo, shifted hi): each read on the
// device from a 0-d int64 tensor where its pointer is set, else the value
struct FrameWords {
  const int64_t* p[3];
  uint32_t v[3];
};

__device__ __forceinline__ uint32_t frame_word(const FrameWords& w, int j) {
  return w.p[j] != nullptr ? (uint32_t)*w.p[j] : w.v[j];
}

// the XOR of row[c] over the set bits c of `bits`, for c < nbits
__device__ __forceinline__ uint32_t xor_set(uint32_t bits,
                                            const uint32_t* row, int nbits) {
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 32; ++c)
    if (c < nbits) v ^= row[c] & (0u - ((bits >> c) & 1u));
  return v;
}

// one lane's (lo, hi) index words from b = b_base ^ delta
__device__ __forceinline__ void index_words(uint32_t b, const uint32_t* inv_lo,
                                            const uint32_t* inv_hi,
                                            uint32_t* lo, uint32_t* hi) {
  *lo = xor_set(b, inv_lo, INDEX_BITS);
  *hi = xor_set(b, inv_hi, INDEX_BITS);
}

// one lane's value of the dimension whose row is `row` (ROW_WORDS words)
__device__ __forceinline__ uint32_t dim_value(uint32_t lo, uint32_t hi,
                                              const uint32_t* row) {
  return xor_set(lo, row, 32) ^ xor_set(hi, row + 32, ROW_WORDS - 32);
}

// the table's first row of k consecutive dimensions from dim: a dimension
// past the last reads the last row, a pair past the last but one the last
// two (the plain functions' clamp)
inline int first_row(int dim, int k, int rows) {
  return dim < rows - k ? dim : rows - k;
}

__device__ __forceinline__ float to_unit(uint32_t v) {
  return fminf(__uint2float_rn(v) * 0x1p-32f, ONE_MINUS_EPSILON);
}

__global__ void __launch_bounds__(kThreads) sobol_index_kernel(
    const int64_t* __restrict__ b_base, const int64_t* __restrict__ inv_lo,
    const int64_t* __restrict__ inv_hi, FrameWords w, int n,
    int64_t* __restrict__ out_lo, int64_t* __restrict__ out_hi) {
  __shared__ uint32_t s_lo[INDEX_BITS], s_hi[INDEX_BITS];
  const int t = threadIdx.x;
  if (t < INDEX_BITS) {
    s_lo[t] = (uint32_t)inv_lo[t];
    s_hi[t] = (uint32_t)inv_hi[t];
  }
  __syncthreads();
  const int i = blockIdx.x * kThreads + t;
  if (i >= n) return;
  uint32_t lo, hi;
  index_words((uint32_t)b_base[i] ^ frame_word(w, 0), s_lo, s_hi, &lo, &hi);
  out_lo[i] = (int64_t)(lo ^ frame_word(w, 1));
  out_hi[i] = (int64_t)(hi ^ frame_word(w, 2));
}

// K consecutive dimensions from `rows` (K rows of ROW_WORDS int64 words)
// into out (N, K)
template <int K>
__global__ void __launch_bounds__(kThreads) sobol_draw_kernel(
    const int64_t* __restrict__ idx_lo, const int64_t* __restrict__ idx_hi,
    const int64_t* __restrict__ scramble, const int64_t* __restrict__ rows,
    int n, float* __restrict__ out) {
  __shared__ uint32_t s_rows[K * ROW_WORDS];
  for (int j = threadIdx.x; j < K * ROW_WORDS; j += kThreads)
    s_rows[j] = (uint32_t)rows[j];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t lo = (uint32_t)idx_lo[i], hi = (uint32_t)idx_hi[i];
  const uint32_t scr = scramble != nullptr ? (uint32_t)scramble[i] : 0u;
#pragma unroll
  for (int k = 0; k < K; ++k)
    out[(size_t)i * K + k] =
        to_unit(dim_value(lo, hi, s_rows + k * ROW_WORDS) ^ scr);
}

}  // namespace

// The (lo, hi) sample index words (N,) int64 of the lanes' b_base (N,)
// int64, with the inverse-vdc rows inv_lo / inv_hi (52,) int64 and the
// frame's words delta, shifted lo, shifted hi: each from its 0-d int64
// tensor where w_* is not NULL, else the 32-bit value given.
extern "C" int pt_sobol_index_launch(const int64_t* b_base,
                                     const int64_t* inv_lo,
                                     const int64_t* inv_hi,
                                     const int64_t* w_delta,
                                     const int64_t* w_lo,
                                     const int64_t* w_hi, int delta, int lo,
                                     int hi, int n, int64_t* out_lo,
                                     int64_t* out_hi, void* stream) {
  if (n <= 0) return 0;
  const FrameWords w = {{w_delta, w_lo, w_hi},
                        {(uint32_t)delta, (uint32_t)lo, (uint32_t)hi}};
  const int blocks = (n + kThreads - 1) / kThreads;
  sobol_index_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      b_base, inv_lo, inv_hi, w, n, out_lo, out_hi);
  return (int)cudaGetLastError();
}

// k (1 or 2) consecutive dimensions from `dim` of the table (rows, 52)
// int64 at the lanes' index words (N,) int64, XORed with scramble (N,)
// int64 (NULL: none), into out (N,) or (N, 2) float32.
extern "C" int pt_sobol_draw_launch(const int64_t* idx_lo,
                                    const int64_t* idx_hi,
                                    const int64_t* scramble,
                                    const int64_t* table, int dim, int k,
                                    int rows, int n, float* out,
                                    void* stream) {
  if (k < 1 || k > 2 || dim < 0 || rows < k)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int64_t* row = table + (size_t)first_row(dim, k, rows) * ROW_WORDS;
  const int blocks = (n + kThreads - 1) / kThreads;
  if (k == 1)
    sobol_draw_kernel<1><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        idx_lo, idx_hi, scramble, row, n, out);
  else
    sobol_draw_kernel<2><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        idx_lo, idx_hi, scramble, row, n, out);
  return (int)cudaGetLastError();
}
