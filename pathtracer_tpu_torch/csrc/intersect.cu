// Kernel K1: brute-force watertight ray-triangle intersection for Hopper.
//
// Replaces the TPU Pallas kernel pathtracer_tpu/ops/pallas/intersect_pl.py
// (intersect_pallas -> _intersect_kernel, with _merge_carry), and computes
// exactly what the plain PyTorch version
// pathtracer_tpu_torch/ops/intersect.py (intersect_brute /
// intersect_p_brute) computes: the kz-permuted shear of PBRT's watertight
// test, three edge functions, and the conservative t bound built from
// gamma(2/3/5), for every ray against every triangle.
//
// What bounds it on an H100: FP32 issue. Each ray-triangle pair costs about
// 80 flops (9 shears, 3 edge functions, det, t, 3 max-abs chains and the
// error bound) against 36 B of triangle data that every thread of a block
// reads, so the triangle reads are broadcasts from shared memory and the
// per-ray traffic (28 B in, 21 B out) is negligible. The design:
//   * one thread per ray, 128 threads per block; the per-ray shear
//     constants (kx/ky/kz, sx/sy/sz, permuted origin) are computed once and
//     stay in registers;
//   * the triangle table is staged through shared memory in tiles of 256
//     rows x 9 floats (9 KB) behind __syncthreads, so the kernel has no cap
//     on F (the TPU's F <= 128 came from Mosaic, not from the algorithm);
//   * triangles are tested in ascending index with a strict t < best_t, so
//     the lowest index wins ties, as the argmin of the plain version does;
//   * any-hit stops testing at a thread's first hit (the answer does not
//     depend on the order), but keeps joining the tile barriers.
// Outputs are SoA: valid (u8), t (0 on a miss), tri (0 on a miss), b (N,3)
// (0 on a miss).
//
// Bit-exactness with the plain version: build with -fmad=false (so a*b - c*d
// and the t sums are not contracted into FMAs, which eager PyTorch never
// does) and without --use_fast_math (so 1.0f/x and -x/z stay IEEE
// round-to-nearest divisions). Every literal is a float literal, and every
// sum is written in the plain version's left-to-right order. fmaxf and
// fabsf are only applied to finite values here: fmaxf does not propagate a
// NaN the way torch.maximum / jnp.maximum do, so a NaN input ray would not
// give the same bits as the plain version (both still report no hit).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;  // triangles per shared-memory tile
constexpr int kTriStride = 12;  // packed row: p0 p1 p2 pad

__device__ __forceinline__ float sel3(int k, float a, float b, float c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

__device__ __forceinline__ float amax3(float a, float b, float c) {
  return fmaxf(fabsf(a), fmaxf(fabsf(b), fabsf(c)));
}

__global__ void __launch_bounds__(kThreads)
intersect_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ t_max,
                 const float* __restrict__ tri, int n, int f, int any_hit,
                 float g2, float g3, float g5, uint8_t* __restrict__ valid_out,
                 float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                 float* __restrict__ b_out) {
  __shared__ float s_tri[kTile * 9];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  float tm = 0.f;
  if (live) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    tm = t_max[i];
  }
  // kz = argmax |d|, with the plain version's tie order
  const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  const int kz = adx > ady ? (adx > adz ? 0 : 2) : (ady > adz ? 1 : 2);
  const int kx = kz == 2 ? 0 : kz + 1;
  const int ky = kx == 2 ? 0 : kx + 1;
  const float d_x = sel3(kx, dx, dy, dz);
  const float d_y = sel3(ky, dx, dy, dz);
  const float d_z = sel3(kz, dx, dy, dz);
  const float sx = -d_x / d_z;
  const float sy = -d_y / d_z;
  const float sz = 1.0f / d_z;
  const float o_x = sel3(kx, ox, oy, oz);
  const float o_y = sel3(ky, ox, oy, oz);
  const float o_z = sel3(kz, ox, oy, oz);

  float best_t = INFINITY;
  int best_tri = 0;
  float bb0 = 0.f, bb1 = 0.f, bb2 = 0.f;
  bool found = false;
  bool done = !live;

  for (int base = 0; base < f; base += kTile) {
    const int cnt = min(kTile, f - base);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < cnt * 9; k += blockDim.x) {
      const int r = k / 9;
      s_tri[k] = tri[(size_t)(base + r) * kTriStride + (k - r * 9)];
    }
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < cnt; ++j) {
      const float* v = s_tri + 9 * j;
      // translate, permute, shear (select first, then subtract: the same
      // value as the plain version's subtract-then-select)
      const float a0x = sel3(kx, v[0], v[1], v[2]) - o_x;
      const float a0y = sel3(ky, v[0], v[1], v[2]) - o_y;
      const float a0z = sel3(kz, v[0], v[1], v[2]) - o_z;
      const float a1x = sel3(kx, v[3], v[4], v[5]) - o_x;
      const float a1y = sel3(ky, v[3], v[4], v[5]) - o_y;
      const float a1z = sel3(kz, v[3], v[4], v[5]) - o_z;
      const float a2x = sel3(kx, v[6], v[7], v[8]) - o_x;
      const float a2y = sel3(ky, v[6], v[7], v[8]) - o_y;
      const float a2z = sel3(kz, v[6], v[7], v[8]) - o_z;
      const float p0x = a0x + sx * a0z, p0y = a0y + sy * a0z;
      const float p1x = a1x + sx * a1z, p1y = a1y + sy * a1z;
      const float p2x = a2x + sx * a2z, p2y = a2y + sy * a2z;

      const float e0 = p1x * p2y - p1y * p2x;
      const float e1 = p2x * p0y - p2y * p0x;
      const float e2 = p0x * p1y - p0y * p1x;
      const bool neg = (e0 < 0.f) || (e1 < 0.f) || (e2 < 0.f);
      const bool pos = (e0 > 0.f) || (e1 > 0.f) || (e2 > 0.f);
      if (neg && pos) continue;
      const float det = e0 + e1 + e2;
      if (det == 0.f) continue;
      const float p0z = a0z * sz, p1z = a1z * sz, p2z = a2z * sz;
      const float t_scaled = e0 * p0z + e1 * p1z + e2 * p2z;
      const float lim = tm * det;
      const bool range_ok = det < 0.f
          ? (t_scaled < 0.f && t_scaled >= lim)
          : (t_scaled > 0.f && t_scaled <= lim);
      if (!range_ok) continue;
      const float inv_det = 1.0f / det;
      const float t = t_scaled * inv_det;

      const float max_zt = amax3(p0z, p1z, p2z);
      const float max_xt = amax3(p0x, p1x, p2x);
      const float max_yt = amax3(p0y, p1y, p2y);
      const float delta_z = g3 * max_zt;
      const float delta_x = g5 * (max_xt + max_zt);
      const float delta_y = g5 * (max_yt + max_zt);
      const float delta_e =
          2.0f * (g2 * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt);
      const float max_e = amax3(e0, e1, e2);
      const float delta_t = 3.0f *
          (g3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e) *
          fabsf(inv_det);
      if (!(t > delta_t)) continue;

      found = true;
      if (any_hit) {
        done = true;
        break;
      }
      if (t < best_t) {
        best_t = t;
        best_tri = base + j;
        bb0 = e0 * inv_det;
        bb1 = e1 * inv_det;
        bb2 = e2 * inv_det;
      }
    }
  }

  if (!live) return;
  valid_out[i] = found ? 1 : 0;
  if (any_hit) return;
  t_out[i] = found ? best_t : 0.f;
  tri_out[i] = best_tri;
  b_out[3 * i] = bb0;
  b_out[3 * i + 1] = bb1;
  b_out[3 * i + 2] = bb2;
}

}  // namespace

// Plain C launcher, called through pylaunch.c. All pointers are device
// pointers; t, tri and b may be null when any_hit is set. Launches on
// `stream` and returns the launch's cudaError_t (0 = cudaSuccess); it does
// not synchronise.
extern "C" int pt_intersect_launch(const float* o, const float* d,
                                   const float* t_max, const float* tri,
                                   int n, int f, int any_hit, float g2,
                                   float g3, float g5, uint8_t* valid,
                                   float* t, int32_t* tri_out, float* b,
                                   void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  intersect_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      o, d, t_max, tri, n, f, any_hit, g2, g3, g5, valid, t, tri_out, b);
  return (int)cudaGetLastError();
}
