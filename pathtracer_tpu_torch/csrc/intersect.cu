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
// What bounds it on an H100: instructions executed. Each ray-triangle pair
// needs 30 FP32 operations before a miss is known (9 translations, 6 shear
// products and 6 sums, 3 edge functions of two products and a difference)
// against 36 B of triangle data that every thread of a block reads, so the
// triangle reads are broadcasts from shared memory and the per-ray traffic
// (28 B in, 21 B out) is negligible. The -fmad=false build (below) keeps
// every product and sum a separate instruction. What the design does about
// the instructions around those 30:
//   * a pre-permuted tile: a block stages each triangle three times into
//     shared memory, once for each kz, already in (kx, ky, kz) order (the
//     floats the plain version's selects pick), 12 floats a copy; a thread
//     reads its ray's copy with two 16-byte loads and one 4-byte load and
//     runs no select. The three copies of a triangle sit 12 words apart, in
//     different banks, so the loads of a warp of mixed kz need not
//     conflict (by the layout; bank conflicts are not counted here);
//   * the hit tail out of the hot loop: the loop only shears, computes the
//     three edge functions and records each triangle that passes the sign
//     test as a bit of a per-thread candidate mask (32 triangles, in
//     a register). After each chunk the thread walks its mask in ascending
//     order (__ffs) and runs the tail once for each candidate: it shears
//     the candidate again from shared memory (the same floats) and does
//     det, the range test, 1/det, the error bound and the strict
//     t < best_t, in the plain version's order. A warp so pays the tail
//     for the most candidates one of its lanes has, not for every triangle
//     that any lane's edge test passed;
//   * dead lanes skip: a ray whose t_max is not > 0 (0, negative, NaN) can
//     hit nothing (the range test fails for every det), so it writes the
//     miss record and tests nothing; a block whose rays are all dead
//     stages nothing. Live lanes still join every tile barrier;
//   * the triangle table is staged in tiles of 256 triangles, so the kernel
//     has no cap on F (the TPU's F <= 128 came from Mosaic, not from the
//     algorithm). Shared memory is sized to min(F, 256) triangles.
// What is left, from the build's SASS: a full chunk runs ~41
// instructions a pair (the 30 FP32 operations, 4 FMNMX, 3 shared loads, 2
// compares, a select), and a candidate's tail ~130, once for each
// candidate of the lane that has the most in its warp.
//
// Ties: each thread tests its ray's triangles in ascending index with a
// strict t < best_t, so the lowest index wins, as the argmin of the plain
// version does. Any hit stops at the first passing candidate (the answer
// does not depend on the order). Outputs are SoA: valid (u8), t (0 on a
// miss), tri (0 on a miss), b (N,3) (0 on a miss). A closest hit is valid
// only with a finite t, as the plain version's isfinite(t_best).
//
// Bit-exactness with the plain version: build with -fmad=false (so a*b - c*d
// and the t sums are not contracted into FMAs, which eager PyTorch never
// does) and without --use_fast_math (so 1.0f/x and -x/z stay IEEE
// round-to-nearest divisions). Every literal is a float literal, and every
// sum is written in the plain version's left-to-right order. fmaxf and
// fabsf are only applied to finite values here: fmaxf does not propagate a
// NaN the way torch.maximum / jnp.maximum do, so a NaN input ray would not
// give the same bits as the plain version (both still report no hit).
//
// One thread a ray and 32 triangles a candidate mask: two or four threads
// a ray and 64-triangle masks measured slower on both of chip_smoke.py's
// K1 ray sets. K1_BLOCK (threads a block) is the one tuning constant;
// k1_variants.py builds and times other values.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef K1_BLOCK
#define K1_BLOCK 512
#endif

namespace {

constexpr int kThreads = K1_BLOCK;
constexpr int kChunk = 32;      // triangles a candidate mask covers
constexpr int kTile = 256;      // triangles per shared-memory tile
constexpr int kTriStride = 12;  // packed input row: p0 p1 p2 pad
constexpr int kCopy = 3;        // float4s of one kz copy of a triangle

static_assert(kThreads % 32 == 0 && kThreads <= 1024,
              "K1_BLOCK must be a multiple of 32, at most 1024");
static_assert(kTile % kChunk == 0, "a chunk must not straddle two tiles");

__device__ __forceinline__ float amax3(float a, float b, float c) {
  return fmaxf(fabsf(a), fmaxf(fabsf(b), fabsf(c)));
}

// A triangle translated to the ray's origin, permuted and sheared, with its
// three edge functions.
struct Sheared {
  float a0z, a1z, a2z;
  float p0x, p0y, p1x, p1y, p2x, p2y;
  float e0, e1, e2;
};

// The ray's constants: origin in (kx, ky, kz) order and the shear.
struct Ray {
  float o_x, o_y, o_z, sx, sy, sz;
};

// Shear the kz copy at `v` (three float4s: v0 v1 v2 in (kx, ky, kz) order,
// then padding). Subtract-then-shear in the plain version's order; the
// select the plain version makes after its subtraction picks the same
// value as this subtraction of the pre-picked float.
__device__ __forceinline__ Sheared shear(const float4* v, const Ray& r) {
  const float4 lo = v[0], mid = v[1];
  const float hi = reinterpret_cast<const float*>(v + 2)[0];
  Sheared s;
  const float a0x = lo.x - r.o_x, a0y = lo.y - r.o_y;
  s.a0z = lo.z - r.o_z;
  const float a1x = lo.w - r.o_x, a1y = mid.x - r.o_y;
  s.a1z = mid.y - r.o_z;
  const float a2x = mid.z - r.o_x, a2y = mid.w - r.o_y;
  s.a2z = hi - r.o_z;
  s.p0x = a0x + r.sx * s.a0z;
  s.p0y = a0y + r.sy * s.a0z;
  s.p1x = a1x + r.sx * s.a1z;
  s.p1y = a1y + r.sy * s.a1z;
  s.p2x = a2x + r.sx * s.a2z;
  s.p2y = a2y + r.sy * s.a2z;
  s.e0 = s.p1x * s.p2y - s.p1y * s.p2x;
  s.e1 = s.p2x * s.p0y - s.p2y * s.p0x;
  s.e2 = s.p0x * s.p1y - s.p0y * s.p1x;
  return s;
}

// The sign test, 1 or 0: no edge function negative while another is
// positive, as the least and the greatest of them (fminf and fmaxf skip a
// NaN, as the plain version's comparisons do). It differs from the plain
// version's test only when all three are NaN, where det is NaN and the
// tail rejects. Both sides are evaluated (| not ||): a short circuit
// would cost predicated code and bool conversions in the hot loop.
__device__ __forceinline__ unsigned edges_agree(const Sheared& s) {
  return (unsigned)(fminf(s.e0, fminf(s.e1, s.e2)) >= 0.f) |
         (unsigned)(fmaxf(s.e0, fmaxf(s.e1, s.e2)) <= 0.f);
}

// The hit tail of a candidate (its edges agree): det, the range test
// against t_max, t and the conservative error bound, in the plain
// version's order. With kClosest it also rejects t >= best_t before the
// bound (the bound only ever rejects). Returns whether it hits; sets t and
// inv_det.
template <bool kClosest>
__device__ __forceinline__ bool hit_tail(const Sheared& s, float sz, float tm,
                                         float best_t, float g2, float g3,
                                         float g5, float& t, float& inv_det) {
  const float det = s.e0 + s.e1 + s.e2;
  if (det == 0.f) return false;
  const float p0z = s.a0z * sz, p1z = s.a1z * sz, p2z = s.a2z * sz;
  const float t_scaled = s.e0 * p0z + s.e1 * p1z + s.e2 * p2z;
  const float lim = tm * det;
  const bool range_ok = det < 0.f ? (t_scaled < 0.f && t_scaled >= lim)
                                  : (t_scaled > 0.f && t_scaled <= lim);
  if (!range_ok) return false;
  inv_det = 1.0f / det;
  t = t_scaled * inv_det;
  if (kClosest && !(t < best_t)) return false;

  const float max_zt = amax3(p0z, p1z, p2z);
  const float max_xt = amax3(s.p0x, s.p1x, s.p2x);
  const float max_yt = amax3(s.p0y, s.p1y, s.p2y);
  const float delta_z = g3 * max_zt;
  const float delta_x = g5 * (max_xt + max_zt);
  const float delta_y = g5 * (max_yt + max_zt);
  const float delta_e =
      2.0f * (g2 * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt);
  const float max_e = amax3(s.e0, s.e1, s.e2);
  const float delta_t = 3.0f *
      (g3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e) *
      fabsf(inv_det);
  return t > delta_t;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
intersect_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ t_max,
                 const float* __restrict__ tri, int n, int f, float g2,
                 float g3, float g5, uint8_t* __restrict__ valid_out,
                 float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                 float* __restrict__ b_out) {
  // [triangle][kz][3 float4s]: the kz copies of a triangle 12 words apart
  extern __shared__ float4 s_tri[];

  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = ray < n;
  const float tm = in_range ? t_max[ray] : 0.f;
  const bool live = tm > 0.f;  // false for 0, negative and NaN t_max

  if (!__syncthreads_or(live)) {  // every ray of the block is dead
    if (in_range) {
      valid_out[ray] = 0;
      if (!kAnyHit) {
        t_out[ray] = 0.f;
        tri_out[ray] = 0;
        b_out[3 * ray] = 0.f;
        b_out[3 * ray + 1] = 0.f;
        b_out[3 * ray + 2] = 0.f;
      }
    }
    return;
  }

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  if (live) {
    ox = o[3 * ray]; oy = o[3 * ray + 1]; oz = o[3 * ray + 2];
    dx = d[3 * ray]; dy = d[3 * ray + 1]; dz = d[3 * ray + 2];
  }
  // kz = argmax |d|, with the plain version's tie order
  const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  const int kz = adx > ady ? (adx > adz ? 0 : 2) : (ady > adz ? 1 : 2);
  const float d_x = kz == 0 ? dy : (kz == 1 ? dz : dx);
  const float d_y = kz == 0 ? dz : (kz == 1 ? dx : dy);
  const float d_z = kz == 0 ? dx : (kz == 1 ? dy : dz);
  Ray r;
  r.sx = -d_x / d_z;
  r.sy = -d_y / d_z;
  r.sz = 1.0f / d_z;
  r.o_x = kz == 0 ? oy : (kz == 1 ? oz : ox);
  r.o_y = kz == 0 ? oz : (kz == 1 ? ox : oy);
  r.o_z = kz == 0 ? ox : (kz == 1 ? oy : oz);
  const float4* my_copy = s_tri + kz * kCopy;

  float best_t = INFINITY;
  int best_tri = 0;
  float bb0 = 0.f, bb1 = 0.f, bb2 = 0.f;
  bool found = false;
  bool done = !live;

  for (int base = 0; base < f; base += kTile) {
    const int cnt = min(kTile, f - base);
    __syncthreads();  // the previous tile is no longer read
    // one (triangle, kz) copy per thread and step
    for (int q = threadIdx.x; q < cnt * 3; q += kThreads) {
      const int row = q / 3, cz = q - 3 * row;
      const int cx = cz == 2 ? 0 : cz + 1, cy = cx == 2 ? 0 : cx + 1;
      const float* src = tri + (size_t)(base + row) * kTriStride;
      float4* dst = s_tri + q * kCopy;
      dst[0] = make_float4(src[cx], src[cy], src[cz], src[3 + cx]);
      dst[1] = make_float4(src[3 + cy], src[3 + cz], src[6 + cx],
                           src[6 + cy]);
      dst[2] = make_float4(src[6 + cz], 0.f, 0.f, 0.f);
    }
    __syncthreads();
    if (done) continue;
    // the tile's triangles, kChunk of them a chunk
    for (int c0 = 0; c0 < cnt; c0 += kChunk) {
      const int m = min(kChunk, cnt - c0);
      constexpr int kStep = 3 * kCopy;  // float4s a triangle
      unsigned cand = 0;  // bit k: triangle c0 + k passed the sign test
      const float4* v = my_copy + c0 * kStep;
      if (m == kChunk) {  // a full chunk: 8 triangles a step, constant bits
        for (int k8 = 0; k8 < kChunk; k8 += 8, v += 8 * kStep) {
          unsigned bits = 0;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            bits |= edges_agree(shear(v + k * kStep, r)) << k;
          cand |= bits << k8;
        }
      } else {
        for (int k = 0; k < m; ++k)
          cand |= edges_agree(shear(v + k * kStep, r)) << k;
      }
      while (cand) {
        const int j = c0 + __ffs(cand) - 1;
        cand &= cand - 1;
        const Sheared s = shear(my_copy + j * kStep, r);
        float t, inv_det;
        if (!hit_tail<!kAnyHit>(s, r.sz, tm, best_t, g2, g3, g5, t,
                                inv_det))
          continue;
        if (kAnyHit) {
          found = true;
          done = true;
          break;
        }
        best_t = t;  // t < best_t: the lowest index keeps a tie
        best_tri = base + j;
        bb0 = s.e0 * inv_det;
        bb1 = s.e1 * inv_det;
        bb2 = s.e2 * inv_det;
      }
      if (done) break;
    }
  }

  if (!in_range) return;
  if (kAnyHit) {
    valid_out[ray] = found ? 1 : 0;
    return;
  }
  found = best_t < INFINITY;
  valid_out[ray] = found ? 1 : 0;
  t_out[ray] = found ? best_t : 0.f;
  tri_out[ray] = best_tri;
  b_out[3 * ray] = bb0;
  b_out[3 * ray + 1] = bb1;
  b_out[3 * ray + 2] = bb2;
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
  const size_t smem =
      (size_t)(f < kTile ? f : kTile) * 3 * kCopy * sizeof(float4);
  if (any_hit)
    intersect_kernel<true><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        o, d, t_max, tri, n, f, g2, g3, g5, valid, t, tri_out, b);
  else
    intersect_kernel<false><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        o, d, t_max, tri, n, f, g2, g3, g5, valid, t, tri_out, b);
  return (int)cudaGetLastError();
}
