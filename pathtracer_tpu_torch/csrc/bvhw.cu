// Kernel K2: BVH32 closest-hit and any-hit traversal for Hopper.
//
// Replaces the reference's traversal pathtracer_tpu/accel/bvhw.py
// (bvhw_intersect and its _traverse_setup / _traverse_step / _slab32 /
// _leaf_batched / _leaf_anyhit_batched / _traverse_result; XLA there, not
// Pallas) and computes exactly what the plain PyTorch version
// pathtracer_tpu_torch/accel/bvhw.py::bvhw_intersect computes, step for
// step: the same children in the same order, the same leaf tie rules, the
// same stack. The table layout is in that module's docstring: (R, 256) f32
// rows, interior rows with 32 component-major child slabs, base row and
// occupancy halves; leaf rows with 25 component-major inline triangles and
// their ids; kind at [255].
//
// What bounds it on an H100: dependent row reads. Every step reads one
// 1 KB row whose address depends on the previous step, and a thread does
// 32 slab tests (~12 flops each) or 25 watertight tests (~80 flops each) on
// it. The box-field table (48,012 triangles) is a few MB and stays in the
// 50 MB L2, so a step costs an L2 round trip plus the arithmetic. The
// design is the simple one:
//   * one thread per ray, 128 threads per block; the slab blocks of the ray
//     (origin, 1/d), its slot-code mask and its watertight shear constants
//     stay in registers;
//   * the row stays in global memory; the thread reads the kind word [255]
//     first and then only the words it needs: the 192 slab words and the
//     three header words of an interior row, or the 9 vertex words and the
//     id of each of a leaf's 25 columns;
//   * the short stack (base, mask, occupancy) lives in per-thread arrays of
//     STACKW entries, indexed modulo the run-time depth `stackw`: a push
//     past `stackw` entries drops the oldest entry, as the plain version's
//     shifting stack does;
//   * a thread that visits more rows than the table has stops with a trap:
//     a valid table visits each row at most once per ray, so only a broken
//     table can get there, and it must not hang the card.
// Warp-cooperative row fetches, shared-memory staging and wgmma are later
// work.
//
// Bit-exactness with the plain version: build with -fmad=false and without
// fast math (1.0f/x, x/y are IEEE), float literals only, every expression
// in the plain version's order (the leaf test is K1's watertight test,
// csrc/intersect.cu). The slab test checks isnan(lo) | isnan(hi) BEFORE any
// min/max: fminf/fmaxf drop a NaN where torch.minimum propagates it, and
// 1/d is +-inf on axis-parallel rays, so (b - o) * inf can be NaN.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBW = 32;
constexpr int kWW = 256;
constexpr int kLeafW = 25;
constexpr int kStackW = 10;  // STACKW of accel/bvhw.py

__device__ __forceinline__ float sel3(int k, float a, float b, float c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

__device__ __forceinline__ float amax3(float a, float b, float c) {
  return fmaxf(fabsf(a), fmaxf(fabsf(b), fabsf(c)));
}

struct RayPre {
  float ox, oy, oz;     // origin
  float ix, iy, iz;     // 1 / d
  int kx, ky, kz;       // watertight permutation
  float o_x, o_y, o_z;  // permuted origin
  float sx, sy, sz;     // shear constants
};

// Slab test of the 32 children of an interior row, as the permuted-order
// hit mask (bit slot ^ mask5).
__device__ __forceinline__ uint32_t slab32(const float* __restrict__ row,
                                           const RayPre& r, float t_best,
                                           float g, int mask5) {
  uint32_t mask = 0u;
#pragma unroll 4
  for (int s = 0; s < kBW; ++s) {
    float tn, tf;
    {
      const float lo = (__ldg(row + s) - r.ox) * r.ix;
      const float hi = (__ldg(row + 96 + s) - r.ox) * r.ix;
      const bool nan_ax = isnan(lo) || isnan(hi);
      tn = nan_ax ? -INFINITY : fminf(lo, hi);
      tf = nan_ax ? INFINITY : fmaxf(lo, hi) * g;
    }
    {
      const float lo = (__ldg(row + 32 + s) - r.oy) * r.iy;
      const float hi = (__ldg(row + 128 + s) - r.oy) * r.iy;
      const bool nan_ax = isnan(lo) || isnan(hi);
      tn = fmaxf(tn, nan_ax ? -INFINITY : fminf(lo, hi));
      tf = fminf(tf, nan_ax ? INFINITY : fmaxf(lo, hi) * g);
    }
    {
      const float lo = (__ldg(row + 64 + s) - r.oz) * r.iz;
      const float hi = (__ldg(row + 160 + s) - r.oz) * r.iz;
      const bool nan_ax = isnan(lo) || isnan(hi);
      tn = fmaxf(tn, nan_ax ? -INFINITY : fminf(lo, hi));
      tf = fminf(tf, nan_ax ? INFINITY : fmaxf(lo, hi) * g);
    }
    if (tn <= tf && tf > 0.f && tn < t_best) mask |= 1u << (s ^ mask5);
  }
  return mask;
}

// Watertight test of the ray against leaf column j (K1's arithmetic).
// Returns true on a hit inside (0, t_bound] and sets t and barycentrics.
__device__ __forceinline__ bool leaf_hit(const float* __restrict__ row,
                                         int j, const RayPre& r,
                                         float t_bound, float g2, float g3,
                                         float g5, float& t_out, float& b0,
                                         float& b1, float& b2) {
  float v[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) v[c] = __ldg(row + kLeafW * c + j);
  const float a0x = sel3(r.kx, v[0], v[1], v[2]) - r.o_x;
  const float a0y = sel3(r.ky, v[0], v[1], v[2]) - r.o_y;
  const float a0z = sel3(r.kz, v[0], v[1], v[2]) - r.o_z;
  const float a1x = sel3(r.kx, v[3], v[4], v[5]) - r.o_x;
  const float a1y = sel3(r.ky, v[3], v[4], v[5]) - r.o_y;
  const float a1z = sel3(r.kz, v[3], v[4], v[5]) - r.o_z;
  const float a2x = sel3(r.kx, v[6], v[7], v[8]) - r.o_x;
  const float a2y = sel3(r.ky, v[6], v[7], v[8]) - r.o_y;
  const float a2z = sel3(r.kz, v[6], v[7], v[8]) - r.o_z;
  const float p0x = a0x + r.sx * a0z, p0y = a0y + r.sy * a0z;
  const float p1x = a1x + r.sx * a1z, p1y = a1y + r.sy * a1z;
  const float p2x = a2x + r.sx * a2z, p2y = a2y + r.sy * a2z;

  const float e0 = p1x * p2y - p1y * p2x;
  const float e1 = p2x * p0y - p2y * p0x;
  const float e2 = p0x * p1y - p0y * p1x;
  const bool neg = (e0 < 0.f) || (e1 < 0.f) || (e2 < 0.f);
  const bool pos = (e0 > 0.f) || (e1 > 0.f) || (e2 > 0.f);
  if (neg && pos) return false;
  const float det = e0 + e1 + e2;
  if (det == 0.f) return false;
  const float p0z = a0z * r.sz, p1z = a1z * r.sz, p2z = a2z * r.sz;
  const float t_scaled = e0 * p0z + e1 * p1z + e2 * p2z;
  const float lim = t_bound * det;
  const bool range_ok = det < 0.f ? (t_scaled < 0.f && t_scaled >= lim)
                                  : (t_scaled > 0.f && t_scaled <= lim);
  if (!range_ok) return false;
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
  if (!(t > delta_t)) return false;
  t_out = t;
  b0 = e0 * inv_det;
  b1 = e1 * inv_det;
  b2 = e2 * inv_det;
  return true;
}

__device__ __forceinline__ uint32_t occupancy(const float* __restrict__ row) {
  return (uint32_t)__ldg(row + 193) | ((uint32_t)__ldg(row + 194) << 16);
}

__global__ void __launch_bounds__(kThreads)
bvhw_kernel(const float* __restrict__ table, int rows,
            const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ t_max, int n, int any_hit, int stackw,
            float g, float g2, float g3, float g5,
            uint8_t* __restrict__ valid_out, float* __restrict__ t_out,
            int32_t* __restrict__ tri_out, float* __restrict__ b_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tm = t_max[i];
  RayPre r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.ix = 1.0f / dx; r.iy = 1.0f / dy; r.iz = 1.0f / dz;
  const int mask5 = (dx < 0.f ? 18 : 0) + (dy < 0.f ? 9 : 0) +
                    (dz < 0.f ? 4 : 0);
  {
    // kz = argmax |d| with the plain version's tie order
    const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
    r.kz = adx > ady ? (adx > adz ? 0 : 2) : (ady > adz ? 1 : 2);
    r.kx = r.kz == 2 ? 0 : r.kz + 1;
    r.ky = r.kx == 2 ? 0 : r.kx + 1;
    const float d_z = sel3(r.kz, dx, dy, dz);
    r.sx = -sel3(r.kx, dx, dy, dz) / d_z;
    r.sy = -sel3(r.ky, dx, dy, dz) / d_z;
    r.sz = 1.0f / d_z;
    r.o_x = sel3(r.kx, r.ox, r.oy, r.oz);
    r.o_y = sel3(r.ky, r.ox, r.oy, r.oz);
    r.o_z = sel3(r.kz, r.ox, r.oy, r.oz);
  }

  float t_best = tm;
  int best_tri = 0;
  float bb0 = 0.f, bb1 = 0.f, bb2 = 0.f;
  bool found = false;

  // root (row 0) is always an interior row; t_max <= 0 lanes are dead
  uint32_t cur_mask = tm > 0.f ? slab32(table, r, tm, g, mask5) : 0u;
  int cur_base = (int)__ldg(table + 192);
  uint32_t cur_occ = occupancy(table);

  int st_base[kStackW];
  uint32_t st_mask[kStackW], st_occ[kStackW];
  int sp = 0;    // pushes minus pops
  int kept = 0;  // entries still held (a push past stackw drops the oldest)
  int steps = 0;

  while (true) {
    if (cur_mask == 0u) {
      if (sp == 0) break;
      --sp;  // pop
      if (kept > 0) {
        const int k = sp % stackw;
        cur_base = st_base[k];
        cur_mask = st_mask[k];
        cur_occ = st_occ[k];
        --kept;
      } else {
        cur_base = 0;
        cur_mask = 0u;
        cur_occ = 0u;
      }
      if (cur_mask == 0u) continue;
    }
    // next child: lowest set permuted bit, undone to its slot; children
    // are stored compactly by slot rank
    const int slot = (__ffs(cur_mask) - 1) ^ mask5;
    cur_mask &= cur_mask - 1u;
    const int child =
        cur_base + __popc(cur_occ & ((1u << slot) - 1u));
    if (++steps > rows || child < 0 || child >= rows) __trap();
    const float* row = table + (size_t)child * kWW;

    if (__ldg(row + 255) > 0.5f) {
      // leaf: 25 columns against the bound on entry; first minimum wins
      const float bound = any_hit ? tm : t_best;
      float t_min = INFINITY;
      int sel_id = 0;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int j = 0; j < kLeafW; ++j) {
        const int id = (int)__ldg(row + 9 * kLeafW + j);
        if (id < 0) continue;  // pad column
        float t, b0, b1, b2;
        if (!leaf_hit(row, j, r, bound, g2, g3, g5, t, b0, b1, b2)) continue;
        if (any_hit) {
          found = true;
          break;
        }
        if (t < t_min) {
          t_min = t;
          sel_id = id;
          s0 = b0; s1 = b1; s2 = b2;
        }
      }
      if (any_hit) {
        if (found) break;
        continue;
      }
      if (t_min < INFINITY) {
        t_best = t_min;
        best_tri = sel_id;
        bb0 = s0; bb1 = s1; bb2 = s2;
        found = true;
      }
      continue;
    }

    // interior: slab-test the 32 grandchildren and descend
    const uint32_t new_mask = slab32(row, r, any_hit ? tm : t_best, g, mask5);
    if (new_mask == 0u) continue;
    if (cur_mask != 0u) {  // push what is left of this node
      const int k = sp % stackw;
      st_base[k] = cur_base;
      st_mask[k] = cur_mask;
      st_occ[k] = cur_occ;
      ++sp;
      kept = min(kept + 1, stackw);
    }
    cur_base = (int)__ldg(row + 192);
    cur_mask = new_mask;
    cur_occ = occupancy(row);
  }

  valid_out[i] = found ? 1 : 0;
  if (any_hit) return;
  t_out[i] = found ? t_best : 0.f;
  tri_out[i] = best_tri;
  b_out[3 * i] = bb0;
  b_out[3 * i + 1] = bb1;
  b_out[3 * i + 2] = bb2;
}

}  // namespace

// Plain C launcher for ctypes. All pointers are device pointers; t, tri
// and b may be null when any_hit is set; 1 <= stackw <= 10. Launches on
// `stream` and returns the launch's cudaError_t (0 = cudaSuccess); it does
// not synchronise.
extern "C" int pt_bvhw_launch(const float* table, const float* o,
                              const float* d, const float* t_max, int rows,
                              int n, int any_hit, int stackw, float g,
                              float g2, float g3, float g5, uint8_t* valid,
                              float* t, int32_t* tri, float* b,
                              void* stream) {
  if (stackw < 1 || stackw > kStackW) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  bvhw_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, rows, o, d, t_max, n, any_hit, stackw, g, g2, g3, g5, valid, t,
      tri, b);
  return (int)cudaGetLastError();
}
