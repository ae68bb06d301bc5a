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
// What bounds it on an H100: instruction issue and memory transactions, not
// arithmetic. A ray visits a handful of 1 KB rows, each row's address known
// only once the row before it is tested; the tables of the scenes rendered
// here are a few MB and stay in the 50 MB L2. A row costs 32 slab tests (~27
// operations each) or up to 25 watertight tests (~80 each), but also the
// walk around them: picking the next child, the stack, the row's address.
// With one thread per ray the 32 lanes of a warp sit on 32 different rows:
// every load instruction touches 32 cache lines for 32 useful words, lanes
// at different depths serialise the leaf and interior branches, and the
// stack, indexed at run time, lives in local memory. That kernel was bound
// by its memory transactions; this one by the instructions it issues (about
// 115 an interior row), as k2_variants.py shows: more resident warps than
// 32 an SM gain a few percent, and testing a row's boxes before its kind is
// known, to save a round trip, loses 11 %.
//
// The design: one warp walks one ray, one lane tests one child.
//   * A warp takes kRaysPerWarp consecutive rays. Lane l loads ray l
//     (coalesced) and computes its constants (1 / d, the slot-code mask,
//     the watertight permutation and shear) once; the warp then walks its
//     live rays one after another, the current ray's constants broadcast
//     with __shfl_sync. A ray with t_max <= 0 costs one bit of a ballot.
//   * Interior row: lane l tests slot s = l ^ mask5. Its six slab words are
//     row[s], row[32 + s] .. row[160 + s]: the component-major layout makes
//     each of the six loads one full 128-byte line across the warp.
//     __ballot_sync of the hit predicate IS the permuted hit mask (bit
//     s ^ mask5 = bit l), so the next child is its lowest set bit. Lanes
//     0..2 read and convert the header words [192..194] when the walk
//     descends.
//   * Leaf row: lane j < 25 runs the watertight test on column j; the nine
//     vertex words row[25 c + j] are consecutive across lanes, and the
//     ray's axis permutation picks which words to load, not among loaded
//     values. Closest hit: __reduce_min_sync over the bits of t (t > 0, so
//     unsigned order is float order), then the lowest lane holding that
//     minimum: smallest t, then smallest column, the plain version's "first
//     minimum wins". Any hit: __any_sync.
//   * Cursor, stack pointer and stack are uniform across the warp: no
//     divergence in the walk. Stack entry k sits in the registers of lane
//     k and is read back with a shuffle, so nothing is indexed at run time.
//     A push past `stackw` entries drops the oldest, as the plain version's
//     shifting stack does.
//   * The ray's own lane writes its record when its walk ends; the kernel
//     keeps no per-ray result in registers.
//   * A ray that visits more rows than the table has stops with a trap: a
//     valid table visits each row at most once per ray, so only a broken
//     table can get there, and it must not hang the card.
// Tensor cores do not apply: the work is compares, min / max and a handful
// of products per (ray, child) pair, with no matrix product in it. Neither
// does TMA: a row is one kilobyte whose address depends on the test of the
// row before, so there is no tile to request ahead, and seven plain loads a
// lane already fetch exactly the lines a step needs. Staging rows in shared
// memory has no use either: a row is read once per visit, each word by one
// lane.
//
// Bit-exactness with the plain version: build with -fmad=false and without
// fast math (1.0f/x, x/y are IEEE), float literals only, every expression
// in the plain version's order (the leaf test is K1's watertight test,
// csrc/intersect.cu). Only who computes a (ray, slot) or (ray, column) test
// differs from one thread per ray. The slab test checks isnan(lo) |
// isnan(hi) BEFORE any min/max: fminf/fmaxf drop a NaN where torch.minimum
// propagates it, and 1/d is +-inf on axis-parallel rays, so (b - o) * inf
// can be NaN.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// rays a warp walks one after another, warps a block, and the blocks an SM
// must be able to hold (which caps the registers a thread may use); the
// defaults are the fastest measured on an H100 at the main path's shapes
// (k2_variants.py builds and times the others)
#ifndef K2_RAYS_PER_WARP
#define K2_RAYS_PER_WARP 4
#endif
#ifndef K2_WARPS_PER_BLOCK
#define K2_WARPS_PER_BLOCK 2
#endif
#ifndef K2_MIN_BLOCKS
#define K2_MIN_BLOCKS 20
#endif

namespace {

constexpr int kRaysPerWarp = K2_RAYS_PER_WARP;
constexpr int kWarps = K2_WARPS_PER_BLOCK;
constexpr int kThreads = 32 * kWarps;
constexpr int kWW = 256;
constexpr int kLeafW = 25;
constexpr int kStackW = 10;  // STACKW of accel/bvhw.py
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;

static_assert(kRaysPerWarp >= 1 && kRaysPerWarp <= 32, "a lane loads a ray");
static_assert(kStackW <= 32, "a lane holds a stack entry");

__device__ __forceinline__ float sel3(int k, float a, float b, float c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

__device__ __forceinline__ float amax3(float a, float b, float c) {
  return fmaxf(fabsf(a), fmaxf(fabsf(b), fabsf(c)));
}

struct RayPre {
  float ox, oy, oz;     // origin
  float ix, iy, iz;     // 1 / d
  int cx, cy, cz;       // this lane's leaf word of vertex 0's permuted x, y, z
  float o_x, o_y, o_z;  // permuted origin
  float sx, sy, sz;     // shear constants
};

// Slab test of one child box (bmin w0..w2, bmax w3..w5) of an interior row.
__device__ __forceinline__ bool slab_hit(float w0, float w1, float w2,
                                         float w3, float w4, float w5,
                                         const RayPre& r, float t_best,
                                         float g) {
  float tn, tf;
  {
    const float lo = (w0 - r.ox) * r.ix;
    const float hi = (w3 - r.ox) * r.ix;
    const bool nan_ax = isnan(lo) || isnan(hi);
    tn = nan_ax ? -INFINITY : fminf(lo, hi);
    tf = nan_ax ? INFINITY : fmaxf(lo, hi) * g;
  }
  {
    const float lo = (w1 - r.oy) * r.iy;
    const float hi = (w4 - r.oy) * r.iy;
    const bool nan_ax = isnan(lo) || isnan(hi);
    tn = fmaxf(tn, nan_ax ? -INFINITY : fminf(lo, hi));
    tf = fminf(tf, nan_ax ? INFINITY : fmaxf(lo, hi) * g);
  }
  {
    const float lo = (w2 - r.oz) * r.iz;
    const float hi = (w5 - r.oz) * r.iz;
    const bool nan_ax = isnan(lo) || isnan(hi);
    tn = fmaxf(tn, nan_ax ? -INFINITY : fminf(lo, hi));
    tf = fminf(tf, nan_ax ? INFINITY : fmaxf(lo, hi) * g);
  }
  return tn <= tf && tf > 0.f && tn < t_best;
}

// Watertight test of the ray against this lane's leaf column (K1's
// arithmetic). The permutation (kx, ky, kz) picks the words to load (r.cx,
// r.cy, r.cz: vertex 0's; the next vertex is 3 components = 75 words on),
// not among loaded values. Returns true on a hit inside (0, t_bound] and
// sets t and barycentrics.
__device__ __forceinline__ bool leaf_hit(const float* __restrict__ row,
                                         const RayPre& r, float t_bound,
                                         float g2, float g3, float g5,
                                         float& t_out, float& b0, float& b1,
                                         float& b2) {
  constexpr int kVertex = 3 * kLeafW;
  const float* px = row + r.cx;
  const float* py = row + r.cy;
  const float* pz = row + r.cz;
  const float a0x = __ldg(px) - r.o_x;
  const float a0y = __ldg(py) - r.o_y;
  const float a0z = __ldg(pz) - r.o_z;
  const float a1x = __ldg(px + kVertex) - r.o_x;
  const float a1y = __ldg(py + kVertex) - r.o_y;
  const float a1z = __ldg(pz + kVertex) - r.o_z;
  const float a2x = __ldg(px + 2 * kVertex) - r.o_x;
  const float a2y = __ldg(py + 2 * kVertex) - r.o_y;
  const float a2z = __ldg(pz + 2 * kVertex) - r.o_z;
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

__global__ void __launch_bounds__(kThreads, K2_MIN_BLOCKS)
bvhw_kernel(const float* __restrict__ table, int rows,
            const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ t_max, int n, int any_hit, int stackw,
            float g, float g2, float g3, float g5,
            uint8_t* __restrict__ valid_out, float* __restrict__ t_out,
            int32_t* __restrict__ tri_out, float* __restrict__ b_out) {
  const int lane = threadIdx.x & 31;
  const long long first =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRaysPerWarp;
  if (first >= n) return;  // the whole warp leaves together

  // lane l's own ray: loaded once, its constants computed once
  const bool mine = lane < kRaysPerWarp && first + lane < n;
  const int i = (int)first + lane;
  float m_ox = 0.f, m_oy = 0.f, m_oz = 0.f, m_ix = 0.f, m_iy = 0.f,
        m_iz = 0.f, m_sx = 0.f, m_sy = 0.f, m_sz = 0.f, m_tm = 0.f;
  int m_code = 0;  // kz | mask5 << 2
  if (mine) {
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    m_tm = t_max[i];
    m_ox = o[3 * i]; m_oy = o[3 * i + 1]; m_oz = o[3 * i + 2];
    m_ix = 1.0f / dx; m_iy = 1.0f / dy; m_iz = 1.0f / dz;
    const int mask5 = (dx < 0.f ? 18 : 0) + (dy < 0.f ? 9 : 0) +
                      (dz < 0.f ? 4 : 0);
    // kz = argmax |d| with the plain version's tie order
    const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
    const int kz = adx > ady ? (adx > adz ? 0 : 2) : (ady > adz ? 1 : 2);
    const int kx = kz == 2 ? 0 : kz + 1;
    const int ky = kx == 2 ? 0 : kx + 1;
    const float d_z = sel3(kz, dx, dy, dz);
    m_sx = -sel3(kx, dx, dy, dz) / d_z;
    m_sy = -sel3(ky, dx, dy, dz) / d_z;
    m_sz = 1.0f / d_z;
    m_code = kz | (mask5 << 2);
  }
  // rays with t_max <= 0 (or NaN) are dead on entry
  unsigned live = __ballot_sync(kFull, mine && m_tm > 0.f);

  // the root (row 0) is always an interior row
  const int root_base = (int)__ldg(table + 192);
  const unsigned root_occ =
      (unsigned)__ldg(table + 193) | ((unsigned)__ldg(table + 194) << 16);

  // a dead ray's record: no hit, zeros
  if (mine && !(m_tm > 0.f)) {
    valid_out[i] = 0;
    if (!any_hit) {
      t_out[i] = 0.f;
      tri_out[i] = 0;
      b_out[3 * i] = 0.f;
      b_out[3 * i + 1] = 0.f;
      b_out[3 * i + 2] = 0.f;
    }
  }

  // lane l keeps entry l of the current ray's stack
  int st_base = 0;
  unsigned st_mask = 0u, st_occ = 0u;

  while (live != 0u) {
    const int src = __ffs(live) - 1;
    live &= live - 1u;
    RayPre r;
    r.ox = __shfl_sync(kFull, m_ox, src);
    r.oy = __shfl_sync(kFull, m_oy, src);
    r.oz = __shfl_sync(kFull, m_oz, src);
    r.ix = __shfl_sync(kFull, m_ix, src);
    r.iy = __shfl_sync(kFull, m_iy, src);
    r.iz = __shfl_sync(kFull, m_iz, src);
    r.sx = __shfl_sync(kFull, m_sx, src);
    r.sy = __shfl_sync(kFull, m_sy, src);
    r.sz = __shfl_sync(kFull, m_sz, src);
    const float tm = __shfl_sync(kFull, m_tm, src);
    const int code = __shfl_sync(kFull, m_code, src);
    const int kz = code & 3;
    const int kx = kz == 2 ? 0 : kz + 1;
    const int ky = kx == 2 ? 0 : kx + 1;
    r.o_x = sel3(kx, r.ox, r.oy, r.oz);
    r.o_y = sel3(ky, r.ox, r.oy, r.oz);
    r.o_z = sel3(kz, r.ox, r.oy, r.oz);
    r.cx = kLeafW * kx + lane;
    r.cy = kLeafW * ky + lane;
    r.cz = kLeafW * kz + lane;
    const int mask5 = code >> 2;
    const int s = lane ^ mask5;  // this lane's slot of every interior row

    float t_best = tm;
    int best_tri = 0;
    float bb0 = 0.f, bb1 = 0.f, bb2 = 0.f;
    bool found = false;

    const float* root = table + s;
    unsigned cur_mask = __ballot_sync(kFull, slab_hit(
        __ldg(root), __ldg(root + 32), __ldg(root + 64), __ldg(root + 96),
        __ldg(root + 128), __ldg(root + 160), r, tm, g));
    int cur_base = root_base;
    unsigned cur_occ = root_occ;
    int sp = 0;    // pushes minus pops
    int top = 0;   // sp modulo stackw: the lane of the next push
    int kept = 0;  // entries still held (a push past stackw drops the oldest)
    int steps = 0;

    while (true) {
      if (cur_mask == 0u) {
        if (sp == 0) break;
        --sp;  // pop
        top = (top == 0 ? stackw : top) - 1;
        if (kept > 0) {
          cur_base = __shfl_sync(kFull, st_base, top);
          cur_mask = __shfl_sync(kFull, st_mask, top);
          cur_occ = __shfl_sync(kFull, st_occ, top);
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
      const unsigned low = cur_mask & (0u - cur_mask);
      const int slot = (31 - __clz(low)) ^ mask5;
      cur_mask ^= low;
      const int child =
          cur_base + __popc(cur_occ & ((1u << slot) - 1u));
      if (++steps > rows || child < 0 || child >= rows) __trap();
      const float* row = table + (size_t)child * kWW;

      if (__ldg(row + 255) > 0.5f) {
        // leaf: one column a lane, all against the bound on entry
        bool hit = false;
        float t = INFINITY, b0 = 0.f, b1 = 0.f, b2 = 0.f;
        int id = -1;
        if (lane < kLeafW) {
          id = (int)__ldg(row + 9 * kLeafW + lane);
          if (id >= 0)  // not a pad column
            hit = leaf_hit(row, r, any_hit ? tm : t_best, g2, g3, g5, t, b0,
                           b1, b2);
        }
        if (any_hit) {
          if (__any_sync(kFull, hit)) {
            found = true;
            break;
          }
          continue;
        }
        // smallest t, then smallest column: the first minimum wins
        const unsigned t_bits = hit ? __float_as_uint(t) : kInfBits;
        const unsigned min_bits = __reduce_min_sync(kFull, t_bits);
        if (min_bits < kInfBits) {
          const int win =
              __ffs(__ballot_sync(kFull, hit && t_bits == min_bits)) - 1;
          t_best = __uint_as_float(min_bits);
          best_tri = __shfl_sync(kFull, id, win);
          bb0 = __shfl_sync(kFull, b0, win);
          bb1 = __shfl_sync(kFull, b1, win);
          bb2 = __shfl_sync(kFull, b2, win);
          found = true;
        }
        continue;
      }

      // interior: slab-test the 32 grandchildren and descend
      const float* slab = row + s;
      const unsigned new_mask = __ballot_sync(kFull, slab_hit(
          __ldg(slab), __ldg(slab + 32), __ldg(slab + 64), __ldg(slab + 96),
          __ldg(slab + 128), __ldg(slab + 160), r, any_hit ? tm : t_best,
          g));
      if (new_mask == 0u) continue;
      // lanes 0..2 read and convert the header words 192..194
      const int hdr = (int)__ldg(row + 192 + (lane & 3));
      if (cur_mask != 0u) {  // push what is left of this node
        if (lane == top) {
          st_base = cur_base;
          st_mask = cur_mask;
          st_occ = cur_occ;
        }
        ++sp;
        top = top + 1 == stackw ? 0 : top + 1;
        kept = min(kept + 1, stackw);
      }
      cur_base = __shfl_sync(kFull, hdr, 0);
      cur_mask = new_mask;
      cur_occ = (unsigned)__shfl_sync(kFull, hdr, 1) |
                ((unsigned)__shfl_sync(kFull, hdr, 2) << 16);
    }

    if (lane == src) {  // the ray's own lane writes its record
      valid_out[i] = found ? 1 : 0;
      if (!any_hit) {
        t_out[i] = found ? t_best : 0.f;
        tri_out[i] = best_tri;
        b_out[3 * i] = bb0;
        b_out[3 * i + 1] = bb1;
        b_out[3 * i + 2] = bb2;
      }
    }
  }
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
  constexpr int kRaysPerBlock = kRaysPerWarp * kWarps;
  const int blocks = (n + kRaysPerBlock - 1) / kRaysPerBlock;
  bvhw_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, rows, o, d, t_max, n, any_hit, stackw, g, g2, g3, g5, valid, t,
      tri, b);
  return (int)cudaGetLastError();
}
