// Native SAH BVH builder.
//
// C++ equivalent of the host-side build in accel/bvh.py (reference
// semantics: src/pathtracer/accelerator.rs:156-346 — 12-bucket SAH,
// leaf <= max_prims, depth-first flatten with second-child offsets).
// The Python numpy builder is the fallback; this one handles
// Sponza-scale meshes (hundreds of thousands of triangles) at C speed.
// Exposed via ctypes (plain C ABI), no pybind11 required.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

constexpr int kNumBuckets = 12;

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Bounds {
  Vec3 lo{1e30f, 1e30f, 1e30f};
  Vec3 hi{-1e30f, -1e30f, -1e30f};
  void grow(const Bounds& b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(const Vec3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float surface_area() const {
    float ex = std::max(hi.x - lo.x, 0.f);
    float ey = std::max(hi.y - lo.y, 0.f);
    float ez = std::max(hi.z - lo.z, 0.f);
    return 2.f * (ex * ey + ey * ez + ez * ex);
  }
  Vec3 centroid() const {
    return {(lo.x + hi.x) * 0.5f, (lo.y + hi.y) * 0.5f, (lo.z + hi.z) * 0.5f};
  }
};

struct Builder {
  const Bounds* prim_bounds;
  int max_leaf;
  std::vector<float> nb_min, nb_max;
  std::vector<int32_t> offset, n_prims, axis;
  std::vector<int32_t> order;

  int emit(const Bounds& b, int off, int np, int ax) {
    nb_min.insert(nb_min.end(), {b.lo.x, b.lo.y, b.lo.z});
    nb_max.insert(nb_max.end(), {b.hi.x, b.hi.y, b.hi.z});
    offset.push_back(off);
    n_prims.push_back(np);
    axis.push_back(ax);
    return static_cast<int>(offset.size()) - 1;
  }

  int build(int32_t* prims, int n) {
    Bounds bounds;
    Bounds centroid_bounds;
    for (int i = 0; i < n; ++i) {
      bounds.grow(prim_bounds[prims[i]]);
      centroid_bounds.grow(prim_bounds[prims[i]].centroid());
    }
    auto make_leaf = [&]() {
      int node = emit(bounds, static_cast<int>(order.size()), n, 0);
      order.insert(order.end(), prims, prims + n);
      return node;
    };
    if (n <= max_leaf) return make_leaf();

    Vec3 ext = {centroid_bounds.hi.x - centroid_bounds.lo.x,
                centroid_bounds.hi.y - centroid_bounds.lo.y,
                centroid_bounds.hi.z - centroid_bounds.lo.z};
    int ax = 0;
    if (ext.y > ext.x) ax = 1;
    if ((&ext.x)[2] > (&ext.x)[ax]) ax = 2;
    float extent = (&ext.x)[ax];
    float c_lo = (&centroid_bounds.lo.x)[ax];

    // bucket sweep. Degenerate centroid bounds (extent <= 0: coincident
    // centroids) must still SPLIT, not leaf — traversal only tests
    // max_leaf prims per leaf, so an oversized leaf would drop hits.
    // best_split stays -1 there and the equal-count path below applies.
    int counts[kNumBuckets] = {0};
    Bounds buckets[kNumBuckets];
    auto bucket_of = [&](int prim) {
      Vec3 c = prim_bounds[prim].centroid();
      int b = static_cast<int>(((&c.x)[ax] - c_lo) / extent * kNumBuckets);
      return std::min(b, kNumBuckets - 1);
    };
    float best_cost = 1e30f;
    int best_split = -1;
    if (extent > 0.f) {
      for (int i = 0; i < n; ++i) {
        int b = bucket_of(prims[i]);
        counts[b]++;
        buckets[b].grow(prim_bounds[prims[i]]);
      }
      for (int split = 0; split < kNumBuckets - 1; ++split) {
        Bounds bl, br;
        int nl = 0, nr = 0;
        for (int b = 0; b <= split; ++b) {
          if (counts[b]) bl.grow(buckets[b]);
          nl += counts[b];
        }
        for (int b = split + 1; b < kNumBuckets; ++b) {
          if (counts[b]) br.grow(buckets[b]);
          nr += counts[b];
        }
        if (nl == 0 || nr == 0) continue;
        float cost =
            0.125f + (nl * bl.surface_area() + nr * br.surface_area()) /
                         std::max(bounds.surface_area(), 1e-20f);
        if (cost < best_cost) {
          best_cost = cost;
          best_split = split;
        }
      }
    }

    int32_t* mid;
    if (best_split < 0) {
      mid = prims + n / 2;
      std::nth_element(prims, mid, prims + n, [&](int a, int b) {
        Vec3 ca = prim_bounds[a].centroid();
        Vec3 cb = prim_bounds[b].centroid();
        return (&ca.x)[ax] < (&cb.x)[ax];
      });
    } else {
      mid = std::partition(prims, prims + n, [&](int p) {
        return bucket_of(p) <= best_split;
      });
      if (mid == prims || mid == prims + n) mid = prims + n / 2;
    }

    int node = emit(bounds, 0, 0, ax);
    build(prims, static_cast<int>(mid - prims));
    int right = build(mid, static_cast<int>(prims + n - mid));
    offset[node] = right;
    return node;
  }
};

}  // namespace

extern "C" {

// Returns the node count (<= 2n). Caller provides output buffers:
// nb_min/nb_max: 2n*3 floats; offset/n_prims/axis: 2n int32; order: n int32.
int pt_build_bvh(const float* p0, const float* p1, const float* p2, int n,
                 int max_leaf, float* out_min, float* out_max,
                 int32_t* out_offset, int32_t* out_nprims, int32_t* out_axis,
                 int32_t* out_order) {
  std::vector<Bounds> prim_bounds(n);
  for (int i = 0; i < n; ++i) {
    Bounds b;
    b.grow(Vec3{p0[3 * i], p0[3 * i + 1], p0[3 * i + 2]});
    b.grow(Vec3{p1[3 * i], p1[3 * i + 1], p1[3 * i + 2]});
    b.grow(Vec3{p2[3 * i], p2[3 * i + 1], p2[3 * i + 2]});
    prim_bounds[i] = b;
  }
  Builder builder;
  builder.prim_bounds = prim_bounds.data();
  builder.max_leaf = max_leaf;
  builder.nb_min.reserve(6 * n);
  builder.order.reserve(n);
  std::vector<int32_t> prims(n);
  std::iota(prims.begin(), prims.end(), 0);
  builder.build(prims.data(), n);

  int m = static_cast<int>(builder.offset.size());
  std::memcpy(out_min, builder.nb_min.data(), sizeof(float) * 3 * m);
  std::memcpy(out_max, builder.nb_max.data(), sizeof(float) * 3 * m);
  std::memcpy(out_offset, builder.offset.data(), sizeof(int32_t) * m);
  std::memcpy(out_nprims, builder.n_prims.data(), sizeof(int32_t) * m);
  std::memcpy(out_axis, builder.axis.data(), sizeof(int32_t) * m);
  std::memcpy(out_order, builder.order.data(), sizeof(int32_t) * n);
  return m;
}
}
