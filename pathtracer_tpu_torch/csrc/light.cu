// Kernel K9 (light_sample, light_pdf): the light sample of next-event
// estimation and the light's solid-angle density along a direction, for
// area (triangle), point and distant lights, a thread a lane, for Hopper.
//
// It replaces no Pallas kernel. It replaces the XLA code of
// pathtracer_tpu/ops/lights.py (sample_li and pdf_li, with _tri_sample,
// _tri_pdf_along_sampled and its watertight re-intersection), which eager
// PyTorch runs as pathtracer_tpu_torch/ops/lights.py's plain chain: ~335
// small ops a call over every lane on strided (N, 3) column slices, every
// light type of the set evaluated for every lane and the lane's own
// selected. It computes exactly what the plain twins of ops/lights.py
// compute, each lane only its own row's type:
//   * light_sample (sample_li_plain): for an area light, a uniform point
//     on the triangle (_tri_sample: its barycentrics, the face-forwarded
//     normal, the point's error bound), the unit direction to it, the
//     density along it by re-intersecting that one triangle from the
//     offset origin (_tri_pdf_along_sampled: offset_ray_origin, then the
//     watertight test in the op order of ops/intersect.py
//     watertight_hit_diag, the one triangle of K1's tail), and the
//     one-sided emission; for a point light the direction, pdf 1 and the
//     intensity over the squared distance; for a distant light its
//     direction, pdf 1 and a target two world radii away. A lane of the
//     environment takes K8's env_sample (its pointers, read here), with
//     the same target rule. Every row's type is in the light set (the
//     scene's set holds the type of each of its lights), so the plain
//     chain's select gives each lane its own row's type, which is all
//     this kernel evaluates. It also writes the three flags of the row's
//     type (delta, environment, area);
//   * light_pdf (pdf_li_plain): the area density along wi, on every lane
//     where the set is the area light alone, else on the area lanes, K8's
//     env_eval density on the environment's lanes and 0 on the others.
//
// What bounds it on an H100: its launch, and the bytes. A sample lane
// reads its light row (104 B), the reference point, its error and its
// normal (36 B) and u (8 B), and writes wi, Le, the target, its error and
// its normal (60 B), the pdf (4 B) and the flags (3 B): 215 B, ~28 MB a
// launch at 130,732 lanes, ~8.4 us at 3.35 TB/s (a set with the
// environment adds K8's 28 B a lane). A density lane reads the row, the
// reference (36 B) and wi (12 B), and writes the pdf: 156 B, ~20 MB, ~6.1
// us. A warp's rows are 3.3 KB contiguous. Every lane is evaluated, dead
// and padding lanes included, as the plain chain evaluates them: its
// outputs equal the plain twin's on every lane.
//
// Bit-exactness with the plain chain on the card: build with -fmad=false
// and without --use_fast_math (ops/cuda/_build.py); each op as PyTorch's
// CUDA op computes it:
//   * torch.sqrt is sqrtf, torch.reciprocal and a tensor division IEEE
//     divisions; torch.maximum returns a NaN operand, as clamp_min does;
//   * products and sums in the plain chain's order (core/math.py dot as
//     (x + y) + z, cross component by component, the barycentric sums
//     left to right); every torch.where of the plain chain is a select
//     here, and next_float_up / next_float_down work on the bits with
//     int32 wrap-around;
//   * the gamma bounds arrive as float arguments, the Python floats the
//     plain chain multiplies by; the world radius is read on the device,
//     a 0-d tensor, as the plain chain reads it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define K9_THREADS 256

namespace {

constexpr int kThreads = K9_THREADS;

// scene/scene.py's light row (LA_*): type, emission, vector, the
// triangle's vertices, their shading normals, has-normals
constexpr int kRow = 26;
constexpr int kType = 0, kEmit = 1, kVec = 4, kP0 = 7, kP1 = 10, kP2 = 13;
constexpr int kN0 = 16, kN1 = 19, kN2 = 22, kHasN = 25;
constexpr int kArea = 0, kPoint = 1, kDistant = 2, kInfinite = 3;
// light_sample's outputs, (N, 3) blocks of a (16 N,) buffer, the pdf last
constexpr int kOutWi = 0, kOutLi = 1, kOutTarget = 2, kOutErr = 3;
constexpr int kOutN = 4, kOutPdf = 15;

// the Python-float constants of ops/lights.py and core/math.py, rounded
// once to float
constexpr float kTiny20 = (float)1e-20;
constexpr float kTiny30 = (float)1e-30;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p) {
  V3 v;
  v.x = p[0];
  v.y = p[1];
  v.z = p[2];
  return v;
}
__device__ __forceinline__ void store3(float* p, V3 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  V3 o;
  o.x = a.x - b.x;
  o.y = a.y - b.y;
  o.z = a.z - b.z;
  return o;
}
__device__ __forceinline__ V3 neg(V3 a) {
  V3 o;
  o.x = -a.x;
  o.y = -a.y;
  o.z = -a.z;
  return o;
}
// core/math.py dot: (x + y) + z
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  V3 o;
  o.x = a.y * b.z - a.z * b.y;
  o.y = a.z * b.x - a.x * b.z;
  o.z = a.x * b.y - a.y * b.x;
  return o;
}
// torch.clamp_min with a scalar bound: a NaN operand is returned
__device__ __forceinline__ float cmin(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
// torch.maximum: a NaN operand is returned
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float amax3(float a, float b, float c) {
  return tmax(fabsf(a), tmax(fabsf(b), fabsf(c)));
}
// core/math.py normalize: v / clamp_min(sqrt((x x + y y) + z z), 1e-20)
__device__ __forceinline__ V3 normalize(V3 v) {
  const float n = cmin(sqrtf(dot(v, v)), kTiny20);
  V3 o;
  o.x = v.x / n;
  o.y = v.y / n;
  o.z = v.z / n;
  return o;
}
// v[k] for k in {0, 1, 2}: ops/intersect.py _take3
__device__ __forceinline__ float take3(V3 v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : v.z);
}
// a light row's type, -1 for a value that is no light type
__device__ __forceinline__ int row_type(const float* r) {
  const float f = r[kType];
  return (f > -1.0f && f < 4.0f) ? (int)f : -1;
}

// core/math.py next_float_up / next_float_down, on the bits with int32
// wrap-around (here unsigned)
__device__ __forceinline__ float next_up(float v) {
  if (v == 0.0f) v = 0.0f;  // -0 -> +0
  const unsigned ui = (unsigned)__float_as_int(v);
  const float out = __int_as_float((int)(v >= 0.0f ? ui + 1u : ui - 1u));
  return (v == INFINITY) ? v : out;
}
__device__ __forceinline__ float next_down(float v) {
  const unsigned ui = (unsigned)__float_as_int(v == 0.0f ? -0.0f : v);
  const float out = __int_as_float((int)(v > 0.0f ? ui - 1u : ui + 1u));
  return (v == -INFINITY) ? v : out;
}
__device__ __forceinline__ float offset_one(float p, float off) {
  float po = p + off;
  if (off > 0.0f) po = next_up(po);
  if (off < 0.0f) po = next_down(po);
  return po;
}
// core/math.py offset_ray_origin(p, p_error, n, w)
__device__ __forceinline__ V3 offset_ray_origin(V3 p, V3 err, V3 n, V3 w) {
  const float d = fabsf(n.x) * err.x + fabsf(n.y) * err.y +
                  fabsf(n.z) * err.z;
  V3 off;
  off.x = d * n.x;
  off.y = d * n.y;
  off.z = d * n.z;
  if (dot(w, n) < 0.0f) off = neg(off);
  V3 o;
  o.x = offset_one(p.x, off.x);
  o.y = offset_one(p.y, off.y);
  o.z = offset_one(p.z, off.z);
  return o;
}

// ops/intersect.py watertight_hit_diag of the ray (o, d) against one
// triangle with t_max = inf, in its op order: whether it hits, and t
__device__ __forceinline__ bool watertight(V3 o, V3 d, V3 p0, V3 p1, V3 p2,
                                           float g2, float g3, float g5,
                                           float& t) {
  const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  const int kz = ax > ay ? (ax > az ? 0 : 2) : (ay > az ? 1 : 2);
  const int kx = kz == 2 ? 0 : kz + 1;
  const int ky = kx == 2 ? 0 : kx + 1;
  const float dz = take3(d, kz);
  const float sx = -take3(d, kx) / dz;
  const float sy = -take3(d, ky) / dz;
  const float sz = 1.0f / dz;
  const V3 a0 = sub(p0, o), a1 = sub(p1, o), a2 = sub(p2, o);
  const float a0z = take3(a0, kz), a1z = take3(a1, kz), a2z = take3(a2, kz);
  const float p0x = take3(a0, kx) + sx * a0z, p0y = take3(a0, ky) + sy * a0z;
  const float p1x = take3(a1, kx) + sx * a1z, p1y = take3(a1, ky) + sy * a1z;
  const float p2x = take3(a2, kx) + sx * a2z, p2y = take3(a2, ky) + sy * a2z;
  const float e0 = p1x * p2y - p1y * p2x;
  const float e1 = p2x * p0y - p2y * p0x;
  const float e2 = p0x * p1y - p0y * p1x;
  const bool negative = (e0 < 0.0f) | (e1 < 0.0f) | (e2 < 0.0f);
  const bool positive = (e0 > 0.0f) | (e1 > 0.0f) | (e2 > 0.0f);
  const bool edge_ok = !(negative & positive);
  const float det = e0 + e1 + e2;
  const bool det_ok = det != 0.0f;
  const float p0z = a0z * sz, p1z = a1z * sz, p2z = a2z * sz;
  const float t_scaled = e0 * p0z + e1 * p1z + e2 * p2z;
  const float lim = INFINITY * det;
  const bool range_ok = det < 0.0f ? (t_scaled < 0.0f) & (t_scaled >= lim)
                                   : (t_scaled > 0.0f) & (t_scaled <= lim);
  const float inv_det = 1.0f / (det_ok ? det : 1.0f);
  t = t_scaled * inv_det;
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
  return edge_ok & det_ok & range_ok & (t > delta_t);
}

// ops/lights.py _tri_pdf_along_sampled: the solid-angle density of the
// row's triangle along wi from the reference point, 0 on a miss
__device__ __forceinline__ float tri_pdf(const float* r, V3 ref_p,
                                         V3 ref_err, V3 ref_n, V3 wi,
                                         float g2, float g3, float g5) {
  const V3 o = offset_ray_origin(ref_p, ref_err, ref_n, wi);
  const V3 p0 = load3(r + kP0), p1 = load3(r + kP1), p2 = load3(r + kP2);
  float t;
  if (!watertight(o, wi, p0, p1, p2, g2, g3, g5, t)) return 0.0f;
  V3 hp;
  hp.x = o.x + t * wi.x;
  hp.y = o.y + t * wi.y;
  hp.z = o.z + t * wi.z;
  const V3 n = normalize(cross(sub(p0, p2), sub(p1, p2)));
  const V3 c = cross(sub(p1, p0), sub(p2, p0));
  const float area = 0.5f * sqrtf(dot(c, c));
  const V3 to_hit = sub(ref_p, hp);
  const float dist_sq = dot(to_hit, to_hit);
  const float cos_abs = fabsf(dot(n, neg(wi)));
  return dist_sq / cmin(cos_abs * area, kTiny20);
}

// one lane's light sample: what sample_li_plain gives it
struct Sample {
  V3 wi, li, target, err, n;
  float pdf;
};

// ops/lights.py _tri_sample and sample_li's area branch
__device__ __forceinline__ Sample sample_area(const float* r, V3 ref_p,
                                              V3 ref_err, V3 ref_n, float u0,
                                              float u1, float g2, float g3,
                                              float g5, float g6) {
  const float su0 = sqrtf(u0);
  const float b0 = 1.0f - su0;
  const float b1 = u1 * su0;
  const float b2 = 1.0f - b0 - b1;
  const V3 p0 = load3(r + kP0), p1 = load3(r + kP1), p2 = load3(r + kP2);
  Sample s;
  s.target.x = b0 * p0.x + b1 * p1.x + b2 * p2.x;
  s.target.y = b0 * p0.y + b1 * p1.y + b2 * p2.y;
  s.target.z = b0 * p0.z + b1 * p1.z + b2 * p2.z;
  V3 n = normalize(cross(sub(p1, p0), sub(p2, p0)));
  if (r[kHasN] > 0.5f) {
    const V3 n0 = load3(r + kN0), n1 = load3(r + kN1), n2 = load3(r + kN2);
    V3 ns;
    ns.x = b0 * n0.x + b1 * n1.x + b2 * n2.x;
    ns.y = b0 * n0.y + b1 * n1.y + b2 * n2.y;
    ns.z = b0 * n0.z + b1 * n1.z + b2 * n2.z;
    if (dot(n, ns) < 0.0f) n = neg(n);
  }
  s.n = n;
  s.err.x = g6 * (fabsf(b0 * p0.x) + fabsf(b1 * p1.x) + fabsf(b2 * p2.x));
  s.err.y = g6 * (fabsf(b0 * p0.y) + fabsf(b1 * p1.y) + fabsf(b2 * p2.y));
  s.err.z = g6 * (fabsf(b0 * p0.z) + fabsf(b1 * p1.z) + fabsf(b2 * p2.z));
  s.wi = normalize(sub(s.target, ref_p));
  s.pdf = tri_pdf(r, ref_p, ref_err, ref_n, s.wi, g2, g3, g5);
  // one-sided emission toward the receiver
  const bool faces = dot(n, neg(s.wi)) > 0.0f;
  const V3 emit = load3(r + kEmit);
  s.li.x = faces ? emit.x : 0.0f;
  s.li.y = faces ? emit.y : 0.0f;
  s.li.z = faces ? emit.z : 0.0f;
  return s;
}

// a target two world radii along w from the reference point
__device__ __forceinline__ V3 far_target(V3 ref_p, V3 w, float two_r) {
  V3 o;
  o.x = ref_p.x + w.x * two_r;
  o.y = ref_p.y + w.y * two_r;
  o.z = ref_p.z + w.z * two_r;
  return o;
}

__global__ void __launch_bounds__(kThreads) light_sample_kernel(
    const float* __restrict__ rows, const float* __restrict__ ref_p_in,
    const float* __restrict__ ref_err_in, const float* __restrict__ ref_n_in,
    const float* __restrict__ uin, const float* __restrict__ world_radius,
    const float* __restrict__ env_wi, const float* __restrict__ env_pdf,
    const float* __restrict__ env_li, int n, float g2, float g3, float g5,
    float g6, float* __restrict__ out, uint8_t* __restrict__ flags) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* r = rows + (size_t)i * kRow;
  const int t = row_type(r);
  const size_t i3 = (size_t)i * 3;
  const V3 ref_p = load3(ref_p_in + i3);
  Sample s;
  const V3 zero = {0.0f, 0.0f, 0.0f};
  s.wi = zero;
  s.li = zero;
  s.target = ref_p;
  s.err = zero;
  s.n = zero;
  s.pdf = 1.0f;
  if (t == kArea) {
    s = sample_area(r, ref_p, load3(ref_err_in + i3), load3(ref_n_in + i3),
                    uin[(size_t)i * 2], uin[(size_t)i * 2 + 1], g2, g3, g5,
                    g6);
  } else if (t == kPoint) {
    const V3 lvec = load3(r + kVec);
    const V3 to_l = sub(lvec, ref_p);
    const float d2 = cmin(dot(to_l, to_l), kTiny30);
    const float dist = sqrtf(d2);
    s.wi.x = to_l.x / dist;
    s.wi.y = to_l.y / dist;
    s.wi.z = to_l.z / dist;
    const V3 emit = load3(r + kEmit);
    s.li.x = emit.x / d2;
    s.li.y = emit.y / d2;
    s.li.z = emit.z / d2;
    s.target = lvec;
  } else if (t == kDistant) {
    s.wi = load3(r + kVec);
    s.li = load3(r + kEmit);
    s.target = far_target(ref_p, s.wi, 2.0f * *world_radius);
  } else if (t == kInfinite && env_wi != nullptr) {  // K8's sample
    s.wi = load3(env_wi + i3);
    s.pdf = env_pdf[i];
    s.li = load3(env_li + i3);
    s.target = far_target(ref_p, s.wi, 2.0f * *world_radius);
  } else {  // no light of the set (no caller passes one): nothing sampled
    s.pdf = 0.0f;
  }
  store3(out + (size_t)kOutWi * n * 3 + i3, s.wi);
  store3(out + (size_t)kOutLi * n * 3 + i3, s.li);
  store3(out + (size_t)kOutTarget * n * 3 + i3, s.target);
  store3(out + (size_t)kOutErr * n * 3 + i3, s.err);
  store3(out + (size_t)kOutN * n * 3 + i3, s.n);
  out[(size_t)kOutPdf * n + i] = s.pdf;
  flags[i] = t == kPoint || t == kDistant;
  flags[(size_t)n + i] = t == kInfinite;
  flags[(size_t)2 * n + i] = t == kArea;
}

__global__ void __launch_bounds__(kThreads) light_pdf_kernel(
    const float* __restrict__ rows, const float* __restrict__ ref_p,
    const float* __restrict__ ref_err, const float* __restrict__ ref_n,
    const float* __restrict__ wi, const float* __restrict__ env_pdf, int n,
    int every, float g2, float g3, float g5, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* r = rows + (size_t)i * kRow;
  const int rtype = row_type(r);
  const size_t i3 = (size_t)i * 3;
  float pdf = 0.0f;
  if (every || rtype == kArea)
    pdf = tri_pdf(r, load3(ref_p + i3), load3(ref_err + i3),
                  load3(ref_n + i3), load3(wi + i3), g2, g3, g5);
  else if (rtype == kInfinite && env_pdf != nullptr)
    pdf = env_pdf[i];
  out[i] = pdf;
}

}  // namespace

// The light sample of each lane's light row (N, 26): the reference point,
// its error bound and normal (N, 3), u (N, 2), the world radius (0-d);
// with the environment in the light set, K8's sample (wi, pdf, Le) of
// every lane, else three NULLs (an environment row then samples nothing).
// Writes `out` (16 N floats: wi, Le, the target, its error, its normal,
// each (N, 3), then the pdf (N,)) and `flags` (3 N bytes: delta,
// environment, area).
extern "C" int pt_light_sample_launch(
    const float* rows, const float* ref_p, const float* ref_err,
    const float* ref_n, const float* u, const float* world_radius,
    const float* env_wi, const float* env_pdf, const float* env_li, int n,
    float g2, float g3, float g5, float g6, float* out, uint8_t* flags,
    void* stream) {
  if ((env_wi == nullptr) != (env_pdf == nullptr) ||
      (env_wi == nullptr) != (env_li == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  light_sample_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, ref_p, ref_err, ref_n, u, world_radius, env_wi, env_pdf, env_li,
      n, g2, g3, g5, g6, out, flags);
  return (int)cudaGetLastError();
}

// The area light's solid-angle density along wi (N, 3) from each lane's
// reference point, its error bound and normal (N, 3), for its light row
// (N, 26): on every lane where `every` is 1, else on the area lanes, with
// env_pdf (K8's density, or NULL) on the environment's lanes and 0 on the
// others. Writes `out` (N,).
extern "C" int pt_light_pdf_launch(const float* rows, const float* ref_p,
                                   const float* ref_err, const float* ref_n,
                                   const float* wi, const float* env_pdf,
                                   int n, int every, float g2, float g3,
                                   float g5, float* out, void* stream) {
  if (every != 0 && every != 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  light_pdf_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, ref_p, ref_err, ref_n, wi, env_pdf, n, every, g2, g3, g5, out);
  return (int)cudaGetLastError();
}
