// Kernel K8 (env_eval, env_sample): the environment light evaluated
// (radiance and solid-angle pdf along world directions) and
// importance-sampled (direction, pdf and radiance at u), a thread a lane,
// for Hopper.
//
// It replaces no Pallas kernel. It replaces the XLA code of
// pathtracer_tpu/ops/lights.py (env_direction_to_uv, env_lookup, env_le,
// env_pdf_li, _env_sample_li, with core/sampling.py's 2-D distribution),
// which eager PyTorch runs as pathtracer_tpu_torch/ops/lights.py's plain
// chain: ~100 small ops a call over every lane, the map's four bilinear
// taps and the searches' reads as int64 advanced indexing. It computes
// exactly what the plain twins of ops/lights.py compute:
//   * env_eval (env_eval_plain): each lane's direction taken into the
//     map's frame (_mat3_rows, normalize), its theta, phi and uv, then,
//     where asked, the radiance (env_lookup's four taps, u repeating, v
//     clamped, zero without an environment) and the pdf (the table cell
//     of pdf_distribution_2d over the integral, over 2 pi^2 sin theta;
//     zero where sin theta is 0 or there is no environment);
//   * env_sample (env_sample_plain): sample_distribution_2d at u (the
//     marginal's search, torch.searchsorted's upper bound, then row v's
//     conditional search, searchsorted_rows' binary search read in
//     place), the direction from (theta, phi), the pdf over 2 pi^2 sin
//     theta and the radiance at the sampled uv, both zero where the
//     sample's density is not > 0.
//
// What bounds it on an H100: its launch, and the latency of dependent
// reads. An env_eval lane reads its direction (12 B) and writes 12-16 B;
// an env_sample lane reads u (8 B) and writes 28 B: at most 4.7 MB a
// launch at 130,732 lanes, ~1.4 us at 3.35 TB/s. The tables (the
// conditional cdf and function, 2 x 8.4 MB for a 1k map) and the map
// (6.3 MB) fit the 50 MB L2, where the bounce loop leaves them. An
// env_sample lane makes ~11 dependent reads for the marginal search,
// ~12 for the conditional row's, then its taps: the marginal cdf (4.1 KB
// for a 1k map) is staged once a block in shared memory, so its search
// reads shared memory; the row search reads L2 in place, one cell a step,
// as the plain chain does. Every lane is evaluated, dead and padding lanes
// included, as the plain chain evaluates them: its outputs equal the plain
// twin's on every lane.
//
// Bit-exactness with the plain chain on the card: build with -fmad=false
// and without --use_fast_math (ops/cuda/_build.py); each op as PyTorch's
// CUDA op computes it:
//   * torch.arccos / atan2 / sin / cos / floor / sqrt are acosf / atan2f
//     / sinf / cosf / floorf / sqrtf; a float to int64 cast truncates;
//     int64 remainder takes the divisor's sign;
//   * a Python scalar operand is a double rounded to float: every
//     constant below is written (float)(double); a division by a Python
//     scalar is a product with its reciprocal taken in double and rounded
//     to float; `uv * 2.0 * pi` is two products, in that order;
//   * products and sums in the plain chain's order (core/math.py dot as
//     (x + y) + z, _mat3_rows by column);
//   * clamp and clamp_min return a NaN operand; every torch.where of the
//     plain chain is a select here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define K8_THREADS 256
// the marginal cdf is staged in shared memory up to this many floats (a
// map of up to 2,048 table rows, a 4k map); a longer one is read in place
#define MARG_STAGE 4097

namespace {

constexpr int kThreads = K8_THREADS;

// core/math.py INV_PI, INV_2_PI (np.float32 of the double) and the
// Python-float constants of ops/lights.py, core/math.py and
// core/sampling.py, rounded once to float
constexpr double kPi = 3.14159265358979323846;
constexpr float kPiF = (float)kPi;
constexpr float kTwoPi = (float)(2.0 * kPi);
constexpr float kInvPi = (float)(1.0 / kPi);
constexpr float kInv2Pi = (float)(0.5 / kPi);
constexpr float kTwoPiPi = (float)(2.0 * kPi * kPi);
constexpr float kTiny20 = (float)1e-20;
constexpr float kTiny30 = (float)1e-30;

struct V3 {
  float x, y, z;
};

// torch.clamp_min / clamp with scalar bounds: a NaN operand is returned
__device__ __forceinline__ float cmin(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ int64_t clampi(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
// torch.remainder of int64 by a positive divisor
__device__ __forceinline__ int64_t rem(int64_t a, int64_t b) {
  int64_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// _mat3_rows: w @ m.T for the row-major (3, 3) m, summed by column
__device__ __forceinline__ V3 mat3_rows(const float* m, V3 w) {
  V3 o;
  o.x = w.x * m[0] + w.y * m[1] + w.z * m[2];
  o.y = w.x * m[3] + w.y * m[4] + w.z * m[5];
  o.z = w.x * m[6] + w.y * m[7] + w.z * m[8];
  return o;
}

// core/math.py normalize: v / clamp_min(sqrt((x x + y y) + z z), 1e-20)
__device__ __forceinline__ V3 normalize(V3 v) {
  const float n = cmin(sqrtf(v.x * v.x + v.y * v.y + v.z * v.z), kTiny20);
  V3 o;
  o.x = v.x / n;
  o.y = v.y / n;
  o.z = v.z / n;
  return o;
}

// env_lookup: the map (h, w, 3) bilinear at uv, u repeating, v clamped
__device__ __forceinline__ void lookup(const float* __restrict__ img, int h,
                                       int w, float u, float v, float* le) {
  const float x = u * (float)w - 0.5f;
  const float y = v * (float)h - 0.5f;
  const int64_t x0 = (int64_t)floorf(x);
  const int64_t y0 = (int64_t)floorf(y);
  const float fx = x - (float)x0;
  const float fy = y - (float)y0;
  const int64_t xm = rem(x0, w), xp = rem(x0 + 1, w);
  const int64_t ym = clampi(y0, 0, h - 1), yp = clampi(y0 + 1, 0, h - 1);
  const float* tm = img + (ym * w + xm) * 3;
  const float* tp = img + (ym * w + xp) * 3;
  const float* bm = img + (yp * w + xm) * 3;
  const float* bp = img + (yp * w + xp) * 3;
  const float gx = 1.0f - fx, gy = 1.0f - fy;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = tm[c] * gx + tp[c] * fx;
    const float bot = bm[c] * gx + bp[c] * fx;
    le[c] = top * gy + bot * fy;
  }
}

// ceil(log2(n + 1)): the steps of searchsorted_rows over n entries
inline int search_steps(int64_t n) {
  int bits = 0;
  while (bits < 63 && ((int64_t)1 << bits) <= n) ++bits;
  return bits;
}

// one continuous 1-D sample's parts: (offset + du) / n and the cell's
// density, sample_distribution_1d's arithmetic after its search
__device__ __forceinline__ float cell_du(float u, float c0, float c1) {
  const float denom = c1 - c0;
  return denom > 0.0f ? (u - c0) / denom : u - c0;
}
__device__ __forceinline__ float cell_pdf(float f, float integral) {
  return integral > 0.0f ? f / cmin(integral, kTiny30) : 0.0f;
}

__global__ void __launch_bounds__(kThreads) env_eval_kernel(
    const float* __restrict__ d, const float* __restrict__ w2e,
    const float* __restrict__ img, const float* __restrict__ cond_func,
    const float* __restrict__ marg_int, const uint8_t* __restrict__ has_env,
    int n, int h, int w, int nv, int nu, float* __restrict__ out_le,
    float* __restrict__ out_pdf) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  V3 dir;
  dir.x = d[(size_t)i * 3];
  dir.y = d[(size_t)i * 3 + 1];
  dir.z = d[(size_t)i * 3 + 2];
  const V3 wv = normalize(mat3_rows(w2e, dir));
  const float theta = acosf(clampf(wv.z, -1.0f, 1.0f));
  float phi = atan2f(wv.y, wv.x);
  phi = phi < 0.0f ? phi + kTwoPi : phi;
  const float u = phi * kInv2Pi;
  const float v = theta * kInvPi;
  const bool has = *has_env != 0;
  if (out_le != nullptr) {
    float le[3];
    lookup(img, h, w, u, v, le);
#pragma unroll
    for (int c = 0; c < 3; ++c) out_le[(size_t)i * 3 + c] = has ? le[c] : 0.0f;
  }
  if (out_pdf != nullptr) {
    const float sin_t = sinf(theta);
    const int64_t iu = clampi((int64_t)(u * (float)nu), 0, nu - 1);
    const int64_t iv = clampi((int64_t)(v * (float)nv), 0, nv - 1);
    const float d2 = cond_func[iv * nu + iu] / cmin(*marg_int, kTiny30);
    const float pdf = d2 / (kTwoPiPi * cmin(sin_t, kTiny20));
    out_pdf[i] = (sin_t == 0.0f || !has) ? 0.0f : pdf;
  }
}

__global__ void __launch_bounds__(kThreads) env_sample_kernel(
    const float* __restrict__ uin, const float* __restrict__ e2w,
    const float* __restrict__ img, const float* __restrict__ cond_func,
    const float* __restrict__ cond_cdf, const float* __restrict__ cond_int,
    const float* __restrict__ marg_func, const float* __restrict__ marg_cdf,
    const float* __restrict__ marg_int, int n, int h, int w, int nv, int nu,
    int row_steps, float* __restrict__ out_wi, float* __restrict__ out_pdf,
    float* __restrict__ out_le) {
  __shared__ float s_marg[MARG_STAGE];
  const float* mcdf = marg_cdf;
  if (nv + 1 <= MARG_STAGE) {  // the same branch for the whole block
    for (int j = threadIdx.x; j <= nv; j += kThreads) s_marg[j] = marg_cdf[j];
    __syncthreads();
    mcdf = s_marg;
  }
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float u0 = uin[(size_t)i * 2];
  const float u1 = uin[(size_t)i * 2 + 1];

  // the marginal: torch.searchsorted(marg_cdf, u1, right=True)'s upper
  // bound over the nv + 1 entries, less one, clamped to a row
  int64_t lo = 0, hi = (int64_t)nv + 1;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (!(mcdf[mid] > u1))
      lo = mid + 1;
    else
      hi = mid;
  }
  const int64_t vrow = clampi(lo - 1, 0, nv - 1);
  const float mint = *marg_int;
  const float du1 = cell_du(u1, mcdf[vrow], mcdf[vrow + 1]);
  const float pdf1 = cell_pdf(marg_func[vrow], mint);
  const float d1 = ((float)vrow + du1) * (float)(1.0 / (double)nv);

  // row v's conditional, read in place: searchsorted_rows' binary search
  // of row_steps steps over its nu + 1 entries
  const int64_t nrow = (int64_t)nu + 1;
  const float* row = cond_cdf + vrow * nrow;
  int64_t pos = 0;
  for (int k = row_steps - 1; k >= 0; --k) {
    const int64_t cand = pos + ((int64_t)1 << k);
    const bool inside = cand <= nrow;
    const float val = row[(inside ? cand : nrow) - 1];
    if (inside && val <= u0) pos = cand;
  }
  const int64_t off = clampi(pos - 1, 0, nu - 1);
  const float du0 = cell_du(u0, row[off], row[off + 1]);
  const float pdf0 = cell_pdf(cond_func[vrow * nu + off], cond_int[vrow]);
  const float d0 = ((float)off + du0) * (float)(1.0 / (double)nu);
  const float map_pdf = pdf0 * pdf1;

  const float theta = d1 * kPiF;
  const float phi = d0 * 2.0f * kPiF;
  const float sin_t = sinf(theta);
  V3 local;
  local.x = sin_t * cosf(phi);
  local.y = sin_t * sinf(phi);
  local.z = cosf(theta);
  const V3 wi = mat3_rows(e2w, local);
  float pdf = sin_t == 0.0f ? 0.0f
                            : map_pdf / (kTwoPiPi * cmin(sin_t, kTiny20));
  float le[3];
  lookup(img, h, w, d0, d1, le);
  const bool ok = map_pdf > 0.0f;
  out_wi[(size_t)i * 3] = wi.x;
  out_wi[(size_t)i * 3 + 1] = wi.y;
  out_wi[(size_t)i * 3 + 2] = wi.z;
  out_pdf[i] = ok ? pdf : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) out_le[(size_t)i * 3 + c] = ok ? le[c] : 0.0f;
}

}  // namespace

// Le (N, 3) and the pdf (N,) float32 of the environment along the world
// directions d (N, 3), each where its pointer is not NULL: the map (h, w,
// 3), the conditional function (nv, nu), the marginal's integral and
// has_env (0-d float32 and bool), world_to_env (3, 3).
extern "C" int pt_env_eval_launch(const float* d, const float* w2e,
                                  const float* img, const float* cond_func,
                                  const float* marg_int,
                                  const uint8_t* has_env, int n, int h, int w,
                                  int nv, int nu, float* le, float* pdf,
                                  void* stream) {
  if (h < 1 || w < 1 || nv < 1 || nu < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  env_eval_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      d, w2e, img, cond_func, marg_int, has_env, n, h, w, nv, nu, le, pdf);
  return (int)cudaGetLastError();
}

// The world direction wi (N, 3), its pdf (N,) and Le (N, 3) float32 of the
// environment sampled at u (N, 2): the map (h, w, 3), the 2-D tables
// (conditional function (nv, nu), cdf (nv, nu + 1), integrals (nv,);
// marginal function (nv,), cdf (nv + 1,), integral 0-d), env_to_world
// (3, 3).
extern "C" int pt_env_sample_launch(
    const float* u, const float* e2w, const float* img, const float* cond_func,
    const float* cond_cdf, const float* cond_int, const float* marg_func,
    const float* marg_cdf, const float* marg_int, int n, int h, int w, int nv,
    int nu, float* wi, float* pdf, float* le, void* stream) {
  if (h < 1 || w < 1 || nv < 1 || nu < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  env_sample_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      u, e2w, img, cond_func, cond_cdf, cond_int, marg_func, marg_cdf,
      marg_int, n, h, w, nv, nu, search_steps((int64_t)nu + 1), wi, pdf, le);
  return (int)cudaGetLastError();
}
