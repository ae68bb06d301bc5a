// Kernels K5 (bsdf_eval) and K6 (bsdf_sample): the BSDF of every material
// model evaluated (f, pdf) and sampled (wi, f, pdf, specular,
// transmission), a thread a lane, for Hopper.
//
// Neither replaces a TPU kernel. They replace
// pathtracer_tpu/ops/bsdf.py eval_f_pdf and sample_f, which are plain XLA:
// the JAX package evaluates every material branch present in the scene
// over the whole batch and keeps one result a lane with jnp.select, and
// eager PyTorch runs that as hundreds of small kernels a call (each of
// the Metal, Substrate and Glass branches is a chain of tens of them).
//   * K5 computes exactly what pathtracer_tpu_torch/ops/bsdf.py
//     eval_world computes: eval_f_pdf's f and pdf of Matte, Metal,
//     Substrate, Disney and RoughGlass for NEE's light branch (Mirror and
//     Glass give 0) with the frame changes around it taken in: wo and wi
//     into the hit's shading frame (to_local), the geometric-normal test
//     (wi.ng)(wo.ng) > 0, and |wi.ns|, the cosine the callers weight f by.
//   * K6 computes what sample_world computes: sample_f's wi, f, pdf and
//     specular and transmission flags of all seven models, with wo taken
//     into the shading frame, wi back to world space (to_world) and
//     |wi.ns|; the Disney and RoughGlass branches run the geometric-normal
//     test (reflect_ng_test) on the sampled wi.
//     Each frame change is core/math.py's dot product, so the bits stay
//     those of the plain version's separate ops.
//   * `present` is the scene's set of material types as a bit mask (bit t
//     for type t). A lane whose type is outside it gets f = 0 and pdf = 0,
//     no transmission, and in K6 the wi of the first present branch (the
//     lowest set bit: the plain version's select keeps wis[0] there);
//     with no bit set, wi = (0, 0, 1).
//
// What bounds them on an H100: bytes a lane at 3.35 TB/s, and the launch.
// A K5 lane reads its type, the frame (ss, ts, ns, ng: 48 B), wo and wi
// (24 B), the parameters its own model needs (12-36 B of its material
// row, strided), and writes f, pdf and the cosine (20 B); a K6 lane reads
// its type, the frame, wo and u (20 B) and its parameters, and writes wi,
// f, pdf, the cosine and the two flags (34 B). The arithmetic is tens to a
// few hundred FP32 operations a lane, well under the bytes' time at the
// card's FP32 rate. The design: a thread a lane, everything in registers,
// no shared memory, one launch a call in place of the plain version's
// every-branch-then-select chain; each lane loads only the columns its
// model reads and runs only its own branch.
//
// Divergence across materials within a warp: a warp whose lanes hold k
// distinct models runs those k branches one after the other, with the
// other lanes masked, so its cost is the sum of at most k branches and
// never the plain version's all-branches-on-every-lane. Lanes are not
// sorted by material: a sort costs more launches and bytes than the
// branches it would save, since the longest branch (RoughGlass sampling)
// is a few hundred operations and the kernel is bound by its bytes and
// its launch, not by instruction rate. Neighbouring pixels mostly hit the
// same surface, so most warps run one or two branches.
//
// Bit-exactness with the plain version on the card: build with
// -fmad=false and without --use_fast_math (ops/cuda/_build.py); every
// product and sum in the plain version's order (Python's left-to-right
// chains, core/math.py dot as (x + y) + z); each op as PyTorch's CUDA op
// computes it:
//   * a Python scalar operand is a double rounded to float: every constant
//     below is written (float)(double), never as a float literal, since
//     the two round differently for some decimals;
//   * a division by a Python scalar is a product with its reciprocal
//     (here only / 2.0, exact either way);
//   * torch.sqrt / cos / sin are sqrtf / cosf / sinf;
//   * clamp, clamp_min, clamp_max return a NaN operand; torch.maximum
//     returns a NaN operand (fmax_nan);
//   * every select of the plain version (torch.where) is a select here,
//     and every lane computes its branch whatever its other inputs, dead
//     and padding lanes included.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// material types (pathtracer_tpu_torch/scene/scene.py: MAT_*)
#define MAT_MATTE 0
#define MAT_MIRROR 1
#define MAT_GLASS 2
#define MAT_METAL 3
#define MAT_SUBSTRATE 4
#define MAT_DISNEY 5
#define MAT_ROUGHGLASS 6
#define N_MATERIALS 7

namespace {

constexpr int kThreads = 256;

// ops/bsdf.py INV_PI (np.float32(1 / pi)) and the Python-float constants
// of ops/bsdf.py, core/sampling.py and core/math.py, rounded once to float
constexpr double kPi = 3.14159265358979323846;
constexpr float kInvPi = (float)(1.0 / kPi);
constexpr float kPiF = (float)kPi;
constexpr float kTwoPi = (float)(2.0 * kPi);
constexpr float kPiOver2 = (float)(kPi / 2.0);
constexpr float kPiOver4 = (float)(kPi / 4.0);
constexpr float kFbDiffuse = (float)(28.0 / (23.0 * kPi));
constexpr float kTiny = (float)1e-20;
constexpr float kCosLo = (float)1e-6;
constexpr float kCosHi = (float)0.9999;
constexpr float kBig = (float)1e10;
constexpr float kZ0 = (float)0.27385;
constexpr float kZ1 = (float)0.73369;
constexpr float kZ2 = (float)0.46341;
constexpr float kZ3 = (float)0.093073;
constexpr float kZ4 = (float)0.309420;
constexpr float kZ5 = (float)1.000000;
constexpr float kZ6 = (float)0.597999;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 v;
  v.x = x;
  v.y = y;
  v.z = z;
  return v;
}
__device__ __forceinline__ V3 vneg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 vadd(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
// core/math.py dot: (a0 b0 + a1 b1) + a2 b2
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// torch.clamp_min / clamp_max / clamp with a scalar bound: a NaN operand
// is returned as it is
__device__ __forceinline__ float cmin(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float cmax(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
// torch.maximum: a NaN operand wins
__device__ __forceinline__ float fmax_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// core/math.py normalize: v / clamp_min(sqrt(dot(v, v)), 1e-20)
__device__ __forceinline__ V3 normalize(V3 v) {
  const float n = cmin(sqrtf(dot(v, v)), kTiny);
  return v3(v.x / n, v.y / n, v.z / n);
}

__device__ __forceinline__ bool same_hemisphere(V3 w, V3 wp) {
  return w.z * wp.z > 0.0f;
}

// reflect_about: -wo + (2 dot(wo, n)) n
__device__ __forceinline__ V3 reflect_about(V3 wo, V3 n) {
  const float d2 = 2.0f * dot(wo, n);
  return v3(-wo.x + d2 * n.x, -wo.y + d2 * n.y, -wo.z + d2 * n.z);
}

// refract: Snell refraction of wi about n with relative IOR eta; ok is
// False under total internal reflection
__device__ __forceinline__ V3 refract(V3 wi, V3 n, float eta, bool* ok) {
  const float cos_i = dot(n, wi);
  const float sin2_i = cmin(1.0f - cos_i * cos_i, 0.0f);
  const float sin2_t = eta * eta * sin2_i;
  *ok = sin2_t < 1.0f;
  const float cos_t = sqrtf(cmin(1.0f - sin2_t, 0.0f));
  const float c = eta * cos_i - cos_t;
  return v3(eta * -wi.x + c * n.x, eta * -wi.y + c * n.y,
            eta * -wi.z + c * n.z);
}

// _flip_to_wo_side: wi * (1, 1, -1) where wo.z < 0
__device__ __forceinline__ V3 flip_to_wo_side(V3 wi, V3 wo) {
  return wo.z < 0.0f ? v3(wi.x * 1.0f, wi.y * 1.0f, wi.z * -1.0f) : wi;
}

// core/sampling.py concentric_sample_disk then cosine_sample_hemisphere
__device__ __forceinline__ V3 cosine_sample_hemisphere(float u0, float u1) {
  const float x = 2.0f * u0 - 1.0f;
  const float y = 2.0f * u1 - 1.0f;
  const bool zero = (x == 0.0f) && (y == 0.0f);
  const bool x_major = fabsf(x) > fabsf(y);
  const float safe_x = x == 0.0f ? 1.0f : x;
  const float safe_y = y == 0.0f ? 1.0f : y;
  const float r = x_major ? x : y;
  const float theta = x_major ? kPiOver4 * (y / safe_x)
                              : kPiOver2 - kPiOver4 * (x / safe_y);
  float dx = r * cosf(theta);
  float dy = r * sinf(theta);
  if (zero) dx = dy = 0.0f;
  const float z = sqrtf(cmin(1.0f - dx * dx - dy * dy, 0.0f));
  return v3(dx, dy, z);
}

// ------------------------------------------------------------- fresnel
__device__ __forceinline__ float fr_dielectric(float cos_i, float eta_i,
                                               float eta_t) {
  cos_i = clampf(cos_i, -1.0f, 1.0f);
  const bool entering = cos_i > 0.0f;
  const float ei = entering ? eta_i : eta_t;
  const float et = entering ? eta_t : eta_i;
  const float ci = fabsf(cos_i);
  const float sin_i = sqrtf(cmin(1.0f - ci * ci, 0.0f));
  const float sin_t = ei / et * sin_i;
  const bool tir = sin_t >= 1.0f;
  const float ct = sqrtf(cmin(1.0f - sin_t * sin_t, 0.0f));
  const float r_parl = (et * ci - ei * ct) / cmin(et * ci + ei * ct, kTiny);
  const float r_perp = (ei * ci - et * ct) / cmin(ei * ci + et * ct, kTiny);
  const float fr = 0.5f * (r_parl * r_parl + r_perp * r_perp);
  return tir ? 1.0f : fr;
}

// fr_conductor of one channel: eta_i = 1
__device__ __forceinline__ float fr_conductor(float cos_i, float eta_t,
                                              float k) {
  const float ci = clampf(cos_i, -1.0f, 1.0f);
  const float eta = eta_t / 1.0f;
  const float etak = k / 1.0f;
  const float ci2 = ci * ci;
  const float si2 = 1.0f - ci2;
  const float eta2 = eta * eta;
  const float etak2 = etak * etak;
  const float t0 = eta2 - etak2 - si2;
  const float a2b2 = sqrtf(cmin(t0 * t0 + 4.0f * eta2 * etak2, 0.0f));
  const float t1 = a2b2 + ci2;
  const float a = sqrtf(cmin(0.5f * (a2b2 + t0), 0.0f));
  const float t2 = 2.0f * ci * a;
  const float rs = (t1 - t2) / cmin(t1 + t2, kTiny);
  const float t3 = ci2 * a2b2 + si2 * si2;
  const float t4 = t2 * si2;
  const float rp = rs * (t3 - t4) / cmin(t3 + t4, kTiny);
  return 0.5f * (rp + rs);
}

__device__ __forceinline__ float schlick_weight(float cos_t) {
  const float m = clampf(1.0f - cos_t, 0.0f, 1.0f);
  return (m * m) * (m * m) * m;
}

__device__ __forceinline__ float pow5(float v) {
  return (v * v) * (v * v) * v;
}

// ------------------------------------------------- Trowbridge-Reitz (GGX)
__device__ __forceinline__ void cos_sin_phi(V3 w, float sin_t, float* cphi,
                                            float* sphi) {
  const float inv_sin = 1.0f / cmin(sin_t, kTiny);
  const bool on_pole = sin_t == 0.0f;
  *cphi = on_pole ? 1.0f : clampf(w.x * inv_sin, -1.0f, 1.0f);
  *sphi = on_pole ? 1.0f : clampf(w.y * inv_sin, -1.0f, 1.0f);
}

__device__ __forceinline__ float tr_d(V3 wh, float ax, float ay) {
  const float c2 = wh.z * wh.z;
  const float s2 = cmin(1.0f - c2, 0.0f);
  const float tan2 = s2 / cmin(c2, kTiny);
  const bool finite = c2 > 0.0f;
  const float cos4 = c2 * c2;
  float cphi, sphi;
  cos_sin_phi(wh, sqrtf(s2), &cphi, &sphi);
  const float e = (cphi * cphi / (ax * ax) + sphi * sphi / (ay * ay)) * tan2;
  const float d = 1.0f / (kPiF * ax * ay * cos4 * (1.0f + e) * (1.0f + e));
  return finite ? d : 0.0f;
}

__device__ __forceinline__ float tr_lambda(V3 w, float ax, float ay) {
  const float c2 = w.z * w.z;
  const float s2 = cmin(1.0f - c2, 0.0f);
  const float abs_tan = sqrtf(s2) / cmin(fabsf(w.z), kTiny);
  const bool finite = c2 > 0.0f;
  float cphi, sphi;
  cos_sin_phi(w, sqrtf(s2), &cphi, &sphi);
  const float alpha = sqrtf(cphi * cphi * ax * ax + sphi * sphi * ay * ay);
  const float a2t2 = (alpha * abs_tan) * (alpha * abs_tan);
  // (-1.0 + sqrt(1 + a2t2)) / 2.0: PyTorch adds the scalar and multiplies
  // by the reciprocal
  const float lam = (sqrtf(1.0f + a2t2) + -1.0f) * 0.5f;
  return finite ? lam : 0.0f;
}

__device__ __forceinline__ float tr_g1(V3 w, float ax, float ay) {
  return 1.0f / (1.0f + tr_lambda(w, ax, ay));
}

// Smith G: joint, or G1(wo) G1(wi) where separable (Disney)
__device__ __forceinline__ float tr_g(V3 wo, V3 wi, float ax, float ay,
                                      bool separable) {
  if (separable) return tr_g1(wo, ax, ay) * tr_g1(wi, ax, ay);
  return 1.0f / (1.0f + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay));
}

// _tr_sample_11: visible-normal slopes for a unit isotropic roughness
__device__ __forceinline__ void tr_sample_11(float cos_t, float u1, float u2,
                                             float* sx_out, float* sy_out) {
  if (cos_t > kCosHi) {  // normal incidence
    const float r_ni = sqrtf(cmin(u1 / cmin(1.0f - u1, kTiny), 0.0f));
    const float phi_ni = kTwoPi * u2;
    *sx_out = r_ni * cosf(phi_ni);
    *sy_out = r_ni * sinf(phi_ni);
    return;
  }
  const float ct = clampf(cos_t, kCosLo, kCosHi);
  const float sin_t = sqrtf(cmin(1.0f - ct * ct, 0.0f));
  const float tan_t = sin_t / ct;
  const float a = 1.0f / tan_t;
  const float g1 = 2.0f / (1.0f + sqrtf(1.0f + 1.0f / (a * a)));
  const float A = 2.0f * u1 / g1 - 1.0f;
  const float denom = A * A - 1.0f;
  float tmp = denom == 0.0f ? kBig : 1.0f / (denom == 0.0f ? 1.0f : denom);
  tmp = cmax(tmp, kBig);
  const float B = tan_t;
  const float D =
      sqrtf(cmin(B * B * tmp * tmp - (A * A - B * B) * tmp, 0.0f));
  const float sx1 = B * tmp - D;
  const float sx2 = B * tmp + D;
  const float sx = (A < 0.0f || sx2 > 1.0f / tan_t) ? sx1 : sx2;
  const bool flip = u2 > 0.5f;
  const float s = flip ? 1.0f : -1.0f;
  const float u2b = flip ? 2.0f * (u2 - 0.5f) : 2.0f * (0.5f - u2);
  const float z = (u2b * (u2b * (u2b * kZ0 - kZ1) + kZ2)) /
                  (u2b * (u2b * (u2b * kZ3 + kZ4) - kZ5) + kZ6);
  *sx_out = sx;
  *sy_out = s * z * sqrtf(1.0f + sx * sx);
}

// tr_sample_wh: a visible GGX microfacet normal for wo
__device__ __forceinline__ V3 tr_sample_wh(V3 wo, float u0, float u1,
                                           float ax, float ay) {
  const bool flip = wo.z < 0.0f;
  const V3 w = flip ? vneg(wo) : wo;
  const V3 wi_str = normalize(v3(ax * w.x, ay * w.y, w.z));
  float sx, sy;
  tr_sample_11(wi_str.z, u0, u1, &sx, &sy);
  const float s2 = cmin(1.0f - wi_str.z * wi_str.z, 0.0f);
  float cphi, sphi;
  cos_sin_phi(wi_str, sqrtf(s2), &cphi, &sphi);
  const float rx = cphi * sx - sphi * sy;
  const float ry = sphi * sx + cphi * sy;
  const V3 wh = normalize(v3(-(ax * rx), -(ay * ry), 1.0f));
  return flip ? vneg(wh) : wh;
}

__device__ __forceinline__ float tr_pdf(V3 wo, V3 wh, float ax, float ay) {
  return tr_d(wh, ax, ay) * tr_g1(wo, ax, ay) * fabsf(dot(wo, wh)) /
         cmin(fabsf(wo.z), kTiny);
}

// ----------------------------------------------------------- lobes
// _microfacet_f: Torrance-Sparrow reflection; fresnel(ci, k) gives the
// Fresnel term of channel k at ci = dot(wi, wh)
template <class Fresnel>
__device__ __forceinline__ V3 microfacet_f(V3 r, V3 wo, V3 wi, float ax,
                                           float ay, bool separable,
                                           Fresnel fresnel) {
  const float cto = fabsf(wo.z);
  const float cti = fabsf(wi.z);
  const V3 wh = vadd(wi, wo);
  const bool ok = dot(wh, wh) > 0.0f && cti > 0.0f && cto > 0.0f;
  const V3 whn = normalize(wh);
  const float ci = dot(wi, whn);
  float fr[3];
  fresnel(ci, fr);
  const float d = tr_d(whn, ax, ay);
  const float g = tr_g(wo, wi, ax, ay, separable);
  const float den = cmin(4.0f * cti * cto, kTiny);
  if (!ok) return v3(0.0f, 0.0f, 0.0f);
  return v3(r.x * d * g * fr[0] / den, r.y * d * g * fr[1] / den,
            r.z * d * g * fr[2] / den);
}

__device__ __forceinline__ float microfacet_pdf(V3 wo, V3 wi, float ax,
                                                float ay) {
  const V3 wh = normalize(vadd(wo, wi));
  const float pdf = tr_pdf(wo, wh, ax, ay) / cmin(4.0f * dot(wo, wh), kTiny);
  return same_hemisphere(wo, wi) ? pdf : 0.0f;
}

// _mf_trans_f: microfacet transmission in radiance mode, eta_a = 1
__device__ __forceinline__ V3 mf_trans_f(V3 t, V3 wo, V3 wi, float ax,
                                         float ay, float eta_b) {
  const float cto = fabsf(wo.z);
  const float cti = fabsf(wi.z);
  const float eta = wo.z > 0.0f ? eta_b : 1.0f / eta_b;
  const V3 wh = v3(wo.x + wi.x * eta, wo.y + wi.y * eta, wo.z + wi.z * eta);
  const bool wh_ok = dot(wh, wh) > 0.0f;
  V3 whn = normalize(wh);
  whn = whn.z < 0.0f ? vneg(whn) : whn;
  const float d_o = dot(wo, whn);
  const float d_i = dot(wi, whn);
  const float fr = fr_dielectric(d_o, 1.0f, eta_b);
  const float sqrt_denom = d_o + eta * d_i;
  const float factor = 1.0f / eta;
  const float x = fabsf(tr_d(whn, ax, ay) * tr_g(wo, wi, ax, ay, false) *
                        eta * eta * fabsf(d_i) * fabsf(d_o) * factor *
                        factor /
                        cmin(cti * cto * sqrt_denom * sqrt_denom, kTiny));
  const bool ok = !same_hemisphere(wo, wi) && cti > 0.0f && cto > 0.0f &&
                  !(d_o * d_i > 0.0f) && wh_ok;
  if (!ok) return v3(0.0f, 0.0f, 0.0f);
  const float w = 1.0f - fr;
  return v3(w * t.x * x, w * t.y * x, w * t.z * x);
}

__device__ __forceinline__ float mf_trans_pdf(V3 wo, V3 wi, float ax,
                                              float ay, float eta_b) {
  const float eta = wo.z > 0.0f ? eta_b : 1.0f / eta_b;
  const V3 wh_raw =
      v3(wo.x + wi.x * eta, wo.y + wi.y * eta, wo.z + wi.z * eta);
  const bool wh_ok = dot(wh_raw, wh_raw) > 0.0f;
  const V3 wh = normalize(wh_raw);
  const float d_o = dot(wo, wh);
  const float d_i = dot(wi, wh);
  const float sqrt_denom = d_o + eta * d_i;
  const float dwh_dwi =
      fabsf(eta * eta * d_i / cmin(sqrt_denom * sqrt_denom, kTiny));
  const float pdf = tr_pdf(wo, wh, ax, ay) * dwh_dwi;
  const bool ok =
      wh_ok && !same_hemisphere(wo, wi) && !(d_o * d_i > 0.0f);
  return ok ? pdf : 0.0f;
}

// _fresnel_blend_f: Ashikhmin-Shirley substrate
__device__ __forceinline__ V3 fresnel_blend_f(V3 rd, V3 rs, V3 wo, V3 wi,
                                              float ax, float ay) {
  const float pi_ = 1.0f - pow5(1.0f - 0.5f * fabsf(wi.z));
  const float po = 1.0f - pow5(1.0f - 0.5f * fabsf(wo.z));
  const V3 wh = vadd(wi, wo);
  if (!(dot(wh, wh) > 0.0f)) return v3(0.0f, 0.0f, 0.0f);
  const V3 whn = normalize(wh);
  const float dw = dot(wi, whn);
  const float p5 = pow5(1.0f - dw);
  const float spec = tr_d(whn, ax, ay) /
                     cmin(4.0f * fabsf(dw) * fmax_nan(fabsf(wi.z),
                                                      fabsf(wo.z)),
                          kTiny);
  const float r[3] = {rd.x, rd.y, rd.z};
  const float s[3] = {rs.x, rs.y, rs.z};
  float out[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float diffuse = kFbDiffuse * r[k] * (1.0f - s[k]) * pi_ * po;
    const float schlick = s[k] + p5 * (1.0f - s[k]);
    out[k] = diffuse + spec * schlick;
  }
  return v3(out[0], out[1], out[2]);
}

__device__ __forceinline__ float fresnel_blend_pdf(V3 wo, V3 wi, float ax,
                                                   float ay) {
  const V3 wh = normalize(vadd(wo, wi));
  const float pdf_wh = tr_pdf(wo, wh, ax, ay);
  const float pdf = 0.5f * (fabsf(wi.z) * kInvPi +
                            pdf_wh / cmin(4.0f * dot(wo, wh), kTiny));
  return same_hemisphere(wo, wi) ? pdf : 0.0f;
}

__device__ __forceinline__ float cosine_pdf(V3 wo, V3 wi) {
  return same_hemisphere(wo, wi) ? fabsf(wi.z) * kInvPi : 0.0f;
}

// ------------------------------------------------------------ inputs
// an (N,) f32 or i32 column and an (N, 3) f32 table, by element strides
struct Col {
  const float* p;
  int s;
};
struct Rgb {
  const float* p;
  int rs, cs;
};
// the material parameters of ops/bsdf.py gather_params, as they come
struct Mat {
  const int* type;
  int type_s;
  Rgb kd, ks;
  Col eta;
  Rgb eta3, k;
  Col ax, ay, metallic;
};
// the hits' shading frame and geometric normal, (N, 3) each, contiguous
struct Frame {
  const float *ss, *ts, *ns, *ng;
};

__device__ __forceinline__ float ld(Col c, int i) {
  return __ldg(c.p + (int64_t)i * c.s);
}
__device__ __forceinline__ V3 ld3(Rgb c, int i) {
  const float* q = c.p + (int64_t)i * c.rs;
  return v3(__ldg(q), __ldg(q + c.cs), __ldg(q + 2 * (int64_t)c.cs));
}
__device__ __forceinline__ V3 ldv(const float* p, int i) {
  const float* q = p + 3 * (int64_t)i;
  return v3(__ldg(q), __ldg(q + 1), __ldg(q + 2));
}

// one lane's frame
struct Basis {
  V3 ss, ts, ns, ng;
};

__device__ __forceinline__ Basis ld_basis(const Frame& fr, int i) {
  Basis b;
  b.ss = ldv(fr.ss, i);
  b.ts = ldv(fr.ts, i);
  b.ns = ldv(fr.ns, i);
  b.ng = ldv(fr.ng, i);
  return b;
}

// ops/bsdf.py to_local: (dot(w, ss), dot(w, ts), dot(w, ns))
__device__ __forceinline__ V3 to_local(const Basis& b, V3 w) {
  return v3(dot(w, b.ss), dot(w, b.ts), dot(w, b.ns));
}

// ops/bsdf.py to_world: (w.x ss + w.y ts) + w.z ns
__device__ __forceinline__ V3 to_world(const Basis& b, V3 w) {
  return v3(w.x * b.ss.x + w.y * b.ts.x + w.z * b.ns.x,
            w.x * b.ss.y + w.y * b.ts.y + w.z * b.ns.y,
            w.x * b.ss.z + w.y * b.ts.z + w.z * b.ns.z);
}

// ops/bsdf.py reflect_ng_test: (dot(to_world(wi), ng) * wo_ng) > 0, wo_ng
// = dot(wo_world, ng)
__device__ __forceinline__ bool reflect_ng(const Basis& b, float wo_ng,
                                           V3 wi) {
  return dot(to_world(b, wi), b.ng) * wo_ng > 0.0f;
}

// _disney_lobes: the diffuse color (1 - metallic) c and c_spec0
__device__ __forceinline__ void disney_lobes(V3 c, float metallic, float eta,
                                             V3* dif_c, V3* c_spec0) {
  const float dw = 1.0f - metallic;
  const float r0 = (eta - 1.0f) * (eta - 1.0f) / ((eta + 1.0f) * (eta + 1.0f));
  const float r0m = r0 * 1.0f * (1.0f - metallic);
  *c_spec0 = v3(r0m + c.x * metallic, r0m + c.y * metallic,
                r0m + c.z * metallic);
  *dif_c = v3(dw * c.x, dw * c.y, dw * c.z);
}

// _disney_f: Burley diffuse + separable-G GGX with the Disney Fresnel
__device__ __forceinline__ V3 disney_f(V3 dif_c, V3 c_spec0, float metallic,
                                       float eta, V3 wo, V3 wi, float ax,
                                       float ay) {
  const float fo = schlick_weight(fabsf(wo.z));
  const float fi = schlick_weight(fabsf(wi.z));
  const float dd = (1.0f - fo * 0.5f) * (1.0f - fi * 0.5f);
  const V3 dif = v3(dif_c.x * kInvPi * dd, dif_c.y * kInvPi * dd,
                    dif_c.z * kInvPi * dd);
  const float cs[3] = {c_spec0.x, c_spec0.y, c_spec0.z};
  const V3 spec = microfacet_f(
      v3(1.0f, 1.0f, 1.0f), wo, wi, ax, ay, true,
      [&](float ci, float* fr) {
        const float diel = fr_dielectric(ci, 1.0f, eta);
        const float w = schlick_weight(ci);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float schlick = cs[k] * (1.0f - w) + 1.0f * w;
          fr[k] = diel * (1.0f - metallic) + schlick * metallic;
        }
      });
  return vadd(dif, spec);
}

__device__ __forceinline__ V3 conductor_f(const Mat& m, int i, V3 wo, V3 wi,
                                          float ax, float ay) {
  const V3 e = ld3(m.eta3, i), kk = ld3(m.k, i);
  return microfacet_f(ld3(m.ks, i), wo, wi, ax, ay, false,
                      [&](float ci, float* fr) {
                        const float c = fabsf(ci);
                        fr[0] = fr_conductor(c, e.x, kk.x);
                        fr[1] = fr_conductor(c, e.y, kk.y);
                        fr[2] = fr_conductor(c, e.z, kk.z);
                      });
}

__device__ __forceinline__ V3 dielectric_f(V3 r, V3 wo, V3 wi, float ax,
                                           float ay, float eta_b) {
  return microfacet_f(r, wo, wi, ax, ay, false, [&](float ci, float* fr) {
    fr[0] = fr[1] = fr[2] = fr_dielectric(ci, 1.0f, eta_b);
  });
}

__device__ __forceinline__ bool has(int present, int t) {
  return (unsigned)t < N_MATERIALS && ((present >> t) & 1);
}

// ----------------------------------------------------------- K5
__global__ void __launch_bounds__(kThreads) bsdf_eval_kernel(
    Mat m, Frame frame, const float* __restrict__ wo_p,
    const float* __restrict__ wi_p, int present, int n,
    float* __restrict__ f_out, float* __restrict__ pdf_out,
    float* __restrict__ cos_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int t = __ldg(m.type + (int64_t)i * m.type_s);
  const Basis b = ld_basis(frame, i);
  const V3 wo_w = ldv(wo_p, i), wi_w = ldv(wi_p, i);
  const bool refl = dot(wi_w, b.ng) * dot(wo_w, b.ng) > 0.0f;
  const V3 wo = to_local(b, wo_w), wi = to_local(b, wi_w);
  V3 f = v3(0.0f, 0.0f, 0.0f);
  float pdf = 0.0f;
  if (has(present, t)) {
    switch (t) {
      case MAT_MATTE: {
        const V3 kd = ld3(m.kd, i);
        f = v3(kd.x * kInvPi, kd.y * kInvPi, kd.z * kInvPi);
        pdf = cosine_pdf(wo, wi);
        break;
      }
      case MAT_METAL: {
        const float ax = ld(m.ax, i), ay = ld(m.ay, i);
        f = conductor_f(m, i, wo, wi, ax, ay);
        pdf = microfacet_pdf(wo, wi, ax, ay);
        break;
      }
      case MAT_SUBSTRATE: {
        const float ax = ld(m.ax, i), ay = ld(m.ay, i);
        f = fresnel_blend_f(ld3(m.kd, i), ld3(m.ks, i), wo, wi, ax, ay);
        pdf = fresnel_blend_pdf(wo, wi, ax, ay);
        break;
      }
      case MAT_DISNEY: {
        const float ax = ld(m.ax, i), ay = ld(m.ay, i);
        const float metallic = ld(m.metallic, i), eta = ld(m.eta, i);
        V3 dif_c, c_spec0;
        disney_lobes(ld3(m.kd, i), metallic, eta, &dif_c, &c_spec0);
        f = disney_f(dif_c, c_spec0, metallic, eta, wo, wi, ax, ay);
        pdf = 0.5f * (cosine_pdf(wo, wi) + microfacet_pdf(wo, wi, ax, ay));
        break;
      }
      case MAT_ROUGHGLASS: {
        // the ng test routes f to the matching lobe; the pdf averages both
        const float ax = ld(m.ax, i), ay = ld(m.ay, i);
        const float eta_b = ld(m.eta, i);
        f = refl ? dielectric_f(ld3(m.kd, i), wo, wi, ax, ay, eta_b)
                 : mf_trans_f(ld3(m.ks, i), wo, wi, ax, ay, eta_b);
        pdf = 0.5f * (microfacet_pdf(wo, wi, ax, ay) +
                      mf_trans_pdf(wo, wi, ax, ay, eta_b));
        break;
      }
      default:  // MIRROR, GLASS: specular, f = pdf = 0
        break;
    }
  }
  // every lobe but rough glass's transmission reflects
  const bool wo_ok = wo.z != 0.0f;
  const bool allow =
      refl || (has(present, MAT_ROUGHGLASS) && t == MAT_ROUGHGLASS);
  if (!(allow && wo_ok)) f = v3(0.0f, 0.0f, 0.0f);
  if (!wo_ok) pdf = 0.0f;
  float* fo = f_out + 3 * (int64_t)i;
  fo[0] = f.x;
  fo[1] = f.y;
  fo[2] = f.z;
  pdf_out[i] = pdf;
  cos_out[i] = fabsf(dot(wi_w, b.ns));
}

// ----------------------------------------------------------- K6
struct Sample {
  V3 wi, f;
  float pdf;
  bool trans;
};

// sample_f's branch of type t for lane i
__device__ __forceinline__ Sample sample_branch(int t, const Mat& m,
                                                const Basis& b, float wo_ng,
                                                int i, V3 wo, float u0,
                                                float u1) {
  Sample s;
  s.f = v3(0.0f, 0.0f, 0.0f);
  s.pdf = 0.0f;
  s.trans = false;
  switch (t) {
    case MAT_MATTE: {
      s.wi = flip_to_wo_side(cosine_sample_hemisphere(u0, u1), wo);
      const V3 kd = ld3(m.kd, i);
      s.f = v3(kd.x * kInvPi, kd.y * kInvPi, kd.z * kInvPi);
      s.pdf = cosine_pdf(wo, s.wi);
      break;
    }
    case MAT_MIRROR: {
      s.wi = v3(-wo.x, -wo.y, wo.z);
      const float v = 1.0f / cmin(fabsf(s.wi.z), kTiny);
      s.f = v3(v, v, v);
      s.pdf = 1.0f;
      break;
    }
    case MAT_GLASS: {
      const float eta_b = ld(m.eta, i);
      const float fr = fr_dielectric(wo.z, 1.0f, eta_b);
      const bool take_refl = u0 < fr;
      if (take_refl) {
        s.wi = v3(-wo.x, -wo.y, wo.z);
        const V3 kd = ld3(m.kd, i);
        const float den = cmin(fabsf(s.wi.z), kTiny);
        s.f = v3(fr * kd.x / den, fr * kd.y / den, fr * kd.z / den);
        s.pdf = fr;
      } else {
        const bool entering = wo.z > 0.0f;
        const float ei = entering ? 1.0f : eta_b;
        const float et = entering ? eta_b : 1.0f;
        bool ok;
        s.wi = refract(wo, v3(0.0f, 0.0f, entering ? 1.0f : -1.0f), ei / et,
                       &ok);
        if (ok) {
          const V3 ks = ld3(m.ks, i);
          const float w = 1.0f - fr;
          const float r = (ei * ei) / (et * et);
          const float den = cmin(fabsf(s.wi.z), kTiny);
          s.f = v3(ks.x * w * r / den, ks.y * w * r / den,
                   ks.z * w * r / den);
        }
        s.pdf = 1.0f - fr;
        s.trans = true;
      }
      break;
    }
    case MAT_METAL: {
      const float ax = ld(m.ax, i), ay = ld(m.ay, i);
      const V3 wh = tr_sample_wh(wo, u0, u1, ax, ay);
      s.wi = reflect_about(wo, wh);
      const float dwh = dot(wo, wh);
      if (wo.z != 0.0f && dwh >= 0.0f && same_hemisphere(wo, s.wi)) {
        s.pdf = tr_pdf(wo, wh, ax, ay) / cmin(4.0f * dwh, kTiny);
        s.f = conductor_f(m, i, wo, s.wi, ax, ay);
      }
      break;
    }
    case MAT_SUBSTRATE: {
      const float ax = ld(m.ax, i), ay = ld(m.ay, i);
      const bool half = u0 < 0.5f;
      const float us0 = half ? cmax(2.0f * u0, 0x1.fffffep-1f)
                             : cmax(2.0f * (u0 - 0.5f), 0x1.fffffep-1f);
      s.wi = half ? flip_to_wo_side(cosine_sample_hemisphere(us0, u1), wo)
                  : reflect_about(wo, tr_sample_wh(wo, us0, u1, ax, ay));
      if (half || same_hemisphere(wo, s.wi)) {
        s.pdf = fresnel_blend_pdf(wo, s.wi, ax, ay);
        s.f = fresnel_blend_f(ld3(m.kd, i), ld3(m.ks, i), wo, s.wi, ax, ay);
      }
      break;
    }
    case MAT_DISNEY: {
      // uniform pick of the two lobes, u0 remapped into the lobe
      const float ax = ld(m.ax, i), ay = ld(m.ay, i);
      const float comp = cmax(floorf(u0 * 2.0f), 1.0f);
      const float ud0 = u0 * 2.0f - comp;
      const bool take_diff = comp == 0.0f;
      bool lobe_ok = true;
      if (take_diff) {
        s.wi = flip_to_wo_side(cosine_sample_hemisphere(ud0, u1), wo);
      } else {
        const V3 wh = tr_sample_wh(wo, ud0, u1, ax, ay);
        s.wi = reflect_about(wo, wh);
        lobe_ok = wo.z != 0.0f && dot(wo, wh) >= 0.0f;
      }
      if (lobe_ok) {
        s.pdf = 0.5f * (cosine_pdf(wo, s.wi) +
                        microfacet_pdf(wo, s.wi, ax, ay));
        if (reflect_ng(b, wo_ng, s.wi)) {
          const float metallic = ld(m.metallic, i), eta = ld(m.eta, i);
          V3 dif_c, c_spec0;
          disney_lobes(ld3(m.kd, i), metallic, eta, &dif_c, &c_spec0);
          s.f = disney_f(dif_c, c_spec0, metallic, eta, wo, s.wi, ax, ay);
        }
      }
      break;
    }
    case MAT_ROUGHGLASS: {
      // uniform pick of reflection / transmission, u0 remapped, then f
      // and pdf over both lobes
      const float ax = ld(m.ax, i), ay = ld(m.ay, i);
      const float eta_b = ld(m.eta, i);
      const bool take_refl = u0 < 0.5f;
      const float ug0 = take_refl ? cmax(2.0f * u0, 0x1.fffffep-1f)
                                  : cmax(2.0f * (u0 - 0.5f), 0x1.fffffep-1f);
      const V3 wh = tr_sample_wh(wo, ug0, u1, ax, ay);
      const float dwh = dot(wo, wh);
      bool lobe_ok = dwh >= 0.0f && wo.z != 0.0f;
      if (take_refl) {
        s.wi = reflect_about(wo, wh);
        lobe_ok = lobe_ok && same_hemisphere(wo, s.wi);
      } else {
        // refract about wh faced to wo's side
        const float eta_ratio = wo.z > 0.0f ? 1.0f / eta_b : eta_b;
        bool ok;
        s.wi = refract(wo, dwh < 0.0f ? vneg(wh) : wh, eta_ratio, &ok);
        lobe_ok = lobe_ok && ok;
      }
      const bool rng = reflect_ng(b, wo_ng, s.wi);
      s.trans = !rng;
      if (lobe_ok) {
        s.f = rng ? dielectric_f(ld3(m.kd, i), wo, s.wi, ax, ay, eta_b)
                  : mf_trans_f(ld3(m.ks, i), wo, s.wi, ax, ay, eta_b);
        s.pdf = 0.5f * (microfacet_pdf(wo, s.wi, ax, ay) +
                        mf_trans_pdf(wo, s.wi, ax, ay, eta_b));
      }
      break;
    }
    default:
      s.wi = v3(0.0f, 0.0f, 1.0f);
      break;
  }
  return s;
}

__global__ void __launch_bounds__(kThreads) bsdf_sample_kernel(
    Mat m, Frame frame, const float* __restrict__ wo_p,
    const float* __restrict__ u_p, int present, int n,
    float* __restrict__ wi_out, float* __restrict__ f_out,
    float* __restrict__ pdf_out, uint8_t* __restrict__ spec_out,
    uint8_t* __restrict__ trans_out, float* __restrict__ cos_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int t = __ldg(m.type + (int64_t)i * m.type_s);
  const Basis b = ld_basis(frame, i);
  const V3 wo_w = ldv(wo_p, i);
  const float wo_ng = dot(wo_w, b.ng);
  const V3 wo = to_local(b, wo_w);
  const float u0 = __ldg(u_p + 2 * (int64_t)i);
  const float u1 = __ldg(u_p + 2 * (int64_t)i + 1);
  const bool in = has(present, t);
  // a lane outside `present` takes the first present branch's wi, and
  // nothing else of it (with none present: wi = (0, 0, 1))
  const int bt = in ? t : (present ? __ffs(present) - 1 : -1);
  Sample s = sample_branch(bt, m, b, wo_ng, i, wo, u0, u1);
  if (!in) {
    s.f = v3(0.0f, 0.0f, 0.0f);
    s.pdf = 0.0f;
    s.trans = false;
  }
  const V3 wi_w = to_world(b, s.wi);
  float* wio = wi_out + 3 * (int64_t)i;
  wio[0] = wi_w.x;
  wio[1] = wi_w.y;
  wio[2] = wi_w.z;
  float* fo = f_out + 3 * (int64_t)i;
  fo[0] = s.f.x;
  fo[1] = s.f.y;
  fo[2] = s.f.z;
  pdf_out[i] = s.pdf;
  spec_out[i] = (t == MAT_MIRROR || t == MAT_GLASS) ? 1 : 0;
  trans_out[i] = s.trans ? 1 : 0;
  cos_out[i] = fabsf(dot(wi_w, b.ns));
}

__host__ Mat make_mat(const int* type, int type_s, const float* kd, int kd_r,
                      int kd_c, const float* ks, int ks_r, int ks_c,
                      const float* eta, int eta_s, const float* eta3,
                      int eta3_r, int eta3_c, const float* k, int k_r,
                      int k_c, const float* ax, int ax_s, const float* ay,
                      int ay_s, const float* metallic, int metallic_s) {
  Mat m;
  m.type = type;
  m.type_s = type_s;
  m.kd = Rgb{kd, kd_r, kd_c};
  m.ks = Rgb{ks, ks_r, ks_c};
  m.eta = Col{eta, eta_s};
  m.eta3 = Rgb{eta3, eta3_r, eta3_c};
  m.k = Rgb{k, k_r, k_c};
  m.ax = Col{ax, ax_s};
  m.ay = Col{ay, ay_s};
  m.metallic = Col{metallic, metallic_s};
  return m;
}

}  // namespace

#define MAT_PARAMS                                                          \
  const int *type, int type_s, const float *kd, int kd_r, int kd_c,         \
      const float *ks, int ks_r, int ks_c, const float *eta, int eta_s,     \
      const float *eta3, int eta3_r, int eta3_c, const float *k, int k_r,   \
      int k_c, const float *ax, int ax_s, const float *ay, int ay_s,        \
      const float *metallic, int metallic_s
#define MAT_ARGS                                                          \
  type, type_s, kd, kd_r, kd_c, ks, ks_r, ks_c, eta, eta_s, eta3, eta3_r, \
      eta3_c, k, k_r, k_c, ax, ax_s, ay, ay_s, metallic, metallic_s

// the frame argument of both launchers
#define FRAME_PARAMS \
  const float *ss, const float *ts, const float *ns, const float *ng

__host__ static Frame make_frame(FRAME_PARAMS) {
  Frame frame;
  frame.ss = ss;
  frame.ts = ts;
  frame.ns = ns;
  frame.ng = ng;
  return frame;
}

// K5: f (N, 3), pdf (N,) and |wi.ns| (N,) of the lanes' materials (each
// parameter by its element strides: a column of a table, or a table of 3
// columns) at the world wo, wi (N, 3) of the hits with the frames ss, ts,
// ns and the geometric normals ng (N, 3); present: bit t for each
// material type the scene holds.
extern "C" int pt_bsdf_eval_launch(MAT_PARAMS, FRAME_PARAMS, const float* wo,
                                   const float* wi, int present, int n,
                                   float* f, float* pdf, float* cosine,
                                   void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  bsdf_eval_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      make_mat(MAT_ARGS), make_frame(ss, ts, ns, ng), wo, wi, present, n, f,
      pdf, cosine);
  return (int)cudaGetLastError();
}

// K6: the world wi, f (N, 3), pdf (N,), specular, transmission (N,) bool
// and |wi.ns| (N,) sampled at the world wo (N, 3) with u (N, 2), at the
// hits of frames ss, ts, ns and geometric normals ng.
extern "C" int pt_bsdf_sample_launch(MAT_PARAMS, FRAME_PARAMS,
                                     const float* wo, const float* u,
                                     int present, int n, float* wi, float* f,
                                     float* pdf, uint8_t* specular,
                                     uint8_t* transmission, float* cosine,
                                     void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  bsdf_sample_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      make_mat(MAT_ARGS), make_frame(ss, ts, ns, ng), wo, u, present, n, wi,
      f, pdf, specular, transmission, cosine);
  return (int)cudaGetLastError();
}
