// Kernels K3 (texture_eval) and K4 (alpha_cut): texture descriptors and the
// mip-pool lookup, and the alpha-mask cut test, for Hopper.
//
// Neither replaces a Pallas kernel: the JAX package computes both with XLA
// per-lane gathers (Mosaic has no per-lane vector gather), and eager
// PyTorch splits each call into ~100-230 small kernels.
//   * K3 replaces pathtracer_tpu/ops/bsdf.py eval_texture with the pool
//     lookup of pathtracer_tpu/scene/texture.py (_texel, _triangle,
//     lookup_width), and computes exactly what the plain PyTorch version
//     pathtracer_tpu_torch/ops/bsdf.py eval_texture_plain computes: per
//     lane the descriptor (constant, checker or image over its UV map),
//     for an image the wrapped texel fetches of one level (static mode:
//     level 0, bilinear) or of two (width mode: trilinear at n_levels - 1
//     + log2(width), the width from the UV derivatives), the sRGB decode,
//     the scale and the channel broadcast; the fallback where the
//     descriptor id is negative.
//   * K4 replaces pathtracer_tpu/integrator.py _alpha_cut, as the plain
//     version pathtracer_tpu_torch/integrator.py _alpha_cut_plain: the
//     tri_attr row of the hit, the uv from the barycentrics, K3's evaluator
//     at width 0 on the mask descriptor, cut = valid & txd >= 0 & alpha ==
//     0, and the re-spawn's hit point, its error bound (gamma(7)) and the
//     geometric normal.
//
// What bounds them on an H100: bytes, and the latency of dependent
// gathers. A K3 lane reads its id, uv (and 4 UV derivatives in width
// mode) and maybe its fallback, its descriptor's two rows, and 4 or 8
// texels of 12 B at data-dependent addresses; it writes 12 B. A K4 lane
// reads its tri id, barycentrics and valid flag, 19 floats of its
// tri_attr row, and for a masked hit the descriptor rows and 4 texels; it
// writes 37 B. The arithmetic is a few dozen FP32 operations a lane. The
// design: one thread a lane, everything in registers, one launch a call
// in place of the plain version's chain of gathers and selects; the
// descriptor rows (a few KB for a whole scene: an image descriptor's
// level tables are copied into its i32 row, so a texel address takes no
// gather through a texture id) and the texels go through the read-only
// path (__ldg), no shared memory. A lane reads only what its own arm
// needs: no pool read for a constant, checker or fallback lane, no mask
// lookup for a missed or unmasked hit.
//
// Bit-exactness with the plain version on the card: build with
// -fmad=false and without --use_fast_math (ops/cuda/_build.py), every
// product and sum in the plain version's order, and each op as PyTorch's
// CUDA op computes it:
//   * x / 12.92 and x / 1.055 (division of a tensor by a Python scalar):
//     PyTorch multiplies by the reciprocal (taken in double, rounded to
//     float), so do we;
//   * torch.pow(x, 2.4) is powf(x, 2.4f); torch.log2 is log2f;
//   * torch.remainder on int32 (the texel wrap) is a floor-mod; on floats
//     (the checker parity, integer-valued here) it is exact either way;
//   * float -> int32 conversion truncates and saturates (cvt.rzi, NaN ->
//     0): __float2int_rz;
//   * int32 sums wrap (offset + t * w + s, s0 + 1): done in unsigned; no
//     pool index goes through a float;
//   * torch.maximum / minimum / clamp propagate a NaN: fmax_nan below;
//   * the BLACK wrap writes +0.0.
// The static and width modes are chosen by the caller (a Python 0 width
// and an all-zero width tensor round differently) and never from the data.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// descriptor rows (pathtracer_tpu_torch/scene/texture.py: TXF_*, TXI_*)
#define TXF_UV 0
#define TXF_RGB0 4
#define TXF_RGB1 7
#define TXF_SCALE 10
#define TXF_WIDTH 16
#define TXI_KIND 0
#define TXI_SRGB 1
#define TXI_CHANNEL 2
#define TXI_NLEVELS 3
#define TXI_WRAP 4
#define TXI_OFFSET 16
#define TXI_W 32
#define TXI_H 48
#define TXI_WIDTH 64
// wrap modes (scene/texture.py)
#define WRAP_REPEAT 0
#define WRAP_BLACK 1
// tri_attr columns (scene/scene.py: TA_*)
#define TA_P0 0
#define TA_UV0 18
#define TA_NG0 24
#define TA_ALPHA 42
#define TA_WIDTH 43

#ifndef TX_BLOCK
#define TX_BLOCK 256
#endif

namespace {

constexpr int kThreads = TX_BLOCK;

struct rgb {
  float c[3];
};

// torch.maximum / torch.minimum / clamp on floats: a NaN operand wins
__device__ __forceinline__ float fmax_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float fmin_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// torch.remainder on int32 (b > 0 here: a level's width or height)
__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// scene/texture.py _texel: the wrapped texel (s, t) of one level
__device__ __forceinline__ rgb texel(const float* __restrict__ data, int off,
                                     int w, int h, int wrap, int s, int t) {
  rgb v;
  if (wrap == WRAP_BLACK && (s < 0 || s >= w || t < 0 || t >= h)) {
    v.c[0] = v.c[1] = v.c[2] = 0.0f;
    return v;
  }
  int si, ti;
  if (wrap == WRAP_REPEAT) {
    si = floor_mod(s, w);
    ti = floor_mod(t, h);
  } else {  // CLAMP, and BLACK inside
    si = min(max(s, 0), w - 1);
    ti = min(max(t, 0), h - 1);
  }
  const int idx = (int)((unsigned)off + (unsigned)ti * (unsigned)w +
                        (unsigned)si);
  const float* p = data + 3 * (int64_t)idx;
  v.c[0] = __ldg(p);
  v.c[1] = __ldg(p + 1);
  v.c[2] = __ldg(p + 2);
  return v;
}

// scene/texture.py _triangle: bilinear at one level, clipped to the
// texture's levels
__device__ __forceinline__ rgb bilerp(const float* __restrict__ data,
                                      const int* __restrict__ ti, int level,
                                      float st0, float st1) {
  const int n_levels = __ldg(ti + TXI_NLEVELS);
  level = min(max(level, 0), n_levels - 1);
  const int wi = __ldg(ti + TXI_W + level);
  const int hi = __ldg(ti + TXI_H + level);
  const int off = __ldg(ti + TXI_OFFSET + level);
  const int wrap = __ldg(ti + TXI_WRAP);
  const float s = st0 * (float)wi - 0.5f;
  const float t = st1 * (float)hi - 0.5f;
  const float s0 = floorf(s);
  const float t0 = floorf(t);
  const float ds = s - s0;
  const float dt = t - t0;
  const int is0 = __float2int_rz(s0);
  const int it0 = __float2int_rz(t0);
  const int is1 = wrap_add(is0, 1);
  const int it1 = wrap_add(it0, 1);
  const rgb a = texel(data, off, wi, hi, wrap, is0, it0);
  const rgb b = texel(data, off, wi, hi, wrap, is0, it1);
  const rgb c = texel(data, off, wi, hi, wrap, is1, it0);
  const rgb d = texel(data, off, wi, hi, wrap, is1, it1);
  const float ms = 1.0f - ds;
  const float mt = 1.0f - dt;
  rgb v;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    v.c[k] = a.c[k] * ms * mt + b.c[k] * ms * dt + c.c[k] * ds * mt +
             d.c[k] * ds * dt;
  return v;
}

// core/math.py inverse_gamma_correct (sRGB -> linear). PyTorch divides
// a float tensor by a Python scalar as a product with the reciprocal taken
// in double and rounded to float: 1 / 1.055 so rounded is one ulp off the
// float reciprocal of 1.055f.
__device__ __forceinline__ float srgb_decode(float v) {
  constexpr float kInv1292 = (float)(1.0 / 12.92);
  constexpr float kInv1055 = (float)(1.0 / 1.055);
  return v <= 0.04045f ? v * kInv1292
                       : powf((v + 0.055f) * kInv1055, 2.4f);
}

// ops/bsdf.py eval_texture_plain for one lane whose descriptor id d >= 0.
// width < 0 is the static mode (level 0, bilinear); otherwise the filter
// width of the width mode.
__device__ __forceinline__ rgb eval_descriptor(
    const float* __restrict__ txf, const int* __restrict__ txi,
    const float* __restrict__ data, int d, float u, float v, bool width_mode,
    float dudx, float dvdx, float dudy, float dvdy, bool image) {
  const float* tf = txf + (int64_t)d * TXF_WIDTH;
  const int* ti = txi + (int64_t)d * TXI_WIDTH;
  const int kind = __ldg(ti + TXI_KIND);
  const float su = __ldg(tf + TXF_UV), sv = __ldg(tf + TXF_UV + 1);
  const float st0 = u * su + __ldg(tf + TXF_UV + 2);
  const float st1 = v * sv + __ldg(tf + TXF_UV + 3);
  rgb out;
  if (image && kind == 2) {
    if (width_mode) {
      const float width =
          fmax_nan(fmax_nan(fabsf(su * dudx), fabsf(sv * dvdx)),
                   fmax_nan(fabsf(su * dudy), fabsf(sv * dvdy)));
      const float n_lev = (float)__ldg(ti + TXI_NLEVELS);
      const float level =
          n_lev - 1.0f + log2f(width != width || width >= 1e-8f ? width
                                                                : 1e-8f);
      const float lo_f = floorf(
          fmin_nan(level != level || level >= 0.0f ? level : 0.0f,
                   n_lev - 1.0f));
      const int lo = __float2int_rz(lo_f);
      float delta = level - (float)lo;
      delta = fmin_nan(delta != delta || delta >= 0.0f ? delta : 0.0f, 1.0f);
      const rgb v0 = bilerp(data, ti, lo, st0, st1);
      const rgb v1 = bilerp(data, ti, lo + 1, st0, st1);
      const float md = 1.0f - delta;
#pragma unroll
      for (int k = 0; k < 3; ++k) out.c[k] = v0.c[k] * md + v1.c[k] * delta;
    } else {
      out = bilerp(data, ti, 0, st0, st1);
    }
    if (__ldg(ti + TXI_SRGB)) {
#pragma unroll
      for (int k = 0; k < 3; ++k) out.c[k] = srgb_decode(out.c[k]);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) out.c[k] = out.c[k] * __ldg(tf + TXF_SCALE + k);
    const int ch = __ldg(ti + TXI_CHANNEL);
    if (ch >= 0) {
      const float x = out.c[ch];
      out.c[0] = out.c[1] = out.c[2] = x;
    }
  } else if (kind == 1) {
    const float parity = fmodf(floorf(st0) + floorf(st1), 2.0f);
    // torch.remainder's sign fix: the sum is integral, so fmodf is exact
    const float p = (parity != 0.0f && parity < 0.0f) ? parity + 2.0f
                                                      : parity;
    const float* src = tf + (p == 0.0f ? TXF_RGB0 : TXF_RGB1);
#pragma unroll
    for (int k = 0; k < 3; ++k) out.c[k] = __ldg(src + k);
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) out.c[k] = __ldg(tf + TXF_RGB0 + k);
  }
  return out;
}

__global__ void __launch_bounds__(kThreads) texture_eval_kernel(
    const float* __restrict__ txf, const int* __restrict__ txi,
    const float* __restrict__ data, const int* __restrict__ txd_id,
    const float* __restrict__ uv, const float* __restrict__ fallback,
    int fb_row, int fb_col, const float* __restrict__ dudx,
    const float* __restrict__ dvdx, const float* __restrict__ dudy,
    const float* __restrict__ dvdy, int n, int width_mode, int image,
    float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int d = txd_id[i];
  rgb v;
  if (d < 0) {
    const float* fb = fallback + (int64_t)i * fb_row;
#pragma unroll
    for (int k = 0; k < 3; ++k) v.c[k] = fb[(int64_t)k * fb_col];
  } else if (width_mode) {
    v = eval_descriptor(txf, txi, data, d, uv[2 * i], uv[2 * i + 1], true,
                        dudx[i], dvdx[i], dudy[i], dvdy[i], image != 0);
  } else {
    v = eval_descriptor(txf, txi, data, d, uv[2 * i], uv[2 * i + 1], false,
                        0.0f, 0.0f, 0.0f, 0.0f, image != 0);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) out[3 * (int64_t)i + k] = v.c[k];
}

__global__ void __launch_bounds__(kThreads) alpha_cut_kernel(
    const float* __restrict__ txf, const int* __restrict__ txi,
    const float* __restrict__ data, const float* __restrict__ tri_attr,
    const int* __restrict__ tri, const float* __restrict__ bary,
    const uint8_t* __restrict__ valid, int n, float gamma7,
    uint8_t* __restrict__ cut, float* __restrict__ p_hit,
    float* __restrict__ p_err, float* __restrict__ ng) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* row = tri_attr + (int64_t)tri[i] * TA_WIDTH;
  const float b0 = bary[3 * i], b1 = bary[3 * i + 1], b2 = bary[3 * i + 2];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float q0 = b0 * __ldg(row + TA_P0 + k);
    const float q1 = b1 * __ldg(row + TA_P0 + 3 + k);
    const float q2 = b2 * __ldg(row + TA_P0 + 6 + k);
    p_hit[3 * (int64_t)i + k] = q0 + q1 + q2;
    p_err[3 * (int64_t)i + k] = gamma7 * (fabsf(q0) + fabsf(q1) + fabsf(q2));
    ng[3 * (int64_t)i + k] = __ldg(row + TA_NG0 + k);
  }
  const int txd = __float2int_rz(__ldg(row + TA_ALPHA));
  bool c = false;
  if (valid[i] && txd >= 0) {
    const float u = b0 * __ldg(row + TA_UV0) + b1 * __ldg(row + TA_UV0 + 2) +
                    b2 * __ldg(row + TA_UV0 + 4);
    const float v = b0 * __ldg(row + TA_UV0 + 1) +
                    b1 * __ldg(row + TA_UV0 + 3) +
                    b2 * __ldg(row + TA_UV0 + 5);
    const rgb a = eval_descriptor(txf, txi, data, txd, u, v, false, 0.0f,
                                  0.0f, 0.0f, 0.0f, true);
    c = a.c[0] == 0.0f;
  }
  cut[i] = c ? 1 : 0;
}

}  // namespace

// K3: out (N, 3) = the descriptors txd_id (N,) at uv (N, 2); fallback's
// element strides fb_row, fb_col (0 where expanded); dudx ... dvdy (N,)
// each, read only with width_mode.
extern "C" int pt_texture_eval_launch(
    const float* txf, const int* txi, const float* data, const int* txd_id,
    const float* uv, const float* fallback, int fb_row, int fb_col,
    const float* dudx, const float* dvdx, const float* dudy,
    const float* dvdy, int n, int width_mode, int image, float* out,
    void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  texture_eval_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      txf, txi, data, txd_id, uv, fallback, fb_row, fb_col, dudx, dvdx, dudy,
      dvdy, n, width_mode, image, out);
  return (int)cudaGetLastError();
}

// K4: cut (N,) u8, p_hit, p_err, ng (N, 3) of the hits (tri (N,) i32, bary
// (N, 3), valid (N,) u8) against the (F, TA_WIDTH) tri_attr table.
extern "C" int pt_alpha_cut_launch(const float* txf, const int* txi,
                                   const float* data, const float* tri_attr,
                                   const int* tri, const float* bary,
                                   const uint8_t* valid, int n, float gamma7,
                                   uint8_t* cut, float* p_hit, float* p_err,
                                   float* ng, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  alpha_cut_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      txf, txi, data, tri_attr, tri, bary, valid, n, gamma7, cut, p_hit,
      p_err, ng);
  return (int)cudaGetLastError();
}
