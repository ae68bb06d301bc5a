"""Vectorized PBRT-style math utilities on tensors.

Port of ``pathtracer_tpu/core/math.py``. Everything operates on tensors of
shape (..., 3) / (...,). Dot products and cross products are written out
component by component so the summation order is fixed on every device.
Float bit tricks use ``Tensor.view(torch.int32)``: PyTorch's uint32 has no
shift or subtraction on the CPU, and int32 wraps the same way here.
"""

from __future__ import annotations

import numpy as np
import torch

MACHINE_EPSILON = np.float32(np.finfo(np.float32).eps * 0.5)
ONE_MINUS_EPSILON = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))
INV_PI = np.float32(1.0 / np.pi)
INV_2_PI = np.float32(0.5 / np.pi)
PI = np.float32(np.pi)
HALF_MAX_I32 = np.int32(np.iinfo(np.int32).max // 2)
SHADOW_EPSILON = np.float32(1e-4)


_CONSTS: dict = {}


def device_const(values: tuple, device, dtype=torch.float32) -> torch.Tensor:
    """The small constant tensor ``values`` on ``device``, copied there
    once a process and shared by every caller (who must not write it): a
    host-to-device copy in the bounce loop waits for the device, and a
    CUDA graph's capture refuses one."""
    key = (values, torch.device(device), dtype)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def gamma(n: int) -> np.float32:
    """Floating-point error bound gamma(n) = n*eps/(1-n*eps)."""
    ne = np.float32(n) * MACHINE_EPSILON
    return np.float32(ne / (1.0 - ne))


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def norm_sq(v):
    return dot(v, v)


def sqrt(x):
    """Correctly rounded square root. PyTorch's CPU kernel misses the IEEE
    result by one ulp on about 0.5 % of f32 inputs (its CUDA kernel and
    XLA's do not), and chains such as the GGX sampling warp amplify that
    ulp; so on the CPU the root is taken in float64 and rounded once."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def norm(v):
    return sqrt(dot(v, v))


def normalize(v):
    return v / torch.clamp_min(norm(v), 1e-20)[..., None]


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def face_forward(n, v):
    """Flip n to lie in the same hemisphere as v."""
    return torch.where((dot(n, v) < 0.0)[..., None], -n, n)


def coordinate_system(v1):
    """Orthonormal basis (v2, v3) completing the unit vector v1."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    use_x = torch.abs(x) > torch.abs(y)
    inv_a = 1.0 / sqrt(torch.where(use_x, x * x + z * z, y * y + z * z))
    zero = torch.zeros_like(x)
    v2 = torch.where(use_x[..., None], torch.stack([-z, zero, x], dim=-1),
                     torch.stack([zero, z, -y], dim=-1)) * inv_a[..., None]
    return v2, cross(v1, v2)


def float_to_bits(f):
    return f.to(torch.float32).view(torch.int32)


def bits_to_float(u):
    return u.to(torch.int32).view(torch.float32)


def next_float_up(v):
    """Next representable float above v, elementwise."""
    v = v.to(torch.float32)
    v = torch.where(v == 0.0, 0.0, v)  # collapse -0 -> +0
    ui = float_to_bits(v)
    out = bits_to_float(torch.where(v >= 0.0, ui + 1, ui - 1))
    return torch.where(torch.isinf(v) & (v > 0), v, out)


def next_float_down(v):
    """Next representable float below v, elementwise (PBRT semantics)."""
    v = v.to(torch.float32)
    ui = float_to_bits(torch.where(v == 0.0, -0.0, v))
    # -0.0 has the sign bit set, so the v > 0 test routes it to ui + 1
    # (smallest negative subnormal), matching PBRT
    out = bits_to_float(torch.where(v > 0.0, ui - 1, ui + 1))
    return torch.where(torch.isinf(v) & (v < 0), v, out)


def offset_ray_origin(p, p_error, n, w):
    """Robustly offset a ray origin off a surface; all args (..., 3)."""
    d = dot(torch.abs(n), p_error)
    offset = d[..., None] * n
    offset = torch.where((dot(w, n) < 0.0)[..., None], -offset, offset)
    po = p + offset
    po = torch.where(offset > 0.0, next_float_up(po), po)
    return torch.where(offset < 0.0, next_float_down(po), po)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """Balance-power MIS heuristic, beta=2, as 1/(1+(g/f)^2)."""
    f = nf * f_pdf
    g = ng * g_pdf
    r = g / torch.clamp_min(f, 1e-30)
    w = 1.0 / (1.0 + r * r)
    return torch.where(f > 0.0, w, torch.zeros_like(w))


def spherical_theta(v):
    return torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + 2.0 * np.pi, p)


def gamma_correct(value):
    """Linear -> sRGB."""
    return torch.where(
        value <= 0.0031308, 12.92 * value,
        1.055 * torch.pow(torch.clamp_min(value, 1e-12), 1.0 / 2.4) - 0.055)


def inverse_gamma_correct(value):
    """sRGB -> linear."""
    return torch.where(value <= 0.04045, value / 12.92,
                       torch.pow((value + 0.055) / 1.055, 2.4))


def lerp(x, y, a):
    return x * (1.0 - a) + y * a


def cantor_pairing(x, y):
    """Cantor pairing of two non-negative ints, in int64 (wraps like the
    reference's u64 only beyond 2^63, far outside any pixel coordinate)."""
    x = torch.as_tensor(x, dtype=torch.int64)
    y = torch.as_tensor(y, dtype=torch.int64)
    s = x + y
    return (s * (s + 1)) // 2 + y


def round_up_pow2(v: int) -> int:
    """Host-side: smallest power of two >= v."""
    v = int(v)
    if v <= 1:
        return 1
    return 1 << (v - 1).bit_length()


def log2_int(i: int) -> int:
    return int(i).bit_length() - 1


def max_dimension(v):
    """Index of the largest component of (..., 3) tensors."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    two = torch.full_like(x, 2, dtype=torch.int64)
    return torch.where(x > y, torch.where(x > z, 0, two),
                       torch.where(y > z, 1, two))


def luminance(rgb):
    """CIE Y of linear RGB."""
    return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + \
        rgb[..., 2] * 0.072169
