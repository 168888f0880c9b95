"""Vector and matrix math on torch tensors (counterpart of
sailor_tpu/core/math3d.py).

A "vec3" is any (..., 3) tensor, a matrix is (..., 4, 4) with the
column-vector convention (``M @ v``). Right-handed world space, y-up; view
space looks down -Z; Vulkan-style clip depth in [0, 1] with reverse-Z.

The port's one rounding rule, stated here only: it rounds as the reference
does in its CPU build, where XLA contracts a product feeding an add into one
fused multiply-add, so a 3-term dot is fma(a2, b2, fma(a1, b1, a0 * b0)) and
a 2x2 determinant fma(a, b, -(c * d)). ``fma`` gives that rounding on any
device. The plain code calls it where the reference's result decides an
integer: triangle setup (degenerate test, edge and depth planes, hence the
raster's ids), light culling (the light lists), and the raster's plane
tests; the resolve emit uses it too, so its planes equal the reference's.
The CUDA kernels are built with -fmad=false and call ``__fmaf_rn`` at the
same places (csrc/common.cuh), so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch


def fma(a, b, c):
    """a * b + c rounded once to float32. float64 holds the float32 product
    exactly, so one rounding back gives the fused result (double rounding
    can differ in ~2^-29 of cases)."""
    return _fma64(a.double(), b.double(), c)


def _fma64(a64, b64, c):
    """fma for operands already in float64: c + a64 * b64 in float64 (the
    product is exact, so fused or not it rounds once), then to float32."""
    return torch.addcmul(c.double(), a64, b64).to(torch.float32)


def dot(a, b, keepdims: bool = False):
    """Sum of products over the last axis as a chain of fused multiply-adds.
    Each operand goes to float64 once, before any broadcast."""
    a64, b64 = a.double(), b.double()
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = _fma64(a64[..., i], b64[..., i], acc)
    return acc[..., None] if keepdims else acc


def length(v, keepdims: bool = False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdims=keepdims), min=0.0))


def normalize(v, eps: float = 1e-12):
    return v * torch.reciprocal(torch.clamp(length(v, keepdims=True), min=eps))


def cross(a, b):
    """Component i is fma(a[i+1], b[i+2], -(a[i+2] * b[i+1])), all three in
    one call: rolling by -1 gives the [i+1] operands, by 1 the [i+2]."""
    a1, a2 = torch.roll(a, -1, -1), torch.roll(a, 1, -1)
    b1, b2 = torch.roll(b, -1, -1), torch.roll(b, 1, -1)
    return fma(a1, b2, -(a2 * b1))


def transform_point(m, p):
    """Apply a (4, 4) matrix to (..., 3) points (w=1). Returns (..., 3)."""
    return dot(m[:3, :3], p[..., None, :]) + m[:3, 3]


def transform_point_h(m, p):
    """Apply a (4, 4) matrix to (..., 3) points, returning homogeneous
    (..., 4); each row is the fixed-order ((a+b)+(c+d)) sum that the
    reference's 4-term contraction lowers to."""
    x, y, z = p.unbind(-1)
    return torch.stack([(m[r, 0] * x + m[r, 1] * y) + (m[r, 2] * z + m[r, 3])
                        for r in range(4)], dim=-1)


def look_at(eye, center, up):
    """glm::lookAtRH equivalent: view matrix looking from eye to center."""
    f = normalize(center - eye)
    s = normalize(cross(f, up))
    u = cross(s, f)
    m = torch.zeros(4, 4, dtype=eye.dtype, device=eye.device)
    m[0, :3], m[0, 3] = s, -dot(s, eye)
    m[1, :3], m[1, 3] = u, -dot(u, eye)
    m[2, :3], m[2, 3] = -f, dot(f, eye)
    m[3, 3] = 1.0
    return m


def perspective(fov_y_rad: float, aspect: float, z_near: float, z_far: float,
                device=None):
    """Vulkan-style reverse-Z perspective: z_near maps to depth 1, z_far to 0.

    Float32 like the JAX twin: the focal term is computed in float32 and the
    depth terms in Python floats, then stored."""
    f = 1.0 / torch.tan(torch.tensor(fov_y_rad, dtype=torch.float32) * 0.5)
    m = torch.zeros(4, 4, dtype=torch.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = z_near / (z_far - z_near)
    m[2, 3] = z_far * z_near / (z_far - z_near)
    m[3, 2] = -1.0
    return m.to(device) if device is not None else m


def linear_to_srgb(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)
