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

import ctypes
import ctypes.util
import functools

import numpy as np
import torch


def fma(a, b, c):
    """a * b + c rounded once to float32. float64 holds the float32 product
    exactly, so one rounding back gives the fused result (double rounding
    can differ in ~2^-29 of cases)."""
    return _fma64(a.double(), b.double(), c)


def fma_scalar(a, w: float, c):
    """fma(a, w, c) for a Python number ``w``, rounded to float32 first:
    one float64 copy of ``a`` and one add that writes float32, with no
    constant tensor the size of ``a``."""
    out = torch.empty_like(c)
    return torch.add(c, a.double(), alpha=float(np.float32(w)), out=out)


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


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)


def log2(x):
    """log2 of positive normal float32 ``x`` rounded as the reference's CPU
    build computes it: XLA's Cephes polynomial for log (mantissa in
    [sqrt(1/2), sqrt(2)), three interleaved Horner chains of fused
    multiply-adds, the exponent's low part fused into the last product),
    then the product with float32(1 / ln 2). Bit-equal to ``jnp.log2`` on
    2M random inputs; torch.log differs in the last bit on ~1% of them."""
    m, e = torch.frexp(x)
    e = e.to(torch.float32)
    low = m < 0.707106781186547524
    e = torch.where(low, e - 1.0, e)
    t = torch.where(low, (m - 1.0) + m, m - 1.0)
    t2 = t * t
    t3 = t2 * t
    p = [torch.full_like(t, c) for c in _LOG_P]
    y = fma(fma(t, p[0], p[1]), t, p[2])
    y1 = fma(fma(t, p[3], p[4]), t, p[5])
    y2 = fma(fma(t, p[6], p[7]), t, p[8])
    y = fma(fma(y, t3, y1), t3, y2)
    y = fma(y, t3, e * -2.12194440e-4)
    ln = ((t - 0.5 * t2) + y) + e * 0.693359375
    return ln * float(np.float32(1.0 / np.log(2.0)))


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


def dot32(a, b, keepdims: bool = False):
    """Sum of products over the last axis in plain float32: the path
    tracer's dot. No integer of the tracer depends on the rounding of its
    dots, so it does without ``fma``; its tests hold the image to a stated
    tolerance instead."""
    return (a * b).sum(-1, keepdim=keepdims)


def normalize32(v, eps: float = 1e-12):
    length = torch.sqrt(torch.clamp(dot32(v, v, keepdims=True), min=0.0))
    return v * torch.reciprocal(torch.clamp(length, min=eps))


def cross32(a, b):
    """Cross product in plain float32 (the tracer's)."""
    a1, a2 = torch.roll(a, -1, -1), torch.roll(a, 1, -1)
    b1, b2 = torch.roll(b, -1, -1), torch.roll(b, 1, -1)
    return a1 * b2 - a2 * b1


def reflect(i, n):
    """GLSL reflect: i - 2 * dot(n, i) * n (plain float32)."""
    return i - 2.0 * dot32(n, i, keepdims=True) * n


def refract(i, n, eta):
    """GLSL refract for incident ``i``, normal ``n`` and the ratio of
    indices of refraction ``eta``; zero under total internal reflection."""
    cosi = -dot(n, i, keepdims=True)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    t = eta * i + (eta * cosi - torch.sqrt(torch.clamp(k, min=0.0))) * n
    return torch.where(k < 0.0, torch.zeros_like(i), t)


def lerp(a, b, t):
    return a + (b - a) * t


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def homogenize(v4):
    """(..., 4) clip-space -> (..., 3) by the perspective divide."""
    return v4[..., :3] / v4[..., 3:4]


def transform_point(m, p):
    """Apply a (..., 4, 4) matrix to (..., 3) points (w=1). Returns (..., 3)."""
    return dot(m[..., :3, :3], p[..., None, :]) + m[..., :3, 3]


def transform_point_h(m, p):
    """Apply a (4, 4) matrix to (..., 3) points, returning homogeneous
    (..., 4); each row is the fixed-order ((a+b)+(c+d)) sum that the
    reference's 4-term contraction lowers to."""
    x, y, z = p.unbind(-1)
    return torch.stack([(m[r, 0] * x + m[r, 1] * y) + (m[r, 2] * z + m[r, 3])
                        for r in range(4)], dim=-1)


def transform_vector(m, v):
    """Apply a (..., 4, 4) matrix to (..., 3) directions (w=0)."""
    return dot(m[..., :3, :3], v[..., None, :])


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
                reverse_z: bool = True, device=None):
    """Vulkan-style perspective, clip depth in [0, 1]; with reverse-Z (the
    engine default) z_near maps to depth 1 and z_far to 0, without it the
    other way round.

    Float32 like the JAX twin: the focal term is computed in float32 and the
    depth terms in Python floats, then stored. The tangent is the C
    library's ``tanf``, which is what the reference's ``jnp.tan`` gives on a
    CPU (``torch.tan`` differs in the last bit of ~4% of angles, tan(pi/6)
    among them)."""
    half = torch.tensor(fov_y_rad, dtype=torch.float32) * 0.5
    f = 1.0 / torch.tensor(libm().tanf(float(half)), dtype=torch.float32)
    m = torch.zeros(4, 4, dtype=torch.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    if reverse_z:
        m[2, 2] = z_near / (z_far - z_near)
        m[2, 3] = z_far * z_near / (z_far - z_near)
    else:
        m[2, 2] = z_far / (z_near - z_far)
        m[2, 3] = z_far * z_near / (z_near - z_far)
    m[3, 2] = -1.0
    return m.to(device) if device is not None else m


def ortho(left, right, bottom, top, z_near, z_far, reverse_z: bool = False):
    """Vulkan-style orthographic projection, depth in [0, 1]; the bounds
    are 0-d float32 tensors (or floats) on the matrix's device."""
    left, right, bottom, top, z_near, z_far = (
        torch.as_tensor(v, dtype=torch.float32) for v in (left, right, bottom, top, z_near, z_far))
    m = torch.zeros(4, 4, dtype=torch.float32, device=left.device)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    if reverse_z:
        m[2, 2] = 1.0 / (z_far - z_near)
        m[2, 3] = z_far / (z_far - z_near)
    else:
        m[2, 2] = -1.0 / (z_far - z_near)
        m[2, 3] = -z_near / (z_far - z_near)
    m[3, 3] = 1.0
    return m


def inverse(m):
    """The float32 inverse of a (4, 4) matrix as the reference's
    ``jnp.linalg.inv`` computes it on a CPU: LAPACK's LU factorisation with
    partial pivoting (``getrf``), then the triangular solves against the
    identity (``getrs``), which is what jaxlib's CPU kernels call; here
    through scipy's, so the two agree bit for bit (``torch.linalg.inv``
    differs in the last bit of some entries). Computed on the host: a
    matrix on the card is copied back (64 bytes, one synchronise) and the
    inverse returned to its device."""
    import scipy.linalg

    a = m.detach().to("cpu", torch.float32).numpy()
    inv = scipy.linalg.lu_solve(scipy.linalg.lu_factor(a), np.eye(4, dtype=np.float32))
    return torch.from_numpy(inv.astype(np.float32, copy=False)).to(m.device)


def srgb_to_linear(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


def luminance(rgb):
    from sailor_tpu_torch.config import RGB_TO_LUM

    return dot(rgb, torch.tensor(RGB_TO_LUM, dtype=rgb.dtype, device=rgb.device))


_RGB_TO_XYZ = ((0.4124564, 0.3575761, 0.1804375),
               (0.2126729, 0.7151522, 0.0721750),
               (0.0193339, 0.1191920, 0.9503041))
_XYZ_TO_RGB = ((3.2404542, -1.5371385, -0.4985314),
               (-0.9692660, 1.8760108, 0.0415560),
               (0.0556434, -0.2040259, 1.0572252))


def mat3_rows(m, v):
    """(..., 3) rows times the transpose of the 3x3 tuple ``m``: m @ v for
    each row v."""
    return v @ torch.tensor(m, dtype=torch.float32, device=v.device).T


def rgb_to_yxy(rgb):
    """Linear RGB -> CIE Yxy (D65; Formats.glsl convertRGB2Yxy)."""
    xyz = mat3_rows(_RGB_TO_XYZ, rgb)
    s = torch.clamp(xyz.sum(-1), min=1e-8)
    return torch.stack([xyz[..., 1], xyz[..., 0] / s, xyz[..., 1] / s], dim=-1)


def yxy_to_rgb(yxy):
    Y, x, y = yxy[..., 0], yxy[..., 1], torch.clamp(yxy[..., 2], min=1e-8)
    X = x * Y / y
    Z = (1.0 - x - yxy[..., 2]) * Y / y
    return mat3_rows(_XYZ_TO_RGB, torch.stack([X, Y, Z], dim=-1))


@functools.cache
def libm():
    """The C library's float32 ``cosf``, ``sinf`` and ``tanf`` (ctypes), which
    the reference's compiled code calls on a CPU: numpy's and PyTorch's own
    float32 sin, cos and tan differ from them in the last bit."""
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for f in (lib.cosf, lib.sinf, lib.tanf):
        f.restype, f.argtypes = ctypes.c_float, [ctypes.c_float]
    return lib


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w) and model matrices. The engine's host math: the
# inputs are float32 tensors (or anything ``torch.as_tensor`` takes) and
# the ops are plain float32, as the reference runs them op by op, except
# ``quat_to_mat3``/``trs``, which round as its compiled transform system.
# ---------------------------------------------------------------------------


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def quat_identity(shape=()):
    q = torch.zeros(tuple(shape) + (4,), dtype=torch.float32)
    q[..., 3] = 1.0
    return q


def quat_mul(a, b):
    a, b = _f32(a), _f32(b)
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_conj(q):
    return _f32(q) * torch.tensor([-1.0, -1.0, -1.0, 1.0])


def quat_rotate(q, v):
    """Rotate (..., 3) vectors by (..., 4) quaternions."""
    q, v = _f32(q), _f32(v)
    qv = q[..., :3]
    t = 2.0 * cross32(qv, v)
    return v + q[..., 3:4] * t + cross32(qv, t)


def quat_from_axis_angle(axis, angle):
    axis = normalize32(_f32(axis))
    half = _f32(angle) * 0.5
    return torch.cat([axis * torch.sin(half)[..., None], torch.cos(half)[..., None]], dim=-1)


def quat_to_mat3(q):
    """(..., 4) -> (..., 3, 3). Each off-diagonal pair and each diagonal
    sum of squares rounds as one fused multiply-add of its first product
    over its second, as the reference's compiled ``trs`` rounds them."""
    x, y, z, w = _f32(q).unbind(-1)
    m = torch.stack([
        1 - 2 * fma(y, y, z * z), 2 * fma(x, y, -(w * z)), 2 * fma(x, z, w * y),
        2 * fma(x, y, w * z), 1 - 2 * fma(x, x, z * z), 2 * fma(y, z, -(w * x)),
        2 * fma(x, z, -(w * y)), 2 * fma(y, z, w * x), 1 - 2 * fma(x, x, y * y),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_euler(yaw, pitch, roll):
    """ZYX euler (yaw about Y, pitch about X, roll about Z), radians."""
    qy = quat_from_axis_angle([0.0, 1.0, 0.0], yaw)
    qx = quat_from_axis_angle([1.0, 0.0, 0.0], pitch)
    qz = quat_from_axis_angle([0.0, 0.0, 1.0], roll)
    return quat_mul(qy, quat_mul(qx, qz))


def identity4(shape=()):
    return torch.eye(4).expand(tuple(shape) + (4, 4)).clone()


def translation(t):
    """(..., 3) -> (..., 4, 4)."""
    t = _f32(t)
    m = identity4(t.shape[:-1])
    m[..., :3, 3] = t
    return m


def scale(s):
    s = _f32(s)
    m = torch.zeros(s.shape[:-1] + (4, 4))
    for i in range(3):
        m[..., i, i] = s[..., i]
    m[..., 3, 3] = 1.0
    return m


def trs(t, r, s):
    """Compose translate / rotate (quaternion) / scale into (..., 4, 4)
    model matrices (glm::translate * mat4_cast(rot) * glm::scale)."""
    t = _f32(t)
    m = torch.zeros(t.shape[:-1] + (4, 4), device=t.device)
    m[..., :3, :3] = quat_to_mat3(r) * _f32(s)[..., None, :]
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m


def mat3_to_quat(m):
    """Rotation matrix (..., 3, 3) -> quaternion (x, y, z, w), branchless."""
    m = _f32(m)
    t = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    qw = torch.sqrt(torch.clamp(1.0 + t, min=1e-12)) * 0.5
    inv4w = 1.0 / torch.clamp(4.0 * qw, min=1e-9)
    q = torch.stack([(m[..., 2, 1] - m[..., 1, 2]) * inv4w,
                     (m[..., 0, 2] - m[..., 2, 0]) * inv4w,
                     (m[..., 1, 0] - m[..., 0, 1]) * inv4w, qw], dim=-1)
    return normalize32(q)


def quat_look_rotation(forward, up=(0.0, 1.0, 0.0)):
    """Quaternion turning -Z onto ``forward`` with the ``up`` hint: a
    transform with this rotation makes its inverse a look-at view."""
    f = normalize32(_f32(forward))
    s = normalize32(cross32(f, _f32(up)))
    u = cross32(s, f)
    return mat3_to_quat(torch.stack([s, u, -f], dim=-1))
