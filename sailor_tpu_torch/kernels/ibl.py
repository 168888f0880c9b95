"""IBL precompute and the ambient term (counterpart of
sailor_tpu/kernels/ibl.py; ComputeIrradianceMap.shader,
ComputeEnvMap_IBL.shader, ComputeBrdfLut.shader and the AmbientLighting
path of Standard.shader).

Each bake is a Monte-Carlo estimate over all output texels at once, its
samples summed one after another in the reference's order (a scan), so
the sums round as the reference's do. Plain PyTorch on the input's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sailor_tpu_torch.config import resolve_device
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.kernels import cubemap as cm
from sailor_tpu_torch.kernels import sampling
from sailor_tpu_torch.kernels.pbr import fresnel_schlick_roughness, geometry_smith_ibl


def _hammersley(n: int) -> np.ndarray:
    """Low-discrepancy 2-D sequence (n, 2) float32: i / n and the
    bit-reversed radical inverse of i."""
    i = np.arange(n)
    bits = i.astype(np.uint32)
    bits = (bits << np.uint32(16)) | (bits >> np.uint32(16))
    bits = ((bits & np.uint32(0x55555555)) << np.uint32(1)) | (
        (bits & np.uint32(0xAAAAAAAA)) >> np.uint32(1))
    bits = ((bits & np.uint32(0x33333333)) << np.uint32(2)) | (
        (bits & np.uint32(0xCCCCCCCC)) >> np.uint32(2))
    bits = ((bits & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | (
        (bits & np.uint32(0xF0F0F0F0)) >> np.uint32(4))
    bits = ((bits & np.uint32(0x00FF00FF)) << np.uint32(8)) | (
        (bits & np.uint32(0xFF00FF00)) >> np.uint32(8))
    return np.stack([i / n, bits.astype(np.float64) * 2.3283064365386963e-10],
                    -1).astype(np.float32)


def _sincos(x: np.ndarray):
    """float32 cos and sin of host scalars through the C library's cosf and
    sinf, which the reference's compiled bakes call (numpy's and PyTorch's
    own float32 sin and cos differ from them in the last bit)."""
    libm = m3.libm()
    return (np.array([libm.cosf(float(v)) for v in x], np.float32),
            np.array([libm.sinf(float(v)) for v in x], np.float32))


def _scalars(values, device):
    """Columns of a host float32 array as lists of 0-d tensors."""
    t = torch.from_numpy(np.ascontiguousarray(values, np.float32)).to(device)
    return [list(col.unbind()) for col in t.T]


def _to_world(n, l0, l1, l2):
    """``lighting_model.to_world`` rounded as the reference's compiled
    bakes round it: the basis's 1 + s n.x^2 a and s + n.y^2 a fused, and
    the sum as fma(n, l2, fma(t, l0, b * l1))."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([m3.fma(s * n[..., 0] ** 2, a, torch.ones_like(a)), s * b,
                     -s * n[..., 0]], -1)
    bt = torch.stack([b, m3.fma(n[..., 1] ** 2, a, s), -n[..., 1]], -1)
    return m3.fma(n, l2.expand(n.shape), m3.fma(t, l0.expand(n.shape), bt * l1))


def _ggx_half(n, alpha, u1, u2, cos_phi, sin_phi):
    """``lighting_model.sample_ggx_half`` for alpha = max(roughness^2,
    1e-4), rounded as the reference's bakes (fused denominator and
    1 - cos^2; cos and sin of the sample's angle from the host)."""
    cos_t = torch.sqrt((1.0 - u2) / m3.fma(alpha * alpha - 1.0, u2.expand(alpha.shape),
                                            torch.ones_like(alpha)))
    sin_t = torch.sqrt(torch.clamp(m3.fma(-cos_t, cos_t, torch.ones_like(cos_t)), min=0.0))
    return _to_world(n, (sin_t * cos_phi)[..., None], (sin_t * sin_phi)[..., None],
                     cos_t[..., None])


def _reflect(i, n):
    """GLSL reflect i - 2 (n . i) n with the product fused into the sum."""
    return m3.fma(-2.0 * m3.dot(n, i, keepdims=True), n, i)


def _ggx_samples(samples: int, device):
    """(u1, u2, cos(2 pi u1), sin(2 pi u1)) of each Hammersley point."""
    ham = _hammersley(samples)
    c, s = _sincos((np.float32(2.0 * math.pi) * ham[:, 0]).astype(np.float32))
    return list(zip(*_scalars(np.stack([ham[:, 0], ham[:, 1], c, s], -1), device)))


def irradiance_map(env_cube, resolution: int = 32, samples: int = 256):
    """Cosine-convolved irradiance cubemap: the mean of the environment
    over cosine-distributed directions about each texel's direction."""
    dev = env_cube.device
    d = cm.face_directions(resolution, dev)
    ham = _hammersley(samples)
    u1, u2 = ham[:, 0], ham[:, 1]
    c, s = _sincos((np.float32(2.0 * math.pi) * u2).astype(np.float32))
    r = np.sqrt(u1)
    local = np.stack([r * c, r * s, np.sqrt(np.maximum(np.float32(1.0) - u1, np.float32(0.0)))], -1)
    acc = torch.zeros(d.shape[:-1] + (3,), device=dev)
    for l0, l1, l2 in zip(*_scalars(local, dev)):
        acc = acc + cm.sample_cubemap(env_cube, _to_world(d, l0, l1, l2))
    return acc / samples


def prefilter_env_mip(env_cube, roughness: float, resolution: int, samples: int = 64):
    """One GGX-prefiltered specular mip: the environment over GGX half
    vectors about each texel's direction, weighted by n . l."""
    dev = env_cube.device
    d = cm.face_directions(resolution, dev)
    rough = torch.full(d.shape[:-1], max(roughness, 0.02), device=dev)
    alpha = torch.clamp(rough * rough, min=1e-4)
    acc = torch.zeros(d.shape[:-1] + (3,), device=dev)
    wsum = torch.zeros(d.shape[:-1], device=dev)
    for u1, u2, cos_phi, sin_phi in _ggx_samples(samples, dev):
        h = _ggx_half(d, alpha, u1, u2, cos_phi, sin_phi)
        wi = _reflect(-d, h)
        w = torch.clamp(m3.dot(d, wi), min=0.0)
        s = cm.sample_cubemap(env_cube, wi)
        acc = m3.fma(s, w[..., None].expand(s.shape), acc)
        wsum = wsum + w
    return acc / torch.clamp(wsum, min=1e-4)[..., None]


def prefiltered_env_mips(env_cube, num_mips: int = 6, samples: int = 64):
    """The specular mip chain: mip m has roughness m / (num_mips - 1) and
    half the previous resolution (down to 4)."""
    mips = []
    cube = env_cube
    for m in range(num_mips):
        res = cube.shape[1]
        mips.append(prefilter_env_mip(cube, m / max(num_mips - 1, 1), res, samples))
        if m + 1 < num_mips and res > 4:
            cube = cm.downsample_cubemap(cube)
    return mips


def brdf_lut(resolution: int = 256, samples: int = 256, device=None):
    """Split-sum BRDF LUT over (cos_v, roughness): (R, R, 2), x = cos_v,
    y = roughness. On the card unless the caller names another device."""
    device = resolve_device(device)
    a = (torch.arange(resolution, dtype=torch.float32, device=device) + 0.5) / resolution
    rough, cos_v = torch.meshgrid(a, a, indexing="ij")
    v = torch.stack([torch.sqrt(1.0 - cos_v ** 2), torch.zeros_like(cos_v), cos_v], dim=-1)
    n = torch.tensor([0.0, 0.0, 1.0], device=device).expand(v.shape)
    alpha = torch.clamp(rough * rough, min=1e-4)
    acc_a = torch.zeros(cos_v.shape, device=device)
    acc_b = torch.zeros(cos_v.shape, device=device)
    for u1, u2, cos_phi, sin_phi in _ggx_samples(samples, device):
        h = _ggx_half(n, alpha, u1, u2, cos_phi, sin_phi)
        wi = _reflect(-v, h)
        cos_l = wi[..., 2]
        ok = cos_l > 0
        cos_h = torch.clamp(h[..., 2], min=0.0)
        voh = torch.clamp(m3.dot(v, h), min=1e-4)
        g = geometry_smith_ibl(torch.clamp(cos_l, min=1e-4)[..., None], cos_v[..., None],
                               rough[..., None])[..., 0]
        g_vis = g * voh / torch.clamp(cos_h * cos_v, min=1e-4)
        fc = (1.0 - voh) ** 5
        zero = torch.zeros_like(g_vis)
        acc_a = acc_a + torch.where(ok, (1.0 - fc) * g_vis, zero)
        acc_b = acc_b + torch.where(ok, fc * g_vis, zero)
    return torch.stack([acc_a / samples, acc_b / samples], dim=-1)


def env_brdf_approx(f0, roughness, cos_v):
    """Analytic split-sum environment BRDF (Karis/Lazarov), in place of the
    LUT's gathers."""
    c0 = torch.tensor([-1.0, -0.0275, -0.572, 0.022], device=roughness.device)
    c1 = torch.tensor([1.0, 0.0425, 1.04, -0.04], device=roughness.device)
    r4 = roughness[..., None] * c0 + c1
    a004 = (torch.minimum(r4[..., 0] * r4[..., 0], torch.exp2(-9.28 * cos_v))
            * r4[..., 0] + r4[..., 1])
    a = -1.04 * a004 + r4[..., 2]
    b = 1.04 * a004 + r4[..., 3]
    return f0 * a[..., None] + b[..., None]


def _diffuse_f0(albedo, metallic, roughness, normal, view_dir, irr):
    cos_lo = torch.clamp(m3.dot32(normal, -view_dir, keepdims=True), min=0.0)
    f0 = 0.04 + (albedo[..., :3] - 0.04) * metallic[..., None]
    f = fresnel_schlick_roughness(f0, cos_lo, roughness[..., None])
    kd = (1.0 - f) * (1.0 - metallic[..., None])
    return kd * albedo[..., :3] * irr, f0, cos_lo


def ambient_ibl_packed(albedo, metallic, roughness, ao, normal, view_dir,
                       irradiance_cube, spec_stack, irradiance_sh=None):
    """AmbientLighting from the packed-mip stack (two levels x four
    corners), the analytic environment BRDF and the irradiance as SH9
    (or sampled from the irradiance cube). ``view_dir`` points from the
    camera to the surface."""
    if irradiance_sh is not None:
        irr = sh9_irradiance(irradiance_sh, normal)
    else:
        irr = cm.sample_cubemap(irradiance_cube, normal)
    diffuse, f0, cos_lo = _diffuse_f0(albedo, metallic, roughness, normal, view_dir, irr)
    lr = m3.reflect(view_dir, normal)
    spec_irr = cm.sample_cubemap_lod_stack(spec_stack, lr, roughness * (spec_stack.shape[0] - 1))
    spec = env_brdf_approx(f0, roughness, cos_lo[..., 0]) * spec_irr
    return ao[..., None] * (diffuse + spec)


def ambient_ibl(albedo, metallic, roughness, ao, normal, view_dir,
                irradiance_cube, env_mips, lut):
    """AmbientLighting: irradiance cube diffuse plus the split-sum
    specular from the list of mips and the BRDF LUT."""
    irr = cm.sample_cubemap(irradiance_cube, normal)
    diffuse, f0, cos_lo = _diffuse_f0(albedo, metallic, roughness, normal, view_dir, irr)
    lr = m3.reflect(view_dir, normal)
    spec_irr = cm.sample_cubemap_lod(env_mips, lr, roughness * (len(env_mips) - 1))
    ab = sampling.sample_bilinear(lut, torch.stack([cos_lo[..., 0], roughness], dim=-1))
    spec = (f0 * ab[..., 0:1] + ab[..., 1:2]) * spec_irr
    return ao[..., None] * (diffuse + spec)


def sh9_project(env_cube):
    """Project an environment cube onto 9 RGB spherical harmonics
    (Ramamoorthi and Hanrahan 2001): (9, 3) radiance coefficients."""
    res = env_cube.shape[1]
    dev = env_cube.device
    d = cm.face_directions(res, dev)
    a = (torch.arange(res, dtype=torch.float32, device=dev) + 0.5) / res * 2.0 - 1.0
    v, u = torch.meshgrid(a, a, indexing="ij")
    dw = (4.0 / (res * res) / (u * u + v * v + 1.0) ** 1.5).expand(6, res, res)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    basis = torch.stack([
        torch.full_like(x, 0.282095),
        0.488603 * y, 0.488603 * z, 0.488603 * x,
        1.092548 * x * y, 1.092548 * y * z,
        0.315392 * (3.0 * z * z - 1.0),
        1.092548 * x * z,
        0.546274 * (x * x - y * y),
    ])
    return torch.einsum("kfij,fijc->kc", basis * dw[None], env_cube)


def sh9_irradiance(sh, normal):
    """Irradiance E(n) / pi from SH9 radiance coefficients ``sh`` (9, 3)
    for normals (..., 3)."""
    x, y, z = normal[..., 0:1], normal[..., 1:2], normal[..., 2:3]
    c1, c2, c3, c4, c5 = 0.429043, 0.511664, 0.743125, 0.886227, 0.247708
    e = (c4 * sh[0]
         + 2.0 * c2 * (sh[3] * x + sh[1] * y + sh[2] * z)
         + c1 * sh[8] * (x * x - y * y)
         + c3 * sh[6] * z * z - c5 * sh[6]
         + 2.0 * c1 * (sh[4] * x * y + sh[5] * y * z + sh[7] * x * z))
    return torch.clamp(e, min=0.0) / math.pi
