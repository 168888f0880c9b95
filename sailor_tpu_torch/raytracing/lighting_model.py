"""Sampling and BSDF evaluation for the path tracer (counterpart of
sailor_tpu/raytracing/lighting_model.py, LightingModel.{h,cpp} of the
reference renderer): GGX and Beckmann NDFs, Schlick Fresnel, Smith
geometry, cosine and NDF importance sampling, the MIS power heuristic and
the glTF metal-rough BRDF. Everything broadcasts over ray batches; lobes are
picked by masks, not branches. Plain float32 (``math3d.dot32``).
"""

from __future__ import annotations

import math

import torch

from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.kernels.pbr import fresnel_schlick, geometry_smith_ibl, ndf_ggx

# Below this roughness the reference samples the specular lobe from
# Beckmann instead of GGX (LightingModel.cpp:314 bSpecularBeckman).
BECKMANN_ROUGHNESS = 0.2


def _pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def power_heuristic(pdf_a, pdf_b, beta: float = 2.0):
    """MIS power heuristic w_a = pdf_a^b / (pdf_a^b + pdf_b^b)."""
    a = pdf_a ** beta
    return a / torch.clamp(a + pdf_b ** beta, min=1e-12)


def tangent_basis(n):
    """Branchless orthonormal basis around normals (Duff et al. 2017)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], -1)
    bt = torch.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return t, bt


def to_world(n, local):
    t, b = tangent_basis(n)
    return t * local[..., 0:1] + b * local[..., 1:2] + n * local[..., 2:3]


def sample_cosine_hemisphere(n, u1, u2):
    """Cosine-weighted direction about n; returns (dir, pdf)."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                         torch.sqrt(torch.clamp(1.0 - u1, min=0.0))], -1)
    return to_world(n, local), torch.clamp(local[..., 2], min=1e-6) / math.pi


def sample_ggx_half(n, roughness, u1, u2):
    """GGX NDF-importance-sampled half vector about n (alpha = roughness^2)."""
    alpha = torch.clamp(roughness * roughness, min=1e-4)
    cos_t = torch.sqrt((1.0 - u2) / (1.0 + (alpha * alpha - 1.0) * u2))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u1
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], -1)
    return to_world(n, local)


def ggx_pdf(n, h, wo, roughness):
    """pdf of the reflected direction under GGX half-vector sampling."""
    cos_nh = torch.clamp(m3.dot32(n, h), min=0.0)
    d = ndf_ggx(cos_nh, roughness)
    denom = 4.0 * torch.clamp(m3.dot32(wo, h).abs(), min=1e-6)
    return torch.clamp(d * cos_nh / denom, min=1e-8)


def ndf_beckmann(cos_h, roughness):
    """Beckmann NDF: D = exp((c2-1)/(a2 c2)) / (pi a2 c2^2)."""
    a2 = torch.clamp(roughness * roughness, min=1e-4) ** 2
    c2 = torch.clamp(cos_h * cos_h, min=1e-6)
    return torch.exp((c2 - 1.0) / (a2 * c2)) / (math.pi * a2 * c2 * c2)


def sample_beckmann_half(n, roughness, u1, u2):
    """Beckmann NDF-importance-sampled half vector: tan^2 = -a^2 ln(1 - u)."""
    a2 = torch.clamp(roughness * roughness, min=1e-4) ** 2
    tan2 = -a2 * torch.log(torch.clamp(1.0 - u2, min=1e-9))
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u1
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], -1)
    return to_world(n, local)


def beckmann_pdf(n, h, wo, roughness):
    """pdf of the reflected direction under Beckmann half-vector sampling."""
    cos_nh = torch.clamp(m3.dot32(n, h), min=0.0)
    d = ndf_beckmann(cos_nh, roughness)
    denom = 4.0 * torch.clamp(m3.dot32(wo, h).abs(), min=1e-6)
    return torch.clamp(d * cos_nh / denom, min=1e-8)


def refract(d, n, eta):
    """Snell refraction of ``d`` (pointing into the surface) through ``n``
    (facing against d), eta = n_from / n_to. Returns (direction, total
    internal reflection mask)."""
    eta = torch.as_tensor(eta, dtype=d.dtype, device=d.device)
    if eta.ndim == d.ndim - 1:
        eta = eta[..., None]
    cos_i = torch.clamp(-m3.dot32(n, d, keepdims=True), min=0.0)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t[..., 0] > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    return m3.normalize32(eta * d + (eta * cos_i - cos_t) * n), tir


def fresnel_dielectric(cos_i, ior_ratio):
    """Schlick Fresnel for a dielectric boundary, ior_ratio = n_to / n_from."""
    f0 = ((ior_ratio - 1.0) / (ior_ratio + 1.0)) ** 2
    return f0 + (1.0 - f0) * _pow5(torch.clamp(1.0 - cos_i, 0.0, 1.0))


def hg_phase(cos_t, g):
    """Henyey-Greenstein phase function."""
    g2 = g * g
    denom = torch.clamp(1.0 + g2 - 2.0 * g * cos_t, min=1e-6)
    return (1.0 - g2) / (4.0 * math.pi * denom * torch.sqrt(denom))


def sample_hg(d, g, u1, u2):
    """A scattering direction about ``d`` from the HG phase; |g| < 1e-3
    samples the uniform sphere."""
    small = g.abs() < 1e-3
    g_safe = torch.where(small, 1e-3, g)
    sq = (1.0 - g_safe * g_safe) / (1.0 + g_safe * (2.0 * u1 - 1.0))
    cos_hg = (1.0 + g_safe * g_safe - sq * sq) / (2.0 * g_safe)
    cos_t = torch.clamp(torch.where(small, 1.0 - 2.0 * u1, cos_hg), -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], -1)
    return to_world(m3.normalize32(d), local)


def sample_spec_half(n, roughness, u1, u2):
    """Specular half vector with the reference's NDF switch: Beckmann below
    roughness 0.2, GGX above (a masked select)."""
    h_g = sample_ggx_half(n, roughness, u1, u2)
    h_b = sample_beckmann_half(n, roughness, u1, u2)
    return torch.where((roughness < BECKMANN_ROUGHNESS)[..., None], h_b, h_g)


def eval_brdf(n, wo, wi, albedo, metallic, roughness):
    """glTF metal-rough BRDF (diffuse + GGX specular). Returns (f, pdf_cos,
    pdf_spec), pdf_spec following the reference's NDF switch."""
    h = m3.normalize32(wo + wi)
    cos_i = torch.clamp(m3.dot32(n, wi, keepdims=True), min=0.0)
    cos_o = torch.clamp(m3.dot32(n, wo, keepdims=True), min=0.0)
    cos_h = torch.clamp(m3.dot32(n, h, keepdims=True), min=0.0)
    f0 = 0.04 + (albedo - 0.04) * metallic[..., None]
    f = fresnel_schlick(f0, torch.clamp(m3.dot32(h, wo, keepdims=True), min=0.0))
    d = ndf_ggx(cos_h, roughness[..., None])
    g = geometry_smith_ibl(cos_i, cos_o, roughness[..., None])
    spec = f * d * g / torch.clamp(4.0 * cos_i * cos_o, min=1e-6)
    diff = (1.0 - f) * (1.0 - metallic[..., None]) * albedo / math.pi
    pdf_cos = torch.clamp(cos_i[..., 0], min=1e-6) / math.pi
    pdf_spec = torch.where(roughness < BECKMANN_ROUGHNESS,
                           beckmann_pdf(n, h, wo, roughness),
                           ggx_pdf(n, h, wo, roughness))
    return diff + spec, pdf_cos, pdf_spec
