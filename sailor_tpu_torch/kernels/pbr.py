"""Cook-Torrance PBR shading and the tiled Forward+ light loop in plain
torch (counterpart of sailor_tpu/kernels/pbr.py: Standard.shader fragment
main + CalculateLighting + AmbientLighting, Lighting.glsl BRDF terms).

``shade_forward_plus`` is the JAX package's own plain reference for the
shade kernel; the frame graph takes it when ``pallas_shading`` is off. The
kernel path is kernels/pbr_kernel.py.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from sailor_tpu_torch import config
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.kernels.lights import DIRECTIONAL, POINT

TILE = config.LIGHTS_CULLING_TILE_SIZE
_EPS = 1e-5
_F_DIELECTRIC = 0.04


@dataclasses.dataclass
class GBuffer:
    """Screen-space surface attributes produced by the resolve."""

    world_position: torch.Tensor  # (H, W, 3)
    normal: torch.Tensor          # (H, W, 3) normalized
    albedo: torch.Tensor          # (H, W, 4) linear rgba
    metallic: torch.Tensor        # (H, W)
    roughness: torch.Tensor       # (H, W)
    ao: torch.Tensor              # (H, W)
    emissive: torch.Tensor        # (H, W, 3)
    coverage: torch.Tensor        # (H, W) 1 where geometry was rasterized

    def map(self, fn) -> "GBuffer":
        return GBuffer(**{f.name: fn(getattr(self, f.name))
                          for f in dataclasses.fields(self)})


def _pow5(x):
    """x**5 by the reference's integer_pow order: x * ((x*x) * (x*x))."""
    x2 = x * x
    return x * (x2 * x2)


def ndf_ggx(cos_lh, roughness):
    """GGX/Trowbridge-Reitz NDF with Disney alpha = roughness^2."""
    alpha = roughness * roughness
    alpha_sq = alpha * alpha
    denom = (cos_lh * cos_lh) * (alpha_sq - 1.0) + 1.0
    return alpha_sq / (math.pi * denom * denom)


def geometry_smith(cos_li, cos_lo, roughness):
    """Schlick-GGX Smith geometry with the analytic-light k remap
    ((r + 1)^2 / 8)."""
    r = roughness + 1.0
    k = (r * r) / 8.0
    return (cos_li / (cos_li * (1.0 - k) + k)) * (cos_lo / (cos_lo * (1.0 - k) + k))


def geometry_smith_ibl(cos_li, cos_lo, roughness):
    """Schlick-GGX Smith geometry with the IBL k remap (r^2 / 2)."""
    k = (roughness * roughness) / 2.0
    return (cos_li / (cos_li * (1.0 - k) + k)) * (cos_lo / (cos_lo * (1.0 - k) + k))


def fresnel_schlick(f0, cos_theta):
    return f0 + (1.0 - f0) * _pow5(torch.clamp(1.0 - cos_theta, 0.0, 1.0))


def fresnel_schlick_roughness(f0, cos_theta, roughness):
    return f0 + (torch.maximum(1.0 - roughness, f0) - f0) * _pow5(
        torch.clamp(1.0 - cos_theta, 0.0, 1.0))


def ambient_constant(albedo, metallic, roughness, ao, normal, cos_lo, ambient_color):
    """Flat ambient fallback when no IBL is bound."""
    met = metallic[..., None]
    f0 = torch.where(met > 0.0, _F_DIELECTRIC + (albedo[..., :3] - _F_DIELECTRIC) * met,
                     torch.full_like(albedo[..., :3], _F_DIELECTRIC))
    f = fresnel_schlick_roughness(f0, cos_lo, roughness[..., None])
    kd = (1.0 - f) * (1.0 - met)
    amb = torch.tensor(ambient_color, dtype=torch.float32, device=albedo.device)
    return ao[..., None] * (kd * albedo[..., :3] + f * 0.2) * amb


def direct_lighting(l_type, l_pos, l_dir, l_intensity, l_atten, l_cutoff, l_radius,
                    albedo, metallic, roughness, f0, normal, world_pos, to_camera, cos_lo,
                    shadow):
    """Radiance from one light (broadcast shapes), CalculateLighting
    parity: ``to_camera`` is the normalised camera - point, ``shadow`` in
    [0, 1]; a directional light's incident direction is -l_dir, a point or
    spot light's the direction to it."""
    to_light = l_pos - world_pos
    dist = torch.sqrt(torch.clamp((to_light * to_light).sum(-1, keepdim=True), min=1e-12))
    point_dir = to_light / dist
    is_dir = (l_type == DIRECTIONAL)[..., None]
    is_point = (l_type == POINT)[..., None]
    li = torch.where(is_dir, -l_dir, point_dir)
    att = 1.0 / (l_atten[..., 0:1] + l_atten[..., 1:2] * dist
                 + l_atten[..., 2:3] * dist * dist)
    range_fall = 1.0 - torch.clamp(
        dist / torch.clamp(l_radius[..., None], min=1e-6), 0.0, 1.0) ** 2
    cos_theta = (point_dir * -l_dir).sum(-1, keepdim=True)
    denom = torch.clamp(l_cutoff[..., 0:1] - l_cutoff[..., 1:2], min=1e-6)
    cone = torch.clamp((cos_theta - l_cutoff[..., 1:2]) / denom, 0.0, 1.0)
    one = torch.ones_like(att)
    falloff = torch.where(is_dir, one, torch.where(is_point, att * range_fall, att * cone))
    lh = m3.normalize(li + to_camera)
    cos_li = torch.clamp((normal * li).sum(-1, keepdim=True), min=0.0)
    cos_lh = torch.clamp((normal * lh).sum(-1, keepdim=True), min=0.0)
    f = fresnel_schlick(f0, torch.clamp((lh * to_camera).sum(-1, keepdim=True), min=0.0))
    r = roughness[..., None]
    alpha = r * r
    alpha_sq = alpha * alpha
    d_den = (cos_lh * cos_lh) * (alpha_sq - 1.0) + 1.0
    d = alpha_sq / (math.pi * d_den * d_den)
    k = ((r + 1.0) * (r + 1.0)) / 8.0
    g = (cos_li / (cos_li * (1.0 - k) + k)) * (cos_lo / (cos_lo * (1.0 - k) + k))
    kd = (1.0 - f) * (1.0 - metallic[..., None])
    specular = (f * d * g) / torch.clamp(4.0 * cos_li * cos_lo, min=_EPS)
    return shadow * (kd * albedo[..., :3] + specular) * l_intensity * cos_li * falloff


def _to_tiles(img, ty, tx):
    c = img.shape[2:]
    return img.reshape(ty, TILE, tx, TILE, *c).permute(0, 2, 1, 3, *range(4, 4 + len(c)))


def _from_tiles(tiles):
    ty, tx = tiles.shape[0], tiles.shape[1]
    c = tiles.shape[4:]
    return tiles.permute(0, 2, 1, 3, *range(4, 4 + len(c))).reshape(
        ty * TILE, tx * TILE, *c)


def shade_forward_plus(gbuffer: GBuffer, lights, tile_light_indices,
                       camera_position, shadow_factors=None, ibl_ambient=None,
                       ambient=(0.03, 0.03, 0.03)):
    """Shade a frame: per-tile top-K light loop + ambient + emissive.
    Returns (H, W, 3) linear HDR radiance."""
    H, W = gbuffer.normal.shape[:2]
    ty, tx = H // TILE, W // TILE
    K = tile_light_indices.shape[-1]
    to_cam = m3.normalize(camera_position - gbuffer.world_position)
    cos_lo = torch.clamp(m3.dot(gbuffer.normal, to_cam, keepdims=True), min=0.0)
    f0 = _F_DIELECTRIC + (gbuffer.albedo[..., :3] - _F_DIELECTRIC) * gbuffer.metallic[..., None]

    def tiles(x):  # (Ty, Tx, 1, 16, 16, C): a broadcast slot axis
        return _to_tiles(x, ty, tx)[:, :, None]

    pa = dict(albedo=tiles(gbuffer.albedo), metallic=tiles(gbuffer.metallic[..., None])[..., 0],
              roughness=tiles(gbuffer.roughness[..., None])[..., 0], f0=tiles(f0),
              normal=tiles(gbuffer.normal), world_pos=tiles(gbuffer.world_position),
              to_camera=tiles(to_cam), cos_lo=tiles(cos_lo))
    t_shadow = (tiles(shadow_factors[..., None])[..., 0] if shadow_factors is not None
                else None)
    idx = tile_light_indices.long()
    safe = torch.clamp(idx, min=0)
    valid_all = idx >= 0
    CL = min(16, K)
    acc = torch.zeros(ty, tx, TILE, TILE, 3, dtype=torch.float32, device=idx.device)
    for c0 in range(0, K, CL):
        sl = safe[..., c0:c0 + CL]                       # (Ty, Tx, CL)

        def g(field):
            return field[sl][:, :, :, None, None]

        l_type = lights.type[sl][:, :, :, None, None]
        shadow = 1.0
        if t_shadow is not None:
            shadow = torch.where((l_type == DIRECTIONAL)[..., None], t_shadow[..., None],
                                 torch.ones_like(t_shadow[..., None]))
        contrib = direct_lighting(
            l_type, g(lights.position), g(lights.direction), g(lights.intensity),
            g(lights.attenuation), g(lights.cutoff), lights.radius[sl][:, :, :, None, None],
            shadow=shadow, **pa)
        valid = valid_all[..., c0:c0 + CL][:, :, :, None, None, None]
        acc = acc + torch.where(valid, contrib, torch.zeros_like(contrib)).sum(dim=2)
    color = _from_tiles(acc)
    if ibl_ambient is not None:
        amb = ibl_ambient
    else:
        amb = ambient_constant(gbuffer.albedo, gbuffer.metallic, gbuffer.roughness,
                               gbuffer.ao, gbuffer.normal, cos_lo, ambient)
    color = color + amb + gbuffer.emissive
    return color * gbuffer.coverage[..., None]
