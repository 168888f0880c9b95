"""Cascaded shadow maps with EVSM (counterpart of sailor_tpu/kernels/shadow.py;
ShadowPrepassNode and the shadow half of Lighting.glsl).

Per directional light:
1. ``cascade_matrices`` fits NUM_CSM_CASCADES orthographic light
   projections to slices of the camera frustum;
2. the caller rasters depth-only maps with them (ShadowPrepass, through the
   frame's raster backend);
3. ``evsm_warp`` turns each map into four EVSM moments, which the caller
   blurs (kernels/blur);
4. ``csm_shadow_factor_evsm`` / ``csm_shadow_factor`` select a cascade per
   pixel and look the factor up (EVSM Chebyshev, or Poisson PCF).

Plain PyTorch on the inputs' device. Depths are reverse-Z: 1 nearest the
light, 0 where nothing was drawn.
"""

from __future__ import annotations

import numpy as np
import torch

from sailor_tpu_torch import config
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.kernels import sampling

# Poisson disk of the reference's ManualPCF (a standard published set)
_POISSON = np.asarray(
    [
        [-0.94201624, -0.39906216], [0.94558609, -0.76890725],
        [-0.094184101, -0.92938870], [0.34495938, 0.29387760],
        [-0.91588581, 0.45771432], [-0.81544232, -0.87912464],
        [-0.38277543, 0.27676845], [0.97484398, 0.75648379],
        [0.44323325, -0.97511554], [0.53742981, -0.47373420],
        [-0.26496911, -0.41893023], [0.79197514, 0.19090188],
        [-0.24188840, 0.99706507], [-0.81409955, 0.91437590],
        [0.19984126, 0.78641367], [0.14383161, -0.14100790],
    ],
    np.float32,
)


def _f32(x: float) -> float:
    """A Python float rounded to float32, as the reference's weakly typed
    constants are before they meet a float32 array."""
    return float(np.float32(x))


def cascade_splits(z_near: float, z_far: float):
    """Cascade far-plane distances (fractions of z_far)."""
    return [z_far * f for f in config.SHADOW_CASCADE_LEVELS]


def _vec3(v, device):
    """A (3,) float32 tensor on ``device`` from a tensor or a host array."""
    if torch.is_tensor(v):
        return v.to(device, torch.float32)
    return torch.from_numpy(np.array(v, np.float32)).to(device)


def frustum_slice_corners(inv_view_proj, z0_ndc, z1_ndc):
    """The 8 world-space corners of the camera-frustum slice between two
    NDC depths (reverse-Z: the near one is larger), x fastest, then y,
    then z; each transformed as ``math3d.transform_point_h`` rounds."""
    dev = inv_view_proj.device
    z = torch.stack([_vec3(z0_ndc, dev).reshape(()), _vec3(z1_ndc, dev).reshape(())])
    xy = torch.tensor([[-1.0, -1.0], [1.0, -1.0], [-1.0, 1.0], [1.0, 1.0]], device=dev)
    c = m3.transform_point_h(inv_view_proj,
                             torch.cat([xy.repeat(2, 1), z.repeat_interleave(4)[:, None]], 1))
    return c[:, :3] / c[:, 3:4]


def _mean_rows(x):
    """Mean over the first axis, summed row after row (the reference's
    reduction order)."""
    acc = x[0]
    for k in range(1, x.shape[0]):
        acc = acc + x[k]
    return acc / x.shape[0]


def cascade_matrices(view, proj, light_dir, z_near: float, z_far: float, *,
                     extrude: float = 50.0):
    """(NUM_CSM_CASCADES, 4, 4) light view-projections (reverse-Z depth in
    [0, 1]): each bounds its frustum slice in light space, and its near
    plane is pushed ``extrude`` toward the light so casters outside the
    slice still occlude (CalculateLightProjectionForCascades). Runs on the
    inputs' device; the inverse is ``math3d.inverse``."""
    dev = view.device
    inv_vp = m3.inverse(proj @ view)
    splits = [z_near] + cascade_splits(z_near, z_far)
    ld = m3.normalize(_vec3(light_dir, dev))
    up_y = torch.tensor([0.0, 1.0, 0.0], device=dev)
    up_x = torch.tensor([1.0, 0.0, 0.0], device=dev)
    up = torch.where(ld[1].abs() > 0.95, up_x, up_y)

    def ndc_z(dist):
        p = proj @ torch.tensor([0.0, 0.0, -dist, 1.0], device=dev)
        return p[2] / p[3]

    mats = []
    for i in range(config.NUM_CSM_CASCADES):
        corners = frustum_slice_corners(inv_vp, ndc_z(splits[i]), ndc_z(splits[i + 1]))
        center = _mean_rows(corners)
        lview = m3.look_at(center - ld, center, up)
        lc = m3.transform_point(lview, corners)
        lo = lc.amin(dim=0)
        hi = lc.amax(dim=0)
        lproj = m3.ortho(lo[0], hi[0], lo[1], hi[1], -(hi[2] + extrude),
                         -lo[2] + extrude, reverse_z=True)
        mats.append(lproj @ lview)
    return torch.stack(mats)


def select_cascade(view, world_pos, z_far: float):
    """Per-pixel cascade index (Lighting.glsl SelectCascade)."""
    depth = m3.transform_point(view, world_pos)[..., 2].abs()
    layer = torch.full(depth.shape, config.NUM_CSM_CASCADES - 1, dtype=torch.int32,
                       device=depth.device)
    for i in reversed(range(config.NUM_CSM_CASCADES)):
        split = _f32(z_far * config.SHADOW_CASCADE_LEVELS[i])
        layer = torch.where(depth < split, i, layer)
    return layer


def evsm_warp(depth01_rev):
    """Reverse-Z shadow depth in [0, 1] -> the 4 EVSM moments
    (e^{c1 z}, e^{2 c1 z}, -e^{-c2 z}, e^{-2 c2 z}) of the standard depth
    z = 1 - d (the background maps to the far plane)."""
    z = 1.0 - depth01_rev
    p = torch.exp(config.EVSM_C1 * z)
    n = -torch.exp(-config.EVSM_C2 * z)
    return torch.stack([p, p * p, n, n * n], dim=-1)


def _linstep(lo, hi, v):
    return torch.clamp((v - lo) / max(hi - lo, 1e-12), 0.0, 1.0)


def chebyshev(mean, second, value, min_variance, light_bleed: float):
    d = value - mean
    variance = torch.clamp(second - mean * mean, min=min_variance)
    p_max = variance / (variance + d * d)
    p_max = _linstep(light_bleed, 1.0, p_max)
    return torch.where(d < 0.0, torch.ones_like(p_max), p_max)


def _project_to_shadow(light_mat, world_pos):
    """World -> shadow-map (uv, reverse-Z depth, inside the map)."""
    p = m3.transform_point_h(light_mat, world_pos)
    w = p[..., 3:4]
    ndc = p[..., :3] / torch.clamp(w.abs(), min=1e-12) * torch.sign(w)
    uv = torch.stack([ndc[..., 0] * 0.5 + 0.5, 0.5 - ndc[..., 1] * 0.5], dim=-1)
    z = ndc[..., 2]
    ok = ((uv[..., 0] >= 0.0) & (uv[..., 0] <= 1.0) & (uv[..., 1] >= 0.0)
          & (uv[..., 1] <= 1.0) & (z >= 0.0) & (z <= 1.0))
    return uv, z, ok


def _slope_bias(normal, light_dir):
    ld = _vec3(light_dir, normal.device)
    return torch.clamp(0.002 * (1.0 - m3.dot(normal, -ld)), min=0.0005)


def _pcf_taps(z, bias, uv, s: int, texel: float, fetch, num_taps: int):
    """Mean occlusion of ``num_taps`` Poisson taps; ``fetch(x, y)`` gives
    the reverse-Z depth at integer texel (x, y), both clamped to [0, s)."""
    occl = torch.zeros_like(z)
    for k in range(num_taps):
        off = torch.from_numpy(_POISSON[k]).to(uv.device) * _f32(texel)
        uvk = uv + off
        x = torch.clamp(torch.floor(uvk[..., 0] * s).to(torch.int32), 0, s - 1)
        y = torch.clamp(torch.floor(uvk[..., 1] * s).to(torch.int32), 0, s - 1)
        d = 1.0 - fetch(x, y)
        occl = occl + torch.where(z - bias > d, 1.0, 0.0)
    return occl / num_taps


def shadow_pcf(shadow_map, light_mat, world_pos, normal, light_dir,
               radius: float = 2.0, num_taps: int = 8):
    """Poisson-disk PCF shadow factor in [0, 1] (1 = lit) against one
    (S, S) reverse-Z map, nearest fetches."""
    uv, z_rev, ok = _project_to_shadow(light_mat, world_pos)
    z = 1.0 - z_rev
    s = shadow_map.shape[0]
    bias = _slope_bias(normal, light_dir)
    occl = _pcf_taps(z, bias, uv, s, radius / s,
                     lambda x, y: shadow_map[y.long(), x.long()], num_taps)
    lit = 1.0 - occl
    return torch.where(ok, lit, torch.ones_like(lit))


def _evsm_lit(moments, z, light_bleed: float):
    pz = torch.exp(config.EVSM_C1 * z)
    nz = -torch.exp(-config.EVSM_C2 * z)
    lit_p = chebyshev(moments[..., 0], moments[..., 1], pz, 0.01, light_bleed)
    lit_n = chebyshev(moments[..., 2], moments[..., 3], nz, 1e-5, light_bleed)
    return torch.minimum(lit_p, lit_n)


def shadow_evsm(evsm_map, light_mat, world_pos, *, light_bleed: float = 0.2):
    """EVSM shadow factor from blurred (S, S, 4) moments
    (ShadowCalculation_Evsm); the receiver is nudged 0.002 toward the light."""
    uv, z_rev, ok = _project_to_shadow(light_mat, world_pos)
    z = 1.0 - z_rev - 0.002
    lit = _evsm_lit(sampling.sample_nearest(evsm_map, uv), z, light_bleed)
    return torch.where(ok, lit, torch.ones_like(lit))


def _pcf_stacked(maps_flat, s: int, cascade: int, light_mat, world_pos,
                 normal, light_dir, radius: float = 2.0, num_taps: int = 8):
    """PCF against cascade ``cascade`` of a flattened (C*S*S,) map stack."""
    uv, z_rev, ok = _project_to_shadow(light_mat, world_pos)
    z = 1.0 - z_rev
    bias = _slope_bias(normal, light_dir)
    base = cascade * s * s
    occl = _pcf_taps(z, bias, uv, s, radius / s,
                     lambda x, y: maps_flat[(base + y * s + x).long()], num_taps)
    lit = 1.0 - occl
    return torch.where(ok, lit, torch.ones_like(lit))


def csm_shadow_factor_evsm(world_pos, normal, view, light_dir, light_mats, evsm_maps,
                           z_far: float = 100.0, light_bleed: float = 0.2):
    """CSM factor with blurred EVSM moments for every cascade: the selected
    cascade's uv and depth per pixel, one moment gather, Chebyshev.
    ``normal`` and ``light_dir`` are unused (EVSM needs no slope bias).
    ``world_pos``: (..., 3); ``light_mats``: (C, 4, 4); ``evsm_maps``:
    (C, S, S, 4)."""
    layer = select_cascade(view, world_pos, z_far)
    s = evsm_maps.shape[1]
    flat = evsm_maps.reshape(-1, 4)
    uv = z_rev = ok = None
    for c in range(config.NUM_CSM_CASCADES):
        uv_c, z_c, ok_c = _project_to_shadow(light_mats[c], world_pos)
        if uv is None:
            uv, z_rev, ok = uv_c, z_c, ok_c
        else:
            sel = layer == c
            uv = torch.where(sel[..., None], uv_c, uv)
            z_rev = torch.where(sel, z_c, z_rev)
            ok = torch.where(sel, ok_c, ok)
    z = 1.0 - z_rev - 0.002
    x = torch.clamp(torch.floor(uv[..., 0] * s).to(torch.int32), 0, s - 1)
    y = torch.clamp(torch.floor(uv[..., 1] * s).to(torch.int32), 0, s - 1)
    moments = flat[(layer * (s * s) + y * s + x).long()]
    lit = _evsm_lit(moments, z, light_bleed)
    return torch.where(ok, lit, torch.ones_like(lit))


def csm_shadow_factor(world_pos, normal, view, light_dir, light_mats, shadow_maps,
                      evsm_map=None, z_far: float = 100.0, use_evsm: bool = True):
    """CSM factor per pixel: cascade select, then 8-tap PCF into the stacked
    (C, S, S) maps at the selected cascade; with ``use_evsm`` and an
    ``evsm_map`` (cascade 0's blurred moments), cascade 0 takes EVSM."""
    layer = select_cascade(view, world_pos, z_far)
    s = shadow_maps.shape[-1]
    maps_flat = shadow_maps.reshape(-1)
    proj = [_project_to_shadow(light_mats[c], world_pos)
            for c in range(config.NUM_CSM_CASCADES)]
    lsel = layer.long()[..., None]
    uv = torch.take_along_dim(torch.stack([p[0] for p in proj], dim=-2),
                              lsel[..., None], dim=-2)[..., 0, :]
    z_rev = torch.take_along_dim(torch.stack([p[1] for p in proj], dim=-1), lsel, dim=-1)[..., 0]
    ok = torch.take_along_dim(torch.stack([p[2] for p in proj], dim=-1), lsel, dim=-1)[..., 0]
    z = 1.0 - z_rev
    bias = _slope_bias(normal, light_dir)
    base = layer * (s * s)
    occl = _pcf_taps(z, bias, uv, s, 2.0 / s,
                     lambda x, y: maps_flat[(base + y * s + x).long()], 8)
    pcf = torch.where(ok, 1.0 - occl, torch.ones_like(occl))
    if use_evsm and evsm_map is not None:
        ev = shadow_evsm(evsm_map, light_mats[0], world_pos)
        return torch.where(layer == 0, ev, pcf)
    return pcf
