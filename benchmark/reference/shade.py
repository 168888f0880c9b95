"""Plain Forward+ shading (Standard.shader's fragment: Cook-Torrance
with GGX, Schlick-GGX Smith and Schlick Fresnel, CalculateLighting's
falloffs), per 16x16 tile over that tile's light list, plus the ambient
(the given IBL term, else a flat one), the emissive term and coverage.

Inputs are plain tensors: a G-buffer dict (world_position, normal,
albedo, metallic, roughness, ao, emissive, coverage), the light table as
a dict of the scene's host arrays, the per-tile light indices and the
camera position."""

from __future__ import annotations

import math

import torch

TILE = 16
DIRECTIONAL, POINT = 0, 1
_EPS = 1e-5
_F0 = 0.04
FIELDS = ("world_position", "normal", "albedo", "metallic", "roughness", "ao", "emissive",
          "coverage")


def _normalize(v):
    return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)), min=1e-12)


def _pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def direct(l_type, l_pos, l_dir, l_int, l_att, l_cut, l_rad, albedo, metallic, roughness,
           f0, normal, wpos, to_cam, cos_lo, shadow):
    to_light = l_pos - wpos
    dist = torch.sqrt(torch.clamp((to_light * to_light).sum(-1, keepdim=True), min=1e-12))
    pdir = to_light / dist
    is_dir = (l_type == DIRECTIONAL)[..., None]
    is_point = (l_type == POINT)[..., None]
    li = torch.where(is_dir, -l_dir, pdir)
    att = 1.0 / (l_att[..., 0:1] + l_att[..., 1:2] * dist + l_att[..., 2:3] * dist * dist)
    rng = 1.0 - torch.clamp(dist / torch.clamp(l_rad[..., None], min=1e-6), 0.0, 1.0) ** 2
    cos_t = (pdir * -l_dir).sum(-1, keepdim=True)
    cone = torch.clamp((cos_t - l_cut[..., 1:2])
                       / torch.clamp(l_cut[..., 0:1] - l_cut[..., 1:2], min=1e-6), 0.0, 1.0)
    fall = torch.where(is_dir, torch.ones_like(att), torch.where(is_point, att * rng, att * cone))
    lh = _normalize(li + to_cam)
    cos_li = torch.clamp((normal * li).sum(-1, keepdim=True), min=0.0)
    cos_lh = torch.clamp((normal * lh).sum(-1, keepdim=True), min=0.0)
    f = f0 + (1.0 - f0) * _pow5(torch.clamp(
        1.0 - torch.clamp((lh * to_cam).sum(-1, keepdim=True), min=0.0), 0.0, 1.0))
    r = roughness[..., None]
    a2 = (r * r) * (r * r)
    dd = (cos_lh * cos_lh) * (a2 - 1.0) + 1.0
    d = a2 / (math.pi * dd * dd)
    k = ((r + 1.0) * (r + 1.0)) / 8.0
    g = (cos_li / (cos_li * (1.0 - k) + k)) * (cos_lo / (cos_lo * (1.0 - k) + k))
    kd = (1.0 - f) * (1.0 - metallic[..., None])
    spec = (f * d * g) / torch.clamp(4.0 * cos_li * cos_lo, min=_EPS)
    return shadow * (kd * albedo[..., :3] + spec) * l_int * cos_li * fall


def _tiles(img, ty, tx):
    c = img.shape[2:]
    return img.reshape(ty, TILE, tx, TILE, *c).permute(0, 2, 1, 3, *range(4, 4 + len(c)))


def shade(gb: dict, lights: dict, indices, camera, shadow=None, ibl=None,
          ambient=(0.03, 0.03, 0.03), chunk: int = 16):
    """(H, W, 3) radiance; H and W whole tiles."""
    h, w = gb["normal"].shape[:2]
    ty, tx = h // TILE, w // TILE
    dt, dev = gb["normal"].dtype, gb["normal"].device
    to_cam = _normalize(camera - gb["world_position"])
    cos_lo = torch.clamp((gb["normal"] * to_cam).sum(-1, keepdim=True), min=0.0)
    f0 = _F0 + (gb["albedo"][..., :3] - _F0) * gb["metallic"][..., None]

    def tiles(x):
        return _tiles(x, ty, tx)[:, :, None]

    pa = dict(albedo=tiles(gb["albedo"]), metallic=tiles(gb["metallic"][..., None])[..., 0],
              roughness=tiles(gb["roughness"][..., None])[..., 0], f0=tiles(f0),
              normal=tiles(gb["normal"]), wpos=tiles(gb["world_position"]),
              to_cam=tiles(to_cam), cos_lo=tiles(cos_lo))
    t_shadow = tiles(shadow[..., None])[..., 0] if shadow is not None else None
    lt = {k: v.to(dev) for k, v in lights.items()}
    lt = {k: (v.to(dt) if v.is_floating_point() else v) for k, v in lt.items()}
    idx = indices.long()
    safe = idx.clamp(min=0)
    kk = idx.shape[-1]
    acc = torch.zeros(ty, tx, TILE, TILE, 3, dtype=dt, device=dev)
    for c0 in range(0, kk, chunk):
        sl = safe[..., c0:c0 + chunk]

        def g(name):
            return lt[name][sl][:, :, :, None, None]

        l_type = lt["type"][sl][:, :, :, None, None]
        sh = 1.0
        if t_shadow is not None:
            sh = torch.where((l_type == DIRECTIONAL)[..., None], t_shadow[..., None],
                             torch.ones_like(t_shadow[..., None]))
        c = direct(l_type, g("position"), g("direction"), g("intensity"), g("attenuation"),
                   g("cutoff"), lt["radius"][sl][:, :, :, None, None], shadow=sh, **pa)
        valid = (idx[..., c0:c0 + chunk] >= 0)[:, :, :, None, None, None]
        acc = acc + torch.where(valid, c, torch.zeros_like(c)).sum(2)
    color = acc.permute(0, 2, 1, 3, 4).reshape(h, w, 3)
    if ibl is not None:
        amb = ibl
    else:
        met = gb["metallic"][..., None]
        a3 = gb["albedo"][..., :3]
        f0a = torch.where(met > 0.0, _F0 + (a3 - _F0) * met, torch.full_like(a3, _F0))
        fr = f0a + (torch.maximum(1.0 - gb["roughness"][..., None], f0a) - f0a) * _pow5(
            torch.clamp(1.0 - cos_lo, 0.0, 1.0))
        kd = (1.0 - fr) * (1.0 - met)
        amb = gb["ao"][..., None] * (kd * a3 + fr * 0.2) * torch.tensor(
            ambient, dtype=dt, device=dev)
    return (color + amb + gb["emissive"]) * gb["coverage"][..., None]
