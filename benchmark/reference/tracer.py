"""A plain path tracer for chosen pixels, and a brute-force intersector.

``intersect`` tests every ray against every triangle (Moller-Trumbore, a
hit beyond t = 1e-4), in blocks of rays. ``trace_slots`` follows the
paths of chosen ray slots through every sample of one render, as the
renderer's integrator defines them: camera rays through the pixel with a
blue-noise jitter rotated by the R2 sequence; at each bounce the sky (with
the sun disc on the first) for a miss, a shadow ray toward the sun from
each hit that faces it, and a BRDF-sampled next direction (one sample of
the cosine and the GGX/Beckmann lobes, picked with probability 0.2 + 0.6
metallic). The uniforms are the render's own stream (a generator seeded
with the render's seed, one (5 bounces, rays) block a pass), read at each
ray's position in the wavefront; between bounces the wavefront is
reordered by the keys the program sorted it by, which the caller hands
in, so the reference reads the same uniforms while it intersects, shades
and samples on its own. Each of its own keys is compared with the
program's at the same slot.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import bluenoise

RAYS_PER_BLOCK = 256
T_MIN = 1e-4
BECKMANN_BELOW = 0.2


def triangles(h: dict, dtype=torch.float32, device="cpu") -> dict:
    s = h["soup"]
    idx = s["indices"]
    t = {
        "v": torch.from_numpy(s["position"][idx]).to(device, dtype),   # (T, 3, 3)
        "n": torch.from_numpy(s["normal"][idx]).to(device, dtype),     # (T, 3, 3)
    }
    t["lo"] = t["v"].reshape(-1, 3).amin(0)
    t["hi"] = t["v"].reshape(-1, 3).amax(0)
    return t


def intersect(tri: dict, origin, direction, any_hit: bool = False):
    """(t, tri id, u, v, hit) of each ray's closest hit (any hit: the
    hit flag alone is meaningful)."""
    v0, v1, v2 = tri["v"][:, 0], tri["v"][:, 1], tri["v"][:, 2]
    e1, e2 = v1 - v0, v2 - v0
    n = origin.shape[0]
    dev, dt = origin.device, origin.dtype
    out_t = torch.full((n,), float("inf"), device=dev, dtype=dt)
    out_i = torch.full((n,), -1, device=dev, dtype=torch.int64)
    out_u = torch.zeros(n, device=dev, dtype=dt)
    out_v = torch.zeros(n, device=dev, dtype=dt)
    for a in range(0, n, RAYS_PER_BLOCK):
        o = origin[a:a + RAYS_PER_BLOCK, None, :]
        d = direction[a:a + RAYS_PER_BLOCK, None, :]
        p = torch.linalg.cross(d.expand(-1, e2.shape[0], -1), e2[None].expand(d.shape[0], -1, -1),
                               dim=-1)
        det = (e1[None] * p).sum(-1)
        inv = 1.0 / det
        s = o - v0[None]
        u = (s * p).sum(-1) * inv
        q = torch.linalg.cross(s, e1[None].expand_as(s), dim=-1)
        v = (d * q).sum(-1) * inv
        t = (e2[None] * q).sum(-1) * inv
        ok = (det.abs() > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > T_MIN)
        t = torch.where(ok, t, torch.full_like(t, float("inf")))
        best, arg = t.min(1)
        hit = torch.isfinite(best)
        out_t[a:a + RAYS_PER_BLOCK] = best
        out_i[a:a + RAYS_PER_BLOCK] = torch.where(hit, arg, -1)
        out_u[a:a + RAYS_PER_BLOCK] = u.gather(1, arg[:, None])[:, 0]
        out_v[a:a + RAYS_PER_BLOCK] = v.gather(1, arg[:, None])[:, 0]
    return {"t": out_t, "tri": out_i, "u": out_u, "v": out_v, "hit": out_i >= 0}


def hit_on(tri: dict, ids, origin, direction):
    """(t, u, v) where each ray meets the plane of its triangle ``ids``,
    with no inside test (u, v outside [0, 1] where it misses)."""
    v = tri["v"][ids.clamp(min=0)]
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    p = torch.linalg.cross(direction, e2, dim=-1)
    inv = 1.0 / (e1 * p).sum(-1)
    s = origin - v[:, 0]
    q = torch.linalg.cross(s, e1, dim=-1)
    return (e2 * q).sum(-1) * inv, (s * p).sum(-1) * inv, (direction * q).sum(-1) * inv


def swizzle(height: int, width: int, ray_block: int, sub: int):
    """Slot -> scanline pixel (perm) and the padded ray count: each
    ``sub``-ray sub-block a ~square pixel subtile, each ray block a
    supertile of those."""
    nsub = max(ray_block // sub, 1)
    m = sub.bit_length() - 1
    th = 1 << (m // 2)
    tw = sub // th
    k = nsub.bit_length() - 1
    sh = 1 << (k // 2)
    sw = nsub // sh
    h2 = -(-height // (th * sh)) * (th * sh)
    w2 = -(-width // (tw * sw)) * (tw * sw)
    y, x = np.meshgrid(np.arange(h2), np.arange(w2), indexing="ij")
    slot = (((((y // (th * sh)) * (w2 // (tw * sw)) + x // (tw * sw)) * sh
              + (y % (th * sh)) // th) * sw + (x % (tw * sw)) // tw) * th + y % th) * tw + x % tw
    pix = np.minimum(y, height - 1) * width + np.minimum(x, width - 1)
    perm = np.empty(h2 * w2, np.int64)
    perm[slot.reshape(-1)] = pix.reshape(-1)
    real = ((y < height) & (x < width)).reshape(-1)
    owner = np.zeros(h2 * w2, bool)
    owner[slot.reshape(-1)[real]] = True
    return perm, owner, h2 * w2


def _normalize(v):
    return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)), min=1e-12)


def _dot(a, b, keepdim=False):
    return (a * b).sum(-1, keepdim=keepdim)


def _basis(n):
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], -1)
    bt = torch.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return t, bt


def _to_world(n, local):
    t, b = _basis(n)
    return t * local[..., 0:1] + b * local[..., 1:2] + n * local[..., 2:3]


def _pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def _ndf_ggx(c, r):
    a2 = (r * r) * (r * r)
    den = (c * c) * (a2 - 1.0) + 1.0
    return a2 / (math.pi * den * den)


def _lobe_half(n, r, u1, u2):
    a = torch.clamp(r * r, min=1e-4)
    cg = torch.sqrt((1.0 - u2) / (1.0 + (a * a - 1.0) * u2))
    a2 = torch.clamp(r * r, min=1e-4) ** 2
    cb = 1.0 / torch.sqrt(1.0 - a2 * torch.log(torch.clamp(1.0 - u2, min=1e-9)))
    c = torch.where(r < BECKMANN_BELOW, cb, cg)
    sn = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    phi = 2.0 * math.pi * u1
    return _to_world(n, torch.stack([sn * torch.cos(phi), sn * torch.sin(phi), c], -1))


def _lobe_pdf(n, h, wo, r):
    c = torch.clamp(_dot(n, h), min=0.0)
    a2 = torch.clamp(r * r, min=1e-4) ** 2
    c2 = torch.clamp(c * c, min=1e-6)
    d_b = torch.exp((c2 - 1.0) / (a2 * c2)) / (math.pi * a2 * c2 * c2)
    d = torch.where(r < BECKMANN_BELOW, d_b, _ndf_ggx(c, r))
    return torch.clamp(d * c / (4.0 * torch.clamp(_dot(wo, h).abs(), min=1e-6)), min=1e-8)


def brdf(n, wo, wi, albedo, metallic, r):
    """(f, pdf of the cosine lobe, pdf of the specular lobe)."""
    h = _normalize(wo + wi)
    ci = torch.clamp(_dot(n, wi, True), min=0.0)
    co = torch.clamp(_dot(n, wo, True), min=0.0)
    ch = torch.clamp(_dot(n, h, True), min=0.0)
    f0 = 0.04 + (albedo - 0.04) * metallic[..., None]
    f = f0 + (1.0 - f0) * _pow5(torch.clamp(1.0 - torch.clamp(_dot(h, wo, True), min=0.0),
                                            0.0, 1.0))
    rr = r[..., None]
    k = (rr * rr) / 2.0
    g = (ci / (ci * (1.0 - k) + k)) * (co / (co * (1.0 - k) + k))
    spec = f * _ndf_ggx(ch, rr) * g / torch.clamp(4.0 * ci * co, min=1e-6)
    diff = (1.0 - f) * (1.0 - metallic[..., None]) * albedo / math.pi
    return diff + spec, torch.clamp(ci[..., 0], min=1e-6) / math.pi, _lobe_pdf(n, h, wo, r)


def _morton10(x):
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def sort_key(tri, origin, direction, live):
    """Morton cell of the origin (32 per axis over the scene's bounds),
    then the direction quantised to 4 per axis; dead rays last."""
    g = ((origin.float() - tri["lo"].float()) / torch.clamp(tri["hi"].float() - tri["lo"].float(),
                                                            min=1e-6) * 32.0)
    g = g.to(torch.int32).clamp(0, 31)
    cell = (_morton10(g[:, 0]) << 2) | (_morton10(g[:, 1]) << 1) | _morton10(g[:, 2])
    qd = ((direction.float() + 1.0) * 2.0).to(torch.int32).clamp(0, 3)
    dq = (qd[:, 0] * 4 + qd[:, 1]) * 4 + qd[:, 2]
    return torch.where(live, (cell << 6) | dq, 2 ** 30)


def trace_slots(h: dict, r: dict, slots, keys, *, dtype=torch.float32, device="cpu",
                tri=None):
    """Radiance (S, 3) of the render ``r`` (seed, spp, bounces,
    sample_batch, ray_block, sub) at ray slots ``slots``, and the count of
    (ray, sort) pairs where this side's key differs from ``keys`` (the
    program's, a list a pass of a list a sort of (rays,) int tensors)."""
    width, height = h["width"], h["height"]
    mb, sb, spp = int(r["bounces"]), int(r["sample_batch"]), int(r["spp"])
    tri = tri if tri is not None else triangles(h, dtype, device)
    perm, _, nslot = swizzle(height, width, int(r["ray_block"]), int(r["sub"]))
    slots = torch.as_tensor(slots, device=device).long()
    pix = torch.from_numpy(perm).to(device)[slots]
    px, py = (pix % width).to(dtype), (pix // width).to(dtype)
    bu, bv = bluenoise.pixel_jitter(height, width)
    bu = torch.from_numpy(bu.reshape(-1)).to(device)[pix]
    bv = torch.from_numpy(bv.reshape(-1)).to(device)[pix]
    vp = h["proj"].astype(np.float64) @ h["view"].astype(np.float64)
    inv_vp = torch.from_numpy(np.linalg.inv(vp).astype(np.float32)).to(device, dtype)
    cam = torch.from_numpy(h["eye"]).to(device, dtype)
    mat = {k: torch.from_numpy(v).to(device, dtype) for k, v in h["material"].items()}
    sun_dir = torch.from_numpy(h["sun_direction"]).to(device, dtype)
    sun_i = torch.from_numpy(h["sun_intensity"]).to(device, dtype)
    zen = torch.from_numpy(h["sky_zenith"]).to(device, dtype)
    hor = torch.from_numpy(h["sky_horizon"]).to(device, dtype)
    wi_sun = -sun_dir
    gen = torch.Generator(device=device).manual_seed(int(r["seed"]))
    n_s = slots.numel()
    acc = torch.zeros(n_s, 3, device=device, dtype=dtype)
    key_off = 0
    for p in range(spp // sb):
        uni = torch.rand((5 * mb, sb * nslot), generator=gen, device=device)
        js = torch.arange(sb, device=device).repeat_interleave(n_s)
        s_idx = (p * sb + js).to(torch.float32)
        ju = torch.remainder(bu.repeat(sb) + s_idx * (1.0 / bluenoise.PHI2), 1.0)
        jv = torch.remainder(bv.repeat(sb) + s_idx * (1.0 / (bluenoise.PHI2 * bluenoise.PHI2)),
                             1.0)
        xs = (px.repeat(sb) + ju.to(dtype)) / width
        ys = (py.repeat(sb) + jv.to(dtype)) / height
        ndc = torch.stack([xs * 2.0 - 1.0, 1.0 - 2.0 * ys, torch.full_like(xs, 0.5),
                           torch.ones_like(xs)], -1)
        ph = ndc @ inv_vp.T
        d = _normalize(ph[:, :3] / ph[:, 3:4] - cam)
        o = cam.expand(d.shape)
        pos = js * nslot + slots.repeat(sb)
        tp = torch.ones_like(d)
        rad = torch.zeros_like(d)
        live = torch.ones(d.shape[0], dtype=torch.bool, device=device)
        for b in range(mb):
            res = intersect(tri, o, d)
            hit = live & res["hit"]
            miss = live & ~res["hit"]
            tt = torch.clamp(d[:, 1] * 0.5 + 0.5, 0.0, 1.0)[:, None]
            sky = hor * (1.0 - tt) + zen * tt
            if b == 0:
                sky = sky + torch.where(_dot(d, -sun_dir, True) > 0.9995, sun_i * 50.0, 0.0)
            rad = rad + torch.where(miss[:, None], tp * sky, 0.0)
            live = live & res["hit"]
            k = res["tri"].clamp(min=0)
            uu, vv = res["u"][:, None], res["v"][:, None]
            nn = tri["n"][k]
            n = _normalize(nn[:, 0] * (1.0 - uu - vv) + nn[:, 1] * uu + nn[:, 2] * vv)
            n = torch.where((_dot(n, d) < 0.0)[:, None], n, -n)
            hp = o + d * torch.where(res["hit"], res["t"], 0.0)[:, None]
            wo = -d
            albedo = mat["albedo"].expand(d.shape)
            metal = mat["metallic"].expand(d.shape[:1])
            rough = mat["roughness"].expand(d.shape[:1])
            rad = rad + torch.where(hit[:, None], tp * mat["emissive"], 0.0)
            cos_sun = torch.clamp(_dot(n, wi_sun, True), min=0.0)
            facing = hit & (cos_sun[:, 0] > 0.0)
            so = hp + n * 1e-3
            lit = facing & ~intersect(tri, so, wi_sun.expand(so.shape), any_hit=True)["hit"]
            f_sun, _, _ = brdf(n, wo, wi_sun.expand(n.shape), albedo, metal, rough)
            rad = rad + torch.where(lit[:, None], tp * f_sun * sun_i * cos_sun, 0.0)
            u1, u2, ul = (uni[5 * b + i][pos].to(dtype) for i in range(3))
            p_spec = 0.2 + 0.6 * metal
            r1 = torch.sqrt(u1)
            phi = 2.0 * math.pi * u2
            d_cos = _to_world(n, torch.stack([r1 * torch.cos(phi), r1 * torch.sin(phi),
                                              torch.sqrt(torch.clamp(1.0 - u1, min=0.0))], -1))
            hv = _lobe_half(n, rough, u1, u2)
            d_spec = d - 2.0 * _dot(d, hv, True) * hv
            wi = _normalize(torch.where((ul < p_spec)[:, None], d_spec, d_cos))
            above = _dot(n, wi) > 1e-4
            f, pdf_c, pdf_g = brdf(n, wo, wi, albedo, metal, rough)
            pdf = pdf_c * (1.0 - p_spec) + pdf_g * p_spec
            ci = torch.clamp(_dot(n, wi), min=0.0)
            wgt = torch.where((pdf > 1e-8) & above, ci / torch.clamp(pdf, min=1e-8), 0.0)
            tp = tp * f * wgt[:, None]
            live = hit & above & (tp.amax(-1) > 1e-4)
            o, d = hp + n * 1e-3, wi
            if keys is not None and b < mb - 1:
                prog = keys[p][b]
                key_off += int((sort_key(tri, o, d, live) != prog[pos]).sum())
                order = torch.sort(prog, stable=True).indices
                where = torch.empty_like(order)
                where[order] = torch.arange(order.numel(), device=device)
                pos = where[pos]
        acc = acc + rad.reshape(sb, n_s, 3).sum(0)
    return acc / spp, key_off
