"""Wavefront path tracer (counterpart of sailor_tpu/raytracing/path_tracer.py,
PathTracer.cpp of the reference renderer).

All pixels of a sample are traced as one batch: a fixed-depth bounce loop
in which every bounce does one closest-hit pass and one sun shadow any-hit
pass through the sweep intersector (``raytracing/sweep.py``: kernels B4 and
B5 on the card), one-sample MIS between a cosine and a GGX/Beckmann lobe,
and masked termination. Scenes with transmissive materials add the
refraction, Beer-Lambert and Henyey-Greenstein volume path. Between bounces
the whole wavefront is sorted by a Morton key of its origins and a
direction octant (``sort_bounces``), so rays that need the same clusters
share sub-blocks; ``render`` generates its rays in a tile-swizzled order
so every 2048-ray block is a compact pixel supertile. Both are on in
``render``, as the reference's ``render_cached`` sets them with the sweep.

Random numbers: each sample draws (5 * bounces, R) uniforms (bounce b uses
rows 5b..5b+4: two for the lobe sample, one for the lobe choice, two for
volume events), from a ``torch.Generator`` seeded by ``seed``, or takes
them from the caller (``uniforms``), which is how the tests feed both
packages the same numbers.

Not ported (they raise NotImplementedError): textures, env-map skies
(``sky=``), the BVH8 tracer and scenes over 262,144 triangles. Nor are
the reference's ``sample_batch`` pooling and sharded ``trace_rays``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from sailor_tpu_torch.config import resolve_device
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.raytracing import bluenoise
from sailor_tpu_torch.raytracing import lighting_model as lm
from sailor_tpu_torch.raytracing import sweep as sweep_mod

MAX_SWEEP_TRIANGLES = 262144
_TEXTURE_KEYS = ("albedo_texture", "normal_texture", "orm_texture", "emissive_texture")


@dataclasses.dataclass
class TraceScene:
    # (T, 48) per-triangle shading table, one gather per hit: 0:9 corner
    # normals | 9:12 albedo | 12 metallic | 13 roughness | 14:17 emissive |
    # 17 transmission | 18 ior | 19:22 atten_color | 22 atten_dist |
    # 23 scatter | 24 hg_g | 25:31 corner uvs | 31 albedo_tex (-1) |
    # 32:35 face tangent | 35 bitangent sign | 36 normal_tex | 37 orm_tex |
    # 38 emissive_tex | 39 texel density term | 40:48 zero
    tri_pack: torch.Tensor
    sweep: sweep_mod.SweepScene
    sun_direction: torch.Tensor  # (3,) from the sun toward the scene
    sun_intensity: torch.Tensor  # (3,)
    sky_zenith: torch.Tensor     # (3,)
    sky_horizon: torch.Tensor    # (3,)
    has_volumes: bool = False    # any transmissive material

    @property
    def device(self) -> torch.device:
        return self.tri_pack.device


TRACE_KEYS = ("tri_pack", "sun_direction", "sun_intensity", "sky_zenith", "sky_horizon")


def trace_scene_from_numpy(arrays: dict, sweep_arrays: dict, has_volumes: bool,
                           device="cuda") -> TraceScene:
    """A TraceScene from numpy arrays: ``arrays`` holds TRACE_KEYS and
    ``sweep_arrays`` the SweepScene fields (``sweep.build_arrays``' output,
    or the JAX package's TraceScene and SweepScene fields of those names)."""
    dev = resolve_device(device)
    t = {k: torch.from_numpy(np.ascontiguousarray(arrays[k], np.float32)).to(dev)
         for k in TRACE_KEYS}
    return TraceScene(sweep=sweep_mod.sweep_scene_from_numpy(sweep_arrays, dev),
                      has_volumes=bool(has_volumes), **t)


def scene_from_mesh(soup: dict, materials: dict | None = None, *,
                    sun_direction=(-0.4, -0.8, -0.45), sun_intensity=(4.0, 3.8, 3.5),
                    sky_zenith=(0.25, 0.45, 0.85), sky_horizon=(0.8, 0.85, 0.95),
                    tracer: str = "auto", sky=None, device="cuda") -> TraceScene:
    """Build a TraceScene from a merged primitive soup (host numpy, then
    moved to ``device``), with the reference's numpy calls."""
    if sky is not None:
        raise NotImplementedError("env-map skies (sky=) are not ported")
    if tracer not in ("auto", "sweep"):
        raise NotImplementedError(f"tracer={tracer!r} is not ported; the sweep is")
    pos = np.asarray(soup["position"], np.float32)
    idx = np.asarray(soup["indices"], np.int32)
    if len(idx) > MAX_SWEEP_TRIANGLES:
        raise NotImplementedError(
            f"{len(idx)} triangles: scenes over {MAX_SWEEP_TRIANGLES} take the "
            "BVH8 tracer, which is not ported")
    nrm = np.asarray(soup["normal"], np.float32)
    uv = np.asarray(soup["uv"], np.float32)
    mat = np.asarray(soup["material_id"], np.int32)
    v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    if materials is None:
        materials = {
            "albedo": np.asarray([[0.75, 0.75, 0.75]], np.float32),
            "metallic": np.asarray([0.0], np.float32),
            "roughness": np.asarray([0.6], np.float32),
            "emissive": np.zeros((1, 3), np.float32),
        }
    m = len(materials["albedo"])
    if len(materials.get("images", [])) or any(
            (np.asarray(materials.get(k, [-1])) >= 0).any() for k in _TEXTURE_KEYS):
        raise NotImplementedError("textured materials are not ported")
    transmission = np.asarray(materials.get("transmission", np.zeros(m)), np.float32)
    tri_n = np.stack([nrm[idx[:, 0]], nrm[idx[:, 1]], nrm[idx[:, 2]]], axis=1)
    tri_uv = np.stack([uv[idx[:, 0]], uv[idx[:, 1]], uv[idx[:, 2]]], axis=1)

    def matf(k, dflt):
        return np.asarray(materials.get(k, dflt), np.float32)[mat]

    t_n = len(idx)
    pack = np.zeros((t_n, 48), np.float32)
    pack[:, 0:9] = tri_n.reshape(t_n, 9)
    pack[:, 9:12] = np.asarray(materials["albedo"], np.float32)[mat]
    pack[:, 12] = np.asarray(materials["metallic"], np.float32)[mat]
    pack[:, 13] = np.asarray(materials["roughness"], np.float32)[mat]
    pack[:, 14:17] = np.asarray(materials["emissive"], np.float32)[mat]
    pack[:, 17] = transmission[mat]
    pack[:, 18] = matf("ior", np.full(m, 1.5))
    pack[:, 19:22] = matf("atten_color", np.ones((m, 3)))
    pack[:, 22] = matf("atten_dist", np.zeros(m))
    pack[:, 23] = matf("scatter", np.zeros(m))
    pack[:, 24] = matf("hg_g", np.zeros(m))
    pack[:, 25:31] = tri_uv.reshape(t_n, 6)
    pack[:, 31] = -1.0
    # uv-aligned face tangent and bitangent handedness (the reference's
    # normal-map columns; kept so the table equals the reference's)
    e1, e2 = v1 - v0, v2 - v0
    du1 = tri_uv[:, 1] - tri_uv[:, 0]
    du2 = tri_uv[:, 2] - tri_uv[:, 0]
    det = du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1]
    inv_det = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    tang = (du2[:, 1:2] * e1 - du1[:, 1:2] * e2) * inv_det[:, None]
    tlen = np.linalg.norm(tang, axis=1, keepdims=True)
    e1len = np.maximum(np.linalg.norm(e1, axis=1, keepdims=True), 1e-12)
    tang = np.where(tlen > 1e-8, tang / np.maximum(tlen, 1e-12), e1 / e1len)
    bitan = (du1[:, 0:1] * e2 - du2[:, 0:1] * e1) * inv_det[:, None]
    gn = np.cross(e1, e2)
    pack[:, 32:35] = tang
    pack[:, 35] = np.where(np.sum(np.cross(gn, tang) * bitan, axis=1) >= 0.0, 1.0, -1.0)
    pack[:, 36:39] = -1.0
    world_a = np.maximum(np.linalg.norm(gn, axis=1), 1e-20)
    uv_a = np.maximum(np.abs(det), 1e-20)
    pack[:, 39] = np.clip(0.5 * np.log2(uv_a / world_a), -24.0, 24.0)

    sun = np.asarray(sun_direction, np.float32)
    arrays = {"tri_pack": pack, "sun_direction": sun / np.linalg.norm(sun),
              "sun_intensity": np.asarray(sun_intensity, np.float32),
              "sky_zenith": np.asarray(sky_zenith, np.float32),
              "sky_horizon": np.asarray(sky_horizon, np.float32)}
    has_volumes = bool(transmission.max() > 0.0) if m else False
    return trace_scene_from_numpy(arrays, sweep_mod.build_arrays(v0, v1, v2),
                                  has_volumes, device)


def _isect(scene: TraceScene, origin, direction, *, any_hit=False, active=None):
    """One intersector pass (the sweep)."""
    return sweep_mod.intersect(scene.sweep, origin, direction, any_hit=any_hit,
                               active=active)


def sky_radiance(scene: TraceScene, direction, include_sun: bool = True):
    """Analytic sky gradient for miss rays, plus the sun disc unless the
    sun was already counted by the shadow-ray estimator."""
    t = torch.clamp(direction[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    base = scene.sky_horizon * (1.0 - t) + scene.sky_zenith * t
    if include_sun:
        cos_sun = m3.dot32(direction, -scene.sun_direction, keepdims=True)
        base = base + torch.where(cos_sun > 0.9995, scene.sun_intensity * 50.0, 0.0)
    return base


@functools.lru_cache(maxsize=8)
def _swizzle_maps(height: int, width: int, ray_block: int, sub: int):
    """Static pixel -> slot permutation that makes every sweep ray block a
    compact supertile: each ``sub``-ray sub-block a ~square pixel subtile
    (16x16 for 256), each ray block a supertile of those (32x64 px for
    2048). The image pads to whole supertiles with clamped duplicate pixels.

    Returns (perm, inv, r_sw): perm[slot] = scanline pixel id the slot
    traces, inv[pixel] = slot, r_sw >= H*W the padded ray count."""
    nsub = max(ray_block // sub, 1)
    m = sub.bit_length() - 1
    th = 1 << (m // 2)
    tw = sub // th
    k = nsub.bit_length() - 1
    sh = 1 << (k // 2)
    sw = nsub // sh
    H2 = -(-height // (th * sh)) * (th * sh)
    W2 = -(-width // (tw * sw)) * (tw * sw)
    Y, X = np.meshgrid(np.arange(H2), np.arange(W2), indexing="ij")
    sty, stx = Y // (th * sh), X // (tw * sw)
    suy, sux = (Y % (th * sh)) // th, (X % (tw * sw)) // tw
    iy, ix = Y % th, X % tw
    n_stx = W2 // (tw * sw)
    slot = ((((sty * n_stx + stx) * sh + suy) * sw + sux) * th + iy) * tw + ix
    pix = np.minimum(Y, height - 1) * width + np.minimum(X, width - 1)
    perm = np.empty(H2 * W2, np.int32)
    perm[slot.reshape(-1)] = pix.reshape(-1)
    inv = np.empty(height * width, np.int32)
    real = ((Y < height) & (X < width)).reshape(-1)
    inv[pix.reshape(-1)[real]] = slot.reshape(-1)[real]
    return perm, inv, H2 * W2


def camera_rays_flat(camera_pos, view, proj, width, height, px, py, u_jitter, v_jitter):
    """Primary rays through explicit (possibly swizzled) pixel coordinates
    ``px``/``py`` with per-ray jitters."""
    inv_vp = torch.linalg.inv(proj @ view)
    xs = (px.to(torch.float32) + u_jitter) / width
    ys = (py.to(torch.float32) + v_jitter) / height
    ndc = torch.stack([xs * 2.0 - 1.0, 1.0 - 2.0 * ys, torch.full_like(xs, 0.5),
                       torch.ones_like(xs)], -1)
    d = m3.normalize32(m3.homogenize(ndc @ inv_vp.T) - camera_pos)
    return camera_pos.expand(d.shape), d


def _shade_hit(scene: TraceScene, res, origin, direction):
    """Hit-point attributes from one row gather: position, face-forward
    shading normal, whether the ray enters the surface, material."""
    row = scene.tri_pack[res["tri"].clamp(min=0).long()]
    u = res["u"][:, None]
    v = res["v"][:, None]
    w0 = 1.0 - u - v
    n = m3.normalize32(row[:, 0:3] * w0 + row[:, 3:6] * u + row[:, 6:9] * v)
    entering = m3.dot32(n, direction) < 0.0
    n = torch.where(entering[:, None], n, -n)
    pos = origin + direction * res["t"][:, None]
    return pos, n, entering, {
        "albedo": row[:, 9:12], "metallic": row[:, 12], "roughness": row[:, 13],
        "emissive": row[:, 14:17], "transmission": row[:, 17], "ior": row[:, 18],
        "atten_color": row[:, 19:22], "atten_dist": row[:, 22],
        "scatter": row[:, 23], "hg_g": row[:, 24],
    }


def _morton10(x):
    """Spread 10 bits of x so they occupy every third bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _bounce_sort_key(scene: TraceScene, origin, direction, live):
    """Wavefront coherence key: Morton cell of the origin (5 bits per axis
    over the scene's cluster bounds), then the quantised direction; dead
    rays last."""
    lo = scene.sweep.cl_min.amin(0)
    hi = scene.sweep.cl_max.amax(0)
    g = ((origin - lo) / torch.clamp(hi - lo, min=1e-6) * 32.0).to(torch.int32).clamp(0, 31)
    cell = (_morton10(g[:, 0]) << 2) | (_morton10(g[:, 1]) << 1) | _morton10(g[:, 2])
    qd = ((direction + 1.0) * 2.0).to(torch.int32).clamp(0, 3)
    dq = (qd[:, 0] * 4 + qd[:, 1]) * 4 + qd[:, 2]
    return torch.where(live, (cell << 6) | dq, 2 ** 30)


def _trace_one_sample(scene: TraceScene, origin, direction, uniforms, max_bounces: int,
                      ray_count, sort_bounces: bool = False):
    """One radiance sample of the primary rays (origin, direction) (R, 3);
    ``uniforms`` (5 * max_bounces, R). Returns (radiance (R, 3), ray_count
    + rays traced, float32)."""
    r = origin.shape[0]
    dev = origin.device
    radiance = torch.zeros(r, 3, device=dev)
    throughput = torch.ones(r, 3, device=dev)
    live = torch.ones(r, dtype=torch.bool, device=dev)
    orig_idx = torch.arange(r, device=dev)
    volumes = scene.has_volumes
    if volumes:
        med_absorb = torch.zeros(r, 3, device=dev)  # Beer-Lambert sigma_a
        med_scatter = torch.zeros(r, device=dev)    # sigma_s
        med_g = torch.zeros(r, device=dev)          # HG anisotropy
        in_medium = torch.zeros(r, dtype=torch.bool, device=dev)
    wi_sun = -scene.sun_direction

    for bounce in range(max_bounces):
        res = _isect(scene, origin, direction, active=None if bounce == 0 else live)
        ray_count = ray_count + live.sum().to(torch.float32)
        hit = live & res["hit"]

        scattered = torch.zeros(r, dtype=torch.bool, device=dev)
        if volumes:
            # volume events along the segment [origin, hit point]
            u_s = uniforms[5 * bounce + 3]
            t_hit = torch.where(res["hit"], res["t"], 1e9)
            t_sc = -torch.log(torch.clamp(1.0 - u_s, min=1e-9)) / torch.clamp(med_scatter, min=1e-9)
            scattered = live & in_medium & (med_scatter > 1e-6) & (t_sc < t_hit)
            seg = torch.where(scattered, t_sc, torch.clamp(t_hit, max=1e9))
            att = torch.exp(-med_absorb * torch.where((live & in_medium)[:, None],
                                                      seg[:, None], 0.0))
            throughput = throughput * att
            # HG scatter about the current direction, staying inside
            d_sc = lm.sample_hg(direction, med_g, uniforms[5 * bounce + 4], u_s)
            sc_pos = origin + direction * t_sc[:, None]
            origin = torch.where(scattered[:, None], sc_pos, origin)
            direction = torch.where(scattered[:, None], d_sc, direction)
            hit = hit & ~scattered

        miss = live & ~res["hit"] & ~scattered
        sky = sky_radiance(scene, direction, include_sun=(bounce == 0))
        radiance = radiance + torch.where(miss[:, None], throughput * sky, 0.0)
        live = live & (res["hit"] | scattered)

        pos, n, entering, mat = _shade_hit(scene, res, origin, direction)
        wo = -direction
        radiance = radiance + torch.where(hit[:, None], throughput * mat["emissive"], 0.0)

        # next-event estimation: a sun shadow ray for hits facing the sun
        cos_sun = torch.clamp(m3.dot32(n, wi_sun, keepdims=True), min=0.0)
        shadow_o = pos + n * 1e-3
        facing = hit & (cos_sun[:, 0] > 0.0)
        sres = _isect(scene, shadow_o, wi_sun.expand(shadow_o.shape), any_hit=True,
                      active=facing)
        ray_count = ray_count + facing.sum().to(torch.float32)
        lit = facing & ~sres["hit"]
        f_sun, _, _ = lm.eval_brdf(n, wo, wi_sun.expand(n.shape), mat["albedo"],
                                   mat["metallic"], mat["roughness"])
        nee = throughput * f_sun * scene.sun_intensity * cos_sun
        if volumes:
            # a transmissive surface reflects only the non-transmitted share
            nee = nee * (1.0 - mat["transmission"])[:, None]
        radiance = radiance + torch.where(lit[:, None], nee, 0.0)

        # BRDF-sampled bounce (one-sample MIS between cosine and GGX lobes)
        u1, u2, u_lobe = uniforms[5 * bounce], uniforms[5 * bounce + 1], uniforms[5 * bounce + 2]
        p_spec = 0.2 + 0.6 * mat["metallic"]
        pick_spec = u_lobe < p_spec
        d_cos, _ = lm.sample_cosine_hemisphere(n, u1, u2)
        h = lm.sample_spec_half(n, mat["roughness"], u1, u2)
        d_spec = m3.reflect(direction, h)
        wi = m3.normalize32(torch.where(pick_spec[:, None], d_spec, d_cos))
        above = m3.dot32(n, wi) > 1e-4
        f, pdf_cos, pdf_ggx = lm.eval_brdf(n, wo, wi, mat["albedo"], mat["metallic"],
                                           mat["roughness"])
        pdf = pdf_cos * (1.0 - p_spec) + pdf_ggx * p_spec
        cos_i = torch.clamp(m3.dot32(n, wi), min=0.0)
        weight = torch.where((pdf > 1e-8) & above, cos_i / torch.clamp(pdf, min=1e-8), 0.0)
        new_tp = throughput * f * weight[:, None]
        surf_live = hit & above & (new_tp.amax(-1) > 1e-4)
        new_origin = pos + n * 1e-3
        new_dir = wi

        if volumes:
            # transmission lobe: with probability transmission * (1 - F) the
            # ray refracts (total internal reflection reflects)
            ior = torch.clamp(mat["ior"], min=1.0001)
            eta = torch.where(entering, 1.0 / ior, ior)
            cos_in = torch.clamp(-m3.dot32(n, direction), min=0.0)
            fres = lm.fresnel_dielectric(cos_in, torch.where(entering, ior, 1.0 / ior))
            d_refr, tir = lm.refract(direction, n, eta)
            transmit = (hit & (mat["transmission"] > 0.0)
                        & (u_lobe >= 1.0 - (1.0 - fres) * mat["transmission"]))
            goes_through = transmit & ~tir
            tint = torch.where(goes_through[:, None], mat["albedo"], 1.0)
            new_dir = torch.where(transmit[:, None],
                                  torch.where(tir[:, None], m3.reflect(direction, n), d_refr),
                                  new_dir)
            new_origin = torch.where(goes_through[:, None], pos - n * 1e-3, new_origin)
            new_tp = torch.where(transmit[:, None], throughput * tint, new_tp)
            surf_live = torch.where(transmit, hit, surf_live)
            # medium bookkeeping: entering loads the coefficients, exiting
            # clears them (no nested volumes, as the reference)
            enters = goes_through & entering
            exits = goes_through & ~entering
            sigma_a = -torch.log(torch.clamp(mat["atten_color"], 1e-4, 1.0)) / torch.clamp(
                mat["atten_dist"], min=1e-4)[:, None]
            sigma_a = torch.where((mat["atten_dist"] > 0.0)[:, None], sigma_a, 0.0)
            med_absorb = torch.where(enters[:, None], sigma_a,
                                     torch.where(exits[:, None], 0.0, med_absorb))
            med_scatter = torch.where(enters, mat["scatter"],
                                      torch.where(exits, 0.0, med_scatter))
            med_g = torch.where(enters, mat["hg_g"], torch.where(exits, 0.0, med_g))
            in_medium = torch.where(enters, True, torch.where(exits, False, in_medium))

        live = torch.where(scattered, live, surf_live)
        origin = torch.where(scattered[:, None], origin, new_origin)
        direction = torch.where(scattered[:, None], direction, new_dir)
        throughput = torch.where(scattered[:, None], throughput, new_tp)

        if sort_bounces and bounce < max_bounces - 1:
            # permute the whole wavefront for the next bounce (a stable
            # sort, as the reference's sort_key_val): one sort serves its
            # closest-hit and shadow passes; dead rays pack to the tail
            perm = torch.sort(_bounce_sort_key(scene, origin, direction, live),
                              stable=True).indices
            cols = [origin, direction, throughput, radiance, live.to(torch.float32)[:, None]]
            if volumes:
                cols += [med_absorb, med_scatter[:, None], med_g[:, None],
                         in_medium.to(torch.float32)[:, None]]
            state = torch.cat(cols, 1)[perm]
            origin, direction = state[:, 0:3], state[:, 3:6]
            throughput, radiance = state[:, 6:9], state[:, 9:12]
            live = state[:, 12] > 0.5
            if volumes:
                med_absorb, med_scatter, med_g = state[:, 13:16], state[:, 16], state[:, 17]
                in_medium = state[:, 18] > 0.5
            orig_idx = orig_idx[perm]

    if sort_bounces:
        out = torch.empty_like(radiance)
        out[orig_idx] = radiance  # undo the composed permutation
        radiance = out
    return radiance, ray_count


def _sample_uniforms(gen, max_bounces: int, r: int, device):
    return torch.rand((5 * max_bounces, r), generator=gen, device=device)


def trace_rays(scene: TraceScene, origin, direction, *, spp: int = 4, max_bounces: int = 3,
               seed: int = 0, uniforms=None, sort_bounces: bool = False):
    """Trace given primary rays; average ``spp`` samples. ``uniforms``:
    optional (spp, 5 * max_bounces, R). Returns ((R, 3) radiance, rays
    traced)."""
    dev = scene.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    acc = torch.zeros(origin.shape[0], 3, device=dev)
    rays = torch.zeros((), dtype=torch.float32, device=dev)
    for s in range(spp):
        u = (uniforms[s].to(dev) if uniforms is not None
             else _sample_uniforms(gen, max_bounces, origin.shape[0], dev))
        rad, rays = _trace_one_sample(scene, origin, direction, u, max_bounces, rays,
                                      sort_bounces=sort_bounces)
        acc = acc + rad
    return acc / spp, rays


def render(scene: TraceScene, camera_pos, view, proj, *, width: int, height: int,
           spp: int = 16, max_bounces: int = 4, seed: int = 0, uniforms=None):
    """Render (H, W, 3) linear HDR; also returns the rays traced (float32).

    Swizzled rays, bounce sort on, one sample per pass: the reference's
    ``render_cached`` with the sweep intersector. ``uniforms``: optional
    (spp, 5 * max_bounces, R), R = ``rays_per_sample(width, height)``."""
    dev = scene.device
    perm, inv, r = _swizzle_maps(height, width, sweep_mod.RAY_BLOCK, sweep_mod.SUB)
    px = torch.from_numpy(perm % width).to(dev)
    py = torch.from_numpy(perm // width).to(dev)
    # per-pixel blue-noise camera jitter, rotated per sample (R2 sequence)
    bn_u, bn_v = bluenoise.pixel_jitter(height, width)
    bn = (torch.from_numpy(bn_u.reshape(-1)[perm]).to(dev),
          torch.from_numpy(bn_v.reshape(-1)[perm]).to(dev))
    camera_pos, view, proj = (x.to(dev, torch.float32) for x in (camera_pos, view, proj))
    gen = torch.Generator(device=dev).manual_seed(seed)
    acc = torch.zeros(r, 3, device=dev)
    rays = torch.zeros((), dtype=torch.float32, device=dev)
    for s in range(spp):
        ju, jv = bluenoise.rotate(bn, float(s))
        o, d = camera_rays_flat(camera_pos, view, proj, width, height, px, py, ju, jv)
        u = uniforms[s].to(dev) if uniforms is not None else _sample_uniforms(
            gen, max_bounces, r, dev)
        radiance, rays = _trace_one_sample(scene, o, d, u, max_bounces, rays,
                                           sort_bounces=True)
        acc = acc + radiance
    acc = acc[torch.from_numpy(inv).to(dev).long()] / spp
    return acc.reshape(height, width, 3), rays


def rays_per_sample(width: int, height: int) -> int:
    """Rays per sample of ``render`` (the swizzle pads to whole supertiles)."""
    return _swizzle_maps(height, width, sweep_mod.RAY_BLOCK, sweep_mod.SUB)[2]
