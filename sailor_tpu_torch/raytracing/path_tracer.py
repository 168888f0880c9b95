"""Wavefront path tracer (counterpart of sailor_tpu/raytracing/path_tracer.py,
PathTracer.cpp of the reference renderer).

All pixels of a sample are traced as one batch: a fixed-depth bounce loop
in which every bounce does one closest-hit pass and one sun shadow any-hit
pass through an intersector (below), one-sample MIS between a cosine and a
GGX/Beckmann lobe, and masked termination. Scenes with transmissive materials add the
refraction, Beer-Lambert and Henyey-Greenstein volume path. Between bounces
the whole wavefront is sorted by a Morton key of its origins and a
direction octant (``sort_bounces``), so rays that need the same clusters
share sub-blocks; ``render`` generates its rays in a tile-swizzled order
so every sweep ray block (``sweep.RAY_BLOCK`` rays, sub-blocks of
``sweep.SUB``, as the module holds them at the call) is a compact pixel
supertile, and can pool
``sample_batch`` samples into one wavefront. ``render`` takes the
reference's defaults (one sample a pass, no bounce sort, swizzle on when
the scene has a sweep unless ``SAILOR_TRACE_SWIZZLE=0``);
``render_cached`` resolves the three from the environment as the
reference's does (bounce sort on with a sweep unless
``SAILOR_TRACE_BOUNCE_SORT=0``, ``SAILOR_TRACE_SAMPLE_BATCH``), without
its executable cache. Bounce sort needs the sweep's cluster bounds and is
off without one, as in the reference.

Intersectors, routed per pass as the reference routes them (``_isect``):
the cluster sweep (``raytracing/sweep.py``: kernels B4 and B5, or B6) when
the scene has one and its scalar entry table for the pass's ray count,
``sweep.scalar_bytes``, stays within ``sweep.SMEM_BUDGET`` (1 MiB: from 4
pooled samples at 512x512 it does not), else the BVH8 traversal
(``raytracing/bvh8.py``: the kernel ``csrc/bvh8.cu``). ``scene_from_mesh``
always builds the BVH8 table on the host and builds the sweep for
``tracer="sweep"``, or for ``"auto"`` up to ``MAX_SWEEP_TRIANGLES``
(262,144); ``"bvh8"`` builds none. ``SAILOR_SWEEP_SORT=1`` sorts the rays
inside every sweep pass (``sweep.intersect(sort_rays=True)``).

Miss rays see an analytic sky gradient, or with ``scene_from_mesh(sky=...)``
a lat-long map of the procedural sky (``kernels/sky.py``) baked without
the sun. Hit points sample albedo, tangent-space normal, ORM and emissive
maps: with the mip pyramid (``SAILOR_TRACE_MIPS``, on by default) through
one combined quad table at a ray-cone level of detail, else bilinearly
from mip 0 (``assets/materials.py``).

Random numbers: each pass draws (5 * bounces, R) uniforms (bounce b uses
rows 5b..5b+4: two for the lobe sample, one for the lobe choice, two for
volume events), from a ``torch.Generator`` seeded by ``seed``, or takes
them from the caller (``uniforms``), which is how the tests feed both
packages the same numbers.

Row-sharded tracing over several devices: ``parallel.mesh.sharded_path_trace``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch

from sailor_tpu_torch.assets import materials as mat_mod
from sailor_tpu_torch.config import resolve_device
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.kernels import sky as sky_mod
from sailor_tpu_torch.raytracing import bluenoise
from sailor_tpu_torch.raytracing import bvh8 as bvh8_mod
from sailor_tpu_torch.raytracing import lighting_model as lm
from sailor_tpu_torch.raytracing import sweep as sweep_mod

MAX_SWEEP_TRIANGLES = 262144  # "auto" builds the sweep up to this many triangles
TRACERS = ("auto", "sweep", "bvh8")


@dataclasses.dataclass
class TraceScene:
    # (T, 48) per-triangle shading table, one gather per hit: 0:9 corner
    # normals | 9:12 albedo | 12 metallic | 13 roughness | 14:17 emissive |
    # 17 transmission | 18 ior | 19:22 atten_color | 22 atten_dist |
    # 23 scatter | 24 hg_g | 25:31 corner uvs | 31 albedo_tex (-1) |
    # 32:35 face tangent | 35 bitangent sign | 36 normal_tex | 37 orm_tex |
    # 38 emissive_tex | 39 texel density term | 40 quad group | 41:48 zero
    tri_pack: torch.Tensor
    bvh: bvh8_mod.BVH8           # always built; reports original triangle ids
    sun_direction: torch.Tensor  # (3,) from the sun toward the scene
    sun_intensity: torch.Tensor  # (3,)
    sky_zenith: torch.Tensor     # (3,)
    sky_horizon: torch.Tensor    # (3,)
    has_volumes: bool = False    # any transmissive material
    # (He, We, 3) sun-less lat-long bake of the procedural sky, or None
    env_map: torch.Tensor | None = None
    # textures: the (N, S, S, 4) mip-0 stack, its (N * TPL, 4) mip table and
    # the combined (G * TPL, C) quad rows with their blocks ((name, off, nch))
    textures: torch.Tensor | None = None
    tex_lod: torch.Tensor | None = None
    mip_sizes: tuple = ()
    tex_quad: torch.Tensor | None = None
    quad_blocks: tuple = ()
    has_textures: bool = False
    has_normal_maps: bool = False
    has_orm_maps: bool = False
    has_emissive_maps: bool = False
    # the cluster sweep, built for tracer="sweep" or "auto" up to
    # MAX_SWEEP_TRIANGLES; passes it serves are routed by ``_isect``
    sweep: sweep_mod.SweepScene | None = None

    @property
    def device(self) -> torch.device:
        return self.tri_pack.device

    @property
    def num_triangles(self) -> int:
        return self.tri_pack.shape[0]


TRACE_KEYS = ("tri_pack", "sun_direction", "sun_intensity", "sky_zenith", "sky_horizon")
OPTIONAL_KEYS = ("env_map", "textures", "tex_lod", "tex_quad")
FLAGS = ("has_textures", "has_normal_maps", "has_orm_maps", "has_emissive_maps")


def trace_scene_from_numpy(arrays: dict, sweep_arrays: dict | None, has_volumes: bool,
                           device="cuda", mip_sizes=(), quad_blocks=(),
                           **flags) -> TraceScene:
    """A TraceScene from numpy arrays: ``arrays`` holds TRACE_KEYS, the
    packed (N, 72) float32 BVH8 table under "bvh_table" (``bvh8.build_table``'
    output, or the JAX package's ``TraceScene.bvh.table``) and those of
    OPTIONAL_KEYS the scene has; ``sweep_arrays`` the SweepScene fields
    (``sweep.build_arrays``' output, or the JAX package's SweepScene fields
    of those names), or None for a scene without a sweep; ``flags`` are
    FLAGS."""
    dev = resolve_device(device)
    t = {k: torch.from_numpy(np.array(arrays[k], np.float32)).to(dev)
         for k in TRACE_KEYS + OPTIONAL_KEYS if arrays.get(k) is not None}
    sweep = None if sweep_arrays is None else sweep_mod.sweep_scene_from_numpy(sweep_arrays, dev)
    bvh = bvh8_mod.from_numpy(arrays["bvh_table"], len(arrays["tri_pack"]), dev)
    return TraceScene(bvh=bvh, sweep=sweep,
                      has_volumes=bool(has_volumes), mip_sizes=tuple(mip_sizes),
                      quad_blocks=tuple(quad_blocks),
                      **{k: bool(v) for k, v in flags.items()}, **t)


def scene_from_mesh(soup: dict, materials: dict | None = None, *,
                    sun_direction=(-0.4, -0.8, -0.45), sun_intensity=(4.0, 3.8, 3.5),
                    sky_zenith=(0.25, 0.45, 0.85), sky_horizon=(0.8, 0.85, 0.95),
                    tracer: str = "auto", sky=None, env_size=(128, 256),
                    device="cuda") -> TraceScene:
    """Build a TraceScene from a merged primitive soup (host numpy, then
    moved to ``device``), with the reference's numpy calls. ``tracer``:
    "auto" builds the sweep up to MAX_SWEEP_TRIANGLES triangles, "sweep"
    always, "bvh8" never; the BVH8 table is always built (host C++,
    ``bvh8.build_table``). ``sky``: a ``kernels.sky.SkyParams`` whose
    sun-less radiance is baked on ``device`` into an ``env_size`` lat-long
    map for miss rays; None keeps the analytic gradient."""
    dev = resolve_device(device)
    if tracer not in TRACERS:
        raise ValueError(f"tracer={tracer!r}: one of {TRACERS}")
    pos = np.asarray(soup["position"], np.float32)
    idx = np.asarray(soup["indices"], np.int32)
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
    transmission = np.asarray(materials.get("transmission", np.zeros(m)), np.float32)
    layers = {k: np.asarray(materials.get(f"{k}_texture", np.full(m, -1, np.int32)), np.int32)
              for k in ("albedo", "normal", "orm", "emissive")}
    textures = mat_mod.stack_textures(list(materials.get("images", [])),
                                      int(materials.get("texture_size", 256)))
    # mip pyramid for the ray-cone level of detail; SAILOR_TRACE_MIPS=0 keeps
    # the single-level fetch
    tex_lod, mip_sizes = None, ()
    if textures.shape[0] and os.environ.get("SAILOR_TRACE_MIPS", "1") == "1":
        tex_lod, mip_sizes = mat_mod.build_mip_stack(textures)
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
    pack[:, 31] = layers["albedo"][mat].astype(np.float32)
    # uv-aligned face tangent and bitangent handedness for normal maps
    # (degenerate uvs fall back to e1)
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
    for col, k in ((36, "normal"), (37, "orm"), (38, "emissive")):
        pack[:, col] = layers[k][mat].astype(np.float32)
    # texel-density term of the ray-cone LOD: 0.5 * log2(uv area / world area)
    world_a = np.maximum(np.linalg.norm(gn, axis=1), 1e-20)
    uv_a = np.maximum(np.abs(det), 1e-20)
    pack[:, 39] = np.clip(0.5 * np.log2(uv_a / world_a), -24.0, 24.0)

    # combined quad stack: one row per (material group, level, texel) with
    # every live map's 2x2 footprint; the group id goes to column 40
    tex_quad, quad_blocks = None, ()
    if tex_lod is not None and len(mip_sizes) > 1:
        cand = [("albedo", 4, (1.0, 1.0, 1.0, 1.0)), ("normal", 3, (0.5, 0.5, 1.0)),
                ("orm", 3, (1.0, 1.0, 1.0)), ("emissive", 3, (1.0, 1.0, 1.0))]
        live = [(nm, nch, neu) for nm, nch, neu in cand if bool((layers[nm] >= 0).any())]
        if live:
            zeros = np.zeros(textures.shape[0], np.int32)
            tex_quad, qgroup, _, _, qoffs, _ = mat_mod.build_quad_stack_blocks(
                textures, [(layers[nm], nch, neu) for nm, nch, neu in live], zeros, zeros)
            quad_blocks = tuple((nm, off, nch) for (nm, _, _), (off, nch) in zip(live, qoffs))
            pack[:, 40] = qgroup[mat].astype(np.float32)

    env_map = None
    if sky is not None:
        he, we = env_size
        th = (np.arange(he, dtype=np.float32) + 0.5) / he * np.pi
        ph = (np.arange(we, dtype=np.float32) + 0.5) / we * 2.0 * np.pi - np.pi
        st, ct = np.sin(th)[:, None], np.cos(th)[:, None]
        dgrid = np.stack([np.broadcast_to(st * np.cos(ph)[None, :], (he, we)),
                          np.broadcast_to(ct, (he, we)),
                          np.broadcast_to(st * np.sin(ph)[None, :], (he, we))],
                         axis=-1).astype(np.float32)
        env_map = sky_mod.sky_radiance(torch.from_numpy(dgrid).to(dev), sky,
                                       with_sun=False).cpu().numpy()

    sun = np.asarray(sun_direction, np.float32)
    arrays = {"tri_pack": pack, "sun_direction": sun / np.linalg.norm(sun),
              "sun_intensity": np.asarray(sun_intensity, np.float32),
              "sky_zenith": np.asarray(sky_zenith, np.float32),
              "sky_horizon": np.asarray(sky_horizon, np.float32),
              "env_map": env_map, "textures": textures, "tex_lod": tex_lod,
              "tex_quad": tex_quad, "bvh_table": bvh8_mod.build_table(v0, v1, v2)}
    has_volumes = bool(transmission.max() > 0.0) if m else False
    with_sweep = tracer == "sweep" or (tracer == "auto" and len(idx) <= MAX_SWEEP_TRIANGLES)
    return trace_scene_from_numpy(
        arrays, sweep_mod.build_arrays(v0, v1, v2) if with_sweep else None, has_volumes, dev,
        mip_sizes=mip_sizes, quad_blocks=quad_blocks,
        has_textures=any(bool((ls >= 0).any()) for ls in layers.values()),
        **{f"has_{k}_maps": bool((layers[k] >= 0).any()) for k in ("normal", "orm", "emissive")})


def _isect(scene: TraceScene, origin, direction, *, any_hit=False, active=None):
    """One intersector pass, routed as the reference's ``_isect``: the sweep
    when the scene has one and ``sweep.scalar_bytes`` of this pass's ray
    count (samples pooled, swizzle padding included) is within
    ``sweep.SMEM_BUDGET`` (``SAILOR_SWEEP_SORT=1`` sorts its rays first, as
    the reference reads it), else the BVH8 traversal."""
    if scene.sweep is not None and (sweep_mod.scalar_bytes(scene.sweep, origin.shape[0])
                                    <= sweep_mod.SMEM_BUDGET):
        return sweep_mod.intersect(scene.sweep, origin, direction, any_hit=any_hit,
                                   active=active,
                                   sort_rays=os.environ.get("SAILOR_SWEEP_SORT", "0") == "1")
    return bvh8_mod.intersect(scene.bvh, origin, direction, any_hit=any_hit, active=active)


def sky_radiance(scene: TraceScene, direction, include_sun: bool = True):
    """Miss-ray radiance: the bilinear fetch of the baked lat-long map
    (u from atan2(z, x), v from the polar angle off +y, wrapped in azimuth,
    clamped in elevation) or the analytic gradient, plus the sun disc unless
    the shadow-ray estimator already counted the sun."""
    if scene.env_map is not None:
        he, we = scene.env_map.shape[:2]
        flat = scene.env_map.reshape(he * we, 3)
        d = direction
        u = (torch.atan2(d[..., 2], d[..., 0]) + math.pi) / (2.0 * math.pi)
        v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
        fy = torch.clamp(v * he - 0.5, 0.0, he - 1.0)
        fx = u * we - 0.5
        y0 = torch.floor(fy).to(torch.int64)
        x0f = torch.floor(fx)
        x0 = x0f.to(torch.int64) % we
        y1 = torch.clamp(y0 + 1, max=he - 1)
        x1 = (x0 + 1) % we
        wy = (fy - y0.to(torch.float32))[..., None]
        wx = (fx - x0f)[..., None]
        c00, c01 = flat[y0 * we + x0], flat[y0 * we + x1]
        c10, c11 = flat[y1 * we + x0], flat[y1 * we + x1]
        base = (c00 * (1 - wx) + c01 * wx) * (1 - wy) + (c10 * (1 - wx) + c11 * wx) * wy
    else:
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
    inv_vp = m3.inverse(proj.float() @ view.float()).to(camera_pos.device)
    return _camera_rays_flat(camera_pos, inv_vp, width, height, px, py, u_jitter, v_jitter)


def _camera_rays_flat(camera_pos, inv_vp, width, height, px, py, u_jitter, v_jitter):
    """``camera_rays_flat`` with ``inv_vp`` = inv(proj @ view) given, so that
    a render inverts it once, not once a sample."""
    xs = (px.to(torch.float32) + u_jitter) / width
    ys = (py.to(torch.float32) + v_jitter) / height
    ndc = torch.stack([xs * 2.0 - 1.0, 1.0 - 2.0 * ys, torch.full_like(xs, 0.5),
                       torch.ones_like(xs)], -1)
    d = m3.normalize32(m3.homogenize(ndc @ inv_vp.T) - camera_pos)
    return camera_pos.expand(d.shape), d


def camera_rays(camera_pos, view, proj, width: int, height: int, u_jitter, v_jitter):
    """Primary rays through every pixel of a ``height`` x ``width`` image,
    scanline order, with jitters (scalars or (H, W)): (origin, direction),
    each (H * W, 3), rounded as the reference's eager ``camera_rays``: the
    inverse view-projection from the host (``math3d.inverse``), its product
    with the NDC points as one fused chain over the components 0, 2, 1, 3
    (XLA:CPU's dot), and the length's square root correctly rounded (torch's
    CPU sqrt is not, in the last bit)."""
    dev = camera_pos.device
    inv_vp = m3.inverse(proj.float() @ view.float()).to(dev)
    ones = torch.ones(height, width, device=dev)
    ys = (torch.arange(height, dtype=torch.float32, device=dev)[:, None] + v_jitter) / height
    xs = (torch.arange(width, dtype=torch.float32, device=dev)[None, :] + u_jitter) / width
    ndc = (xs * 2.0 - 1.0 * ones, 1.0 - 2.0 * ys * ones,
           torch.full((height, width), 0.5, device=dev), ones)
    p = ndc[0][..., None] * inv_vp[:, 0]
    for j in (2, 1, 3):
        p = m3.fma(ndc[j][..., None], inv_vp[:, j], p)
    v = m3.homogenize(p) - camera_pos
    sq = (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]
    length = torch.sqrt(torch.clamp(sq, min=0.0).double()).float()[..., None]
    d = v * (1.0 / torch.clamp(length, min=1e-12))
    return camera_pos.expand(d.shape).reshape(-1, 3), d.reshape(-1, 3)


def _material(row, albedo, metallic, roughness, emissive):
    return {
        "albedo": albedo, "metallic": metallic, "roughness": roughness,
        "emissive": emissive, "transmission": row[:, 17], "ior": row[:, 18],
        "atten_color": row[:, 19:22], "atten_dist": row[:, 22],
        "scatter": row[:, 23], "hg_g": row[:, 24],
    }


def _normal_mapped(row, n, n_ts, layer):
    """The shading normal n tilted by a tangent-space normal n_ts: the
    packed face tangent Gram-Schmidt'ed against n, the bitangent from the
    packed handedness; n where the material has no normal map."""
    t = row[:, 32:35]
    t = m3.normalize32(t - n * m3.dot32(n, t, keepdims=True))
    b = m3.cross32(n, t) * row[:, 35:36]
    mapped = m3.normalize32(t * n_ts[:, 0:1] + b * n_ts[:, 1:2] + n * n_ts[:, 2:3])
    return torch.where((layer >= 0)[:, None], mapped, n)


def _shade_hit(scene: TraceScene, res, origin, direction, cone_width=None):
    """Hit-point attributes from one row gather: position, face-forward
    shading normal, whether the ray enters the surface, material. With
    textures the maps are sampled at the hit's uv; ``cone_width`` (the ray
    cone's footprint at the hit) picks the mip level of the quad rows,
    lod = log2(S0 * cone / max(|n . d|, 0.08)) + column 39. (The
    reference's trilinear per-map fetch, ``sample_texture_lod``, serves a
    mip pyramid without quad rows, which a textured scene never has.)"""
    row = scene.tri_pack[res["tri"].clamp(min=0).long()]
    u = res["u"][:, None]
    v = res["v"][:, None]
    w0 = 1.0 - u - v
    n = m3.normalize32(row[:, 0:3] * w0 + row[:, 3:6] * u + row[:, 6:9] * v)
    entering = m3.dot32(n, direction) < 0.0
    n = torch.where(entering[:, None], n, -n)
    pos = origin + direction * res["t"][:, None]
    albedo, metallic, roughness, emissive = row[:, 9:12], row[:, 12], row[:, 13], row[:, 14:17]
    if not scene.has_textures:
        return pos, n, entering, _material(row, albedo, metallic, roughness, emissive)
    uvp = row[:, 25:27] * w0 + row[:, 27:29] * u + row[:, 29:31] * v
    if cone_width is not None and scene.tex_quad is not None:
        # the combined quad rows at the ray-cone level of detail: two row
        # gathers fetch every map; a map a material lacks reads its neutral
        cosr = torch.clamp(m3.dot32(n, direction).abs(), min=0.08)
        lod = (torch.log2(scene.mip_sizes[0] * torch.clamp(cone_width, min=1e-8) / cosr)
               + row[:, 39])
        group = row[:, 40].to(torch.int32)
        off = torch.zeros(group.shape, dtype=torch.bool, device=group.device)
        blocks = mat_mod.sample_quad_blocks(
            scene.tex_quad, scene.mip_sizes,
            tuple((o, nch) for _, o, nch in scene.quad_blocks), group, uvp, lod,
            wrapc=off, nearest=off)
        bmap = {nm: b for (nm, _, _), b in zip(scene.quad_blocks, blocks)}
        if "albedo" in bmap:
            albedo = albedo * bmap["albedo"][..., :3]
        if "normal" in bmap:
            n = _normal_mapped(row, n, bmap["normal"] * 2.0 - 1.0, row[:, 36].to(torch.int32))
        if "orm" in bmap:
            roughness = roughness * bmap["orm"][..., 1]
            metallic = metallic * bmap["orm"][..., 2]
        if "emissive" in bmap:
            emissive = emissive * bmap["emissive"]
        return pos, n, entering, _material(row, albedo, metallic, roughness, emissive)

    # bilinear fetches from mip 0, one map at a time
    def sample_tex(layer, uvp):
        return mat_mod._sample_texture_stack(scene.textures, layer, uvp)

    layer = row[:, 31].to(torch.int32)
    albedo = albedo * torch.where((layer >= 0)[:, None], sample_tex(layer, uvp)[..., :3], 1.0)
    if scene.has_normal_maps:
        nl = row[:, 36].to(torch.int32)
        n = _normal_mapped(row, n, sample_tex(nl, uvp)[..., :3] * 2.0 - 1.0, nl)
    if scene.has_orm_maps:
        # glTF metallicRoughness: G scales roughness, B metallic; the
        # occlusion channel is ignored (the tracer computes visibility)
        ol = row[:, 37].to(torch.int32)
        otex = sample_tex(ol, uvp)
        roughness = torch.where(ol >= 0, roughness * otex[..., 1], roughness)
        metallic = torch.where(ol >= 0, metallic * otex[..., 2], metallic)
    if scene.has_emissive_maps:
        el = row[:, 38].to(torch.int32)
        emissive = torch.where((el >= 0)[:, None], emissive * sample_tex(el, uvp)[..., :3],
                               emissive)
    return pos, n, entering, _material(row, albedo, metallic, roughness, emissive)


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
                      ray_count, sort_bounces: bool = False, cone_spread=None):
    """One radiance sample of the primary rays (origin, direction) (R, 3);
    ``uniforms`` (5 * max_bounces, R). ``cone_spread``: the pixels' angular
    footprint for the ray-cone texture LOD (the cone width at a hit is the
    path length times it). Returns (radiance (R, 3), ray_count + rays
    traced, float32)."""
    r = origin.shape[0]
    dev = origin.device
    sort_bounces = sort_bounces and scene.sweep is not None  # its key needs the clusters
    radiance = torch.zeros(r, 3, device=dev)
    throughput = torch.ones(r, 3, device=dev)
    live = torch.ones(r, dtype=torch.bool, device=dev)
    orig_idx = torch.arange(r, device=dev)
    use_cone = (cone_spread is not None and scene.tex_lod is not None
                and len(scene.mip_sizes) > 1)
    if use_cone:
        dist = torch.zeros(r, device=dev)
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

        cone_w = None
        if use_cone:
            hit_dist = dist + torch.clamp(res["t"], 0.0, 1e8)
            cone_w = hit_dist * cone_spread
        pos, n, entering, mat = _shade_hit(scene, res, origin, direction, cone_width=cone_w)
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
        if use_cone:
            # path length: surface hits advance to the hit, volume scatters
            # by the sampled free-flight distance
            dist = torch.where(hit, hit_dist, dist)
            if volumes:
                dist = torch.where(scattered, dist + t_sc, dist)

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
            if use_cone:
                cols.append(dist[:, None])
            state = torch.cat(cols, 1)[perm]
            origin, direction = state[:, 0:3], state[:, 3:6]
            throughput, radiance = state[:, 6:9], state[:, 9:12]
            live = state[:, 12] > 0.5
            if volumes:
                med_absorb, med_scatter, med_g = state[:, 13:16], state[:, 16], state[:, 17]
                in_medium = state[:, 18] > 0.5
            if use_cone:
                dist = state[:, -1]
            orig_idx = orig_idx[perm]

    if sort_bounces:
        out = torch.empty_like(radiance)
        out[orig_idx] = radiance  # undo the composed permutation
        radiance = out
    return radiance, ray_count


def _sample_uniforms(gen, max_bounces: int, r: int, device):
    return torch.rand((5 * max_bounces, r), generator=gen, device=device)


def trace_rays(scene: TraceScene, origin, direction, *, spp: int = 4, max_bounces: int = 3,
               seed: int = 0, uniforms=None, sort_bounces: bool = False, cone_spread=None):
    """Trace given primary rays; average ``spp`` samples. ``uniforms``:
    optional (spp, 5 * max_bounces, R); ``cone_spread``: optional angular
    footprint for the ray-cone texture LOD. Returns ((R, 3) radiance, rays
    traced)."""
    dev = scene.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    acc = torch.zeros(origin.shape[0], 3, device=dev)
    rays = torch.zeros((), dtype=torch.float32, device=dev)
    for s in range(spp):
        u = (uniforms[s].to(dev) if uniforms is not None
             else _sample_uniforms(gen, max_bounces, origin.shape[0], dev))
        rad, rays = _trace_one_sample(scene, origin, direction, u, max_bounces, rays,
                                      sort_bounces=sort_bounces, cone_spread=cone_spread)
        acc = acc + rad
    return acc / spp, rays


def render(scene: TraceScene, camera_pos, view, proj, *, width: int, height: int,
           spp: int = 16, max_bounces: int = 4, seed: int = 0, uniforms=None,
           sample_batch: int = 1, sort_bounces: bool = False, swizzle: bool | None = None):
    """Render (H, W, 3) linear HDR; also returns the rays traced (float32).

    ``sample_batch`` samples are traced as one wavefront (their rays
    concatenated sample-major), ``spp / sample_batch`` passes; ``spp`` must
    be a multiple of it. ``sort_bounces`` sorts the wavefront between
    bounces (scenes with a sweep only); ``swizzle`` (None: on when the scene
    has a sweep, unless ``SAILOR_TRACE_SWIZZLE=0``) orders the rays in pixel
    supertiles. ``uniforms``: optional
    (spp / sample_batch, 5 * max_bounces, sample_batch * R) with
    R = ``rays_per_sample(width, height, swizzle)``."""
    if swizzle is None:
        swizzle = scene.sweep is not None and os.environ.get("SAILOR_TRACE_SWIZZLE", "1") == "1"
    sb = sample_batch
    if spp % sb != 0:
        raise ValueError(f"spp {spp} not divisible by sample_batch {sb}")
    dev = scene.device
    if swizzle:
        perm, inv, r = _swizzle_maps(height, width, sweep_mod.RAY_BLOCK, sweep_mod.SUB)
    else:
        r = width * height
        perm, inv = np.arange(r, dtype=np.int32), None
    px = torch.from_numpy(perm % width).to(dev)
    py = torch.from_numpy(perm // width).to(dev)
    # per-pixel blue-noise camera jitter, rotated per sample (R2 sequence)
    bn_u, bn_v = bluenoise.pixel_jitter(height, width)
    bn = (torch.from_numpy(bn_u.reshape(-1)[perm]).to(dev),
          torch.from_numpy(bn_v.reshape(-1)[perm]).to(dev))
    inv_vp = m3.inverse(proj.float() @ view.float()).to(dev)  # the caller's copies
    camera_pos, view, proj = (x.to(dev, torch.float32) for x in (camera_pos, view, proj))
    # the pixels' angular footprint: the vertical field of view spans
    # ``height`` pixels, proj[1, 1] = 1 / tan(fov_y / 2)
    cone_spread = None
    if scene.tex_lod is not None and len(scene.mip_sizes) > 1:
        cone_spread = 2.0 / (height * proj[1, 1])
    gen = torch.Generator(device=dev).manual_seed(seed)
    acc = torch.zeros(r, 3, device=dev)
    rays = torch.zeros((), dtype=torch.float32, device=dev)
    for p in range(spp // sb):
        rays_o, rays_d = [], []
        for j in range(sb):
            ju, jv = bluenoise.rotate(bn, float(p * sb + j))
            o, d = _camera_rays_flat(camera_pos, inv_vp, width, height, px, py, ju, jv)
            rays_o.append(o)
            rays_d.append(d)
        origin = rays_o[0] if sb == 1 else torch.cat(rays_o)
        direction = rays_d[0] if sb == 1 else torch.cat(rays_d)
        u = uniforms[p].to(dev) if uniforms is not None else _sample_uniforms(
            gen, max_bounces, sb * r, dev)
        radiance, rays = _trace_one_sample(scene, origin, direction, u, max_bounces, rays,
                                           sort_bounces=sort_bounces, cone_spread=cone_spread)
        if sb > 1:
            radiance = radiance.view(sb, r, 3).sum(0)
        acc = acc + radiance
    acc = acc / spp
    if swizzle:
        acc = acc[torch.from_numpy(inv).to(dev).long()]
    return acc.reshape(height, width, 3), rays


def render_cached(scene: TraceScene, camera_pos, view, proj, *, width: int, height: int,
                  spp: int = 16, max_bounces: int = 4, seed: int = 0, uniforms=None,
                  sample_batch: int | None = None, sort_bounces: bool | None = None,
                  swizzle: bool | None = None):
    """``render`` with the settings the reference's ``render_cached``
    resolves from the environment where the caller gives none:
    ``SAILOR_TRACE_SAMPLE_BATCH`` (1), ``SAILOR_TRACE_BOUNCE_SORT`` (on;
    a scene without a sweep never sorts) and ``SAILOR_TRACE_SWIZZLE`` (on
    when the scene has a sweep, resolved by ``render``). The reference's
    executable cache has no counterpart: PyTorch runs eagerly."""
    if sample_batch is None:
        sample_batch = int(os.environ.get("SAILOR_TRACE_SAMPLE_BATCH", "1"))
    if sort_bounces is None:
        sort_bounces = os.environ.get("SAILOR_TRACE_BOUNCE_SORT", "1") == "1"
    return render(scene, camera_pos, view, proj, width=width, height=height, spp=spp,
                  max_bounces=max_bounces, seed=seed, uniforms=uniforms,
                  sample_batch=sample_batch, sort_bounces=sort_bounces, swizzle=swizzle)


def rays_per_sample(width: int, height: int, swizzle: bool = True) -> int:
    """Rays per sample of ``render`` (the swizzle pads to whole supertiles)."""
    if not swizzle:
        return width * height
    return _swizzle_maps(height, width, sweep_mod.RAY_BLOCK, sweep_mod.SUB)[2]
