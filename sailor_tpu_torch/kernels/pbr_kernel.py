"""Forward+ shading kernel (B3) — counterpart of sailor_tpu/kernels/pbr_pallas.py.

``shade_forward_plus_kernel`` replaces ``shade_forward_plus_pallas`` and its
Pallas kernel ``_shade_kernel``: every pixel loops its 16x16 tile's culled
light slots (Cook-Torrance: GGX D, Schlick F, Smith-Schlick G; point, spot
and directional falloff, directional lights times the shadow factor), then
ambient, emissive and coverage are added outside the kernel as in the
reference.

On a CUDA tensor the light loop is ``csrc/shade.cu``; on a CPU tensor it is
``shade_tiles_plain``, the same arithmetic vectorised over the frame.
Reciprocals are exact divisions, as in the JAX package's plain reference
``pbr.shade_forward_plus``. The Pallas kernel's ``pl.reciprocal(approx=True)``
is approximate on the TPU and, in JAX's CPU interpreter, a bfloat16
reciprocal (relative error up to 2^-8); tests/test_torch_shade.py says how
the comparison handles it.
"""

from __future__ import annotations

import torch

from sailor_tpu_torch import config
from sailor_tpu_torch.kernels import cuda_lib
from sailor_tpu_torch.kernels import pbr

TILE = config.LIGHTS_CULLING_TILE_SIZE  # 16
_EPS = 1e-5
_PI = 3.14159265

# light-param column order in the packed (Ty, Tx, K, 16) table
_P_FIELDS = (
    "px", "py", "pz", "dx", "dy", "dz", "ir", "ig", "ib",
    "a0", "a1", "a2", "c0", "c1", "radius", "type_valid",
)
NP = len(_P_FIELDS)


def pack_tile_lights(lights, tile_light_indices):
    """One gather of every tile's light slots into (Ty, Tx, K, 16) rows;
    empty slots read a sentinel row whose type_valid is -1."""
    packed = torch.cat([
        lights.position, lights.direction, lights.intensity,
        lights.attenuation, lights.cutoff, lights.radius[:, None],
        lights.type.to(torch.float32)[:, None],
    ], dim=1)
    sentinel = torch.zeros(1, NP, dtype=torch.float32, device=packed.device)
    sentinel[0, 15] = -1.0
    packed = torch.cat([packed, sentinel])
    L = packed.shape[0] - 1
    idx = tile_light_indices.long()
    return packed[torch.where(idx >= 0, idx, torch.full_like(idx, L))].contiguous()


def _light_step(lrow, n, wp, v, cos_lo, albedo, metallic, roughness, f0, shadow):
    """One light slot's radiance (r, g, b) per pixel; ``lrow`` is the list of
    16 per-pixel light fields. Term order matches csrc/shade.cu."""
    (lpx, lpy, lpz, ldx, ldy, ldz, lir, lig, lib,
     la0, la1, la2, lc0, lc1, lrad, ltv) = lrow
    valid = ltv >= 0.0
    is_dir = ltv == 0.0
    is_spot = ltv == 2.0
    vx, vy, vz = v
    tlx = lpx - wp[0]
    tly = lpy - wp[1]
    tlz = lpz - wp[2]
    d2 = tlx * tlx + tly * tly + tlz * tlz + 1e-12
    inv_d = torch.rsqrt(d2)
    dist = d2 * inv_d
    pdx, pdy, pdz = tlx * inv_d, tly * inv_d, tlz * inv_d
    lix = torch.where(is_dir, -ldx, pdx)
    liy = torch.where(is_dir, -ldy, pdy)
    liz = torch.where(is_dir, -ldz, pdz)
    att = 1.0 / (la0 + la1 * dist + la2 * d2)
    rq = torch.clamp(dist * (1.0 / torch.clamp(lrad, min=1e-6)), max=1.0)
    rf = 1.0 - rq * rq
    cos_cone = pdx * (-ldx) + pdy * (-ldy) + pdz * (-ldz)
    cone = torch.clamp(
        (cos_cone - lc1) * (1.0 / torch.clamp(lc0 - lc1, min=1e-6)), 0.0, 1.0)
    falloff = torch.where(is_dir, torch.ones_like(att),
                          att * torch.where(is_spot, cone, rf))
    hx = lix + vx
    hy = liy + vy
    hz = liz + vz
    hlen = torch.rsqrt(hx * hx + hy * hy + hz * hz + 1e-12)
    hx, hy, hz = hx * hlen, hy * hlen, hz * hlen
    cos_li = torch.clamp(n[0] * lix + n[1] * liy + n[2] * liz, min=0.0)
    cos_lh = torch.clamp(n[0] * hx + n[1] * hy + n[2] * hz, min=0.0)
    cos_hv = torch.clamp(hx * vx + hy * vy + hz * vz, min=0.0)
    fr = pbr._pow5(1.0 - cos_hv)
    alpha = roughness * roughness
    a2 = alpha * alpha
    denom = cos_lh * cos_lh * (a2 - 1.0) + 1.0
    dterm = a2 * (1.0 / (_PI * denom * denom))
    r1 = roughness + 1.0
    kk = r1 * r1 * 0.125
    g1 = cos_li * (1.0 / (cos_li * (1.0 - kk) + kk))
    g2 = cos_lo * (1.0 / (cos_lo * (1.0 - kk) + kk))
    gterm = g1 * g2
    # exact division: the denominator clamps to _EPS at grazing angles
    spec_c = dterm * gterm / torch.clamp(4.0 * cos_li * cos_lo, min=_EPS)
    shade = torch.where(is_dir, shadow, torch.ones_like(shadow))
    base = torch.where(valid, shade * cos_li * falloff, torch.zeros_like(falloff))

    def ch(f0c, albc, intens):
        f = f0c + (1.0 - f0c) * fr
        kd = (1.0 - f) * (1.0 - metallic)
        return (kd * albc + f * spec_c) * intens * base

    return (ch(f0[0], albedo[0], lir), ch(f0[1], albedo[1], lig),
            ch(f0[2], albedo[2], lib))


def shade_tiles_plain(lp, counts, albedo, metallic, roughness, normal, wpos,
                      shadow, camera_position):
    """Plain PyTorch B3: (H, W, 3) direct radiance. Slot k of every pixel
    reads its tile's row k; slots past a tile's count hold the sentinel
    row and add exactly 0, so one loop to the largest count serves all."""
    H, W = metallic.shape
    kmax = int(counts.max()) if counts.numel() else 0
    n = normal.unbind(-1)
    wp = wpos.unbind(-1)
    alb = albedo[..., :3].unbind(-1)
    cam = camera_position.to(torch.float32)
    vx = cam[0] - wp[0]
    vy = cam[1] - wp[1]
    vz = cam[2] - wp[2]
    vlen = torch.rsqrt(vx * vx + vy * vy + vz * vz + 1e-12)
    v = (vx * vlen, vy * vlen, vz * vlen)
    cos_lo = torch.clamp(n[0] * v[0] + n[1] * v[1] + n[2] * v[2], min=0.0)
    f0 = tuple(0.04 + (a - 0.04) * metallic for a in alb)
    if shadow is None:
        shadow = torch.ones_like(metallic)
    acc = [torch.zeros_like(metallic) for _ in range(3)]
    for k in range(kmax):
        rows = lp[:, :, k, :].repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)
        lrow = rows.unbind(-1)
        contrib = _light_step(lrow, n, wp, v, cos_lo, alb, metallic, roughness,
                              f0, shadow)
        acc = [a + c for a, c in zip(acc, contrib)]
    return torch.stack(acc, dim=-1)


def shade_tiles_cuda(lp, counts, albedo, metallic, roughness, normal, wpos,
                     shadow, camera_position):
    """B3 on the card: csrc/shade.cu, one block per 16x16 tile."""
    dev = lp.device
    H, W = metallic.shape
    if H % TILE or W % TILE:
        raise ValueError(f"the frame ({H}x{W}) must pad to whole {TILE}x{TILE} tiles")
    ty, tx = H // TILE, W // TILE
    K = lp.shape[2]
    cuda_lib.require(lp, "lp", torch.float32, (ty, tx, K, NP))
    cuda_lib.require(counts, "counts", torch.int32, (ty, tx), dev)
    cuda_lib.require(albedo, "albedo", torch.float32, (H, W, 4), dev)
    cuda_lib.require(metallic, "metallic", torch.float32, (H, W), dev)
    cuda_lib.require(roughness, "roughness", torch.float32, (H, W), dev)
    cuda_lib.require(normal, "normal", torch.float32, (H, W, 3), dev)
    cuda_lib.require(wpos, "wpos", torch.float32, (H, W, 3), dev)
    if shadow is not None:
        cuda_lib.require(shadow, "shadow", torch.float32, (H, W), dev)
    cuda_lib.require(camera_position, "camera_position", torch.float32, (3,), dev)
    out = torch.empty(H, W, 3, dtype=torch.float32, device=dev)
    lib = cuda_lib.load()
    err = lib.sailor_shade_forward_plus(
        lp.data_ptr(), counts.data_ptr(), albedo.data_ptr(), metallic.data_ptr(),
        roughness.data_ptr(), normal.data_ptr(), wpos.data_ptr(),
        cuda_lib.ptr(shadow), camera_position.data_ptr(), out.data_ptr(),
        K, H, W, cuda_lib.stream_of(lp))
    cuda_lib.check(err, "sailor_shade_forward_plus")
    cuda_lib.LAUNCHES["shade_forward_plus"] += 1
    return out


def shade_forward_plus_kernel(gbuffer, lights, tile_light_indices,
                              camera_position, shadow_factors=None,
                              ibl_ambient=None, tile_light_counts=None):
    """Drop-in for pbr.shade_forward_plus through the B3 kernel.

    ``tile_light_counts``: optional (Ty, Tx) live counts from light culling
    (slots are compacted, so each tile loops only its live slots)."""
    H, W = gbuffer.normal.shape[:2]
    ty, tx = H // TILE, W // TILE
    K = tile_light_indices.shape[-1]
    dev = gbuffer.normal.device
    lp = pack_tile_lights(lights, tile_light_indices)
    if tile_light_counts is None:
        counts = torch.full((ty, tx), K, dtype=torch.int32, device=dev)
    else:
        counts = tile_light_counts.to(torch.int32).contiguous()
    args = (lp, counts, gbuffer.albedo.contiguous(), gbuffer.metallic.contiguous(),
            gbuffer.roughness.contiguous(), gbuffer.normal.contiguous(),
            gbuffer.world_position.contiguous(),
            None if shadow_factors is None else shadow_factors.contiguous(),
            camera_position.to(torch.float32).contiguous())
    color = cuda_lib.dispatch(lp, shade_tiles_plain, shade_tiles_cuda)(*args)

    if ibl_ambient is not None:
        color = color + ibl_ambient
    else:
        to_cam = camera_position - gbuffer.world_position
        cos_lo = torch.clamp(
            (gbuffer.normal * to_cam).sum(-1, keepdim=True)
            / torch.clamp(torch.linalg.vector_norm(to_cam, dim=-1, keepdim=True), min=1e-6),
            min=0.0)
        color = color + pbr.ambient_constant(
            gbuffer.albedo, gbuffer.metallic, gbuffer.roughness, gbuffer.ao,
            gbuffer.normal, cos_lo, (0.03, 0.03, 0.03))
    color = color + gbuffer.emissive
    return color * gbuffer.coverage[..., None]
