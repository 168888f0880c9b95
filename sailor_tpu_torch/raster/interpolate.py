"""Visibility-buffer resolve: per-pixel attribute interpolation -> GBuffer
(counterpart of sailor_tpu/raster/interpolate.py): the gather resolve
``resolve_gbuffer`` and the fused ``resolve_gbuffer_stream`` over the
raster's bin windows (B2 on the work-list grid, B10 on the grid-k windows),
with a ``MaterialTable``'s parameters, albedo and normal maps at the
quad-derivative mip level ``uv_screen_lod``; and the masked peel's alpha
test per layer, ``resolve_alpha`` (gather) and ``resolve_alpha_stream``
(B2's 5-plane emit, or B10's full one).

The winning raster triangle of each pixel maps back to its source triangle;
a world-space ray barycentric solve (Moller-Trumbore u, v against the
source triangle) interpolates its attributes, perspective-correct and
unchanged for near-clipped sub-triangles.
"""

from __future__ import annotations

import torch

from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.core.math3d import fma
from sailor_tpu_torch.kernels.pbr import GBuffer
from sailor_tpu_torch.raster import tile_raster


def _unproject_rays(inv_vp, camera_position, ndc_x, ndc_y, fused: bool = True):
    """World-space ray directions (not normalised) through (ndc_x, ndc_y),
    each row of inv_vp in the reference's fixed ((a+b)+(c+d)) order
    (rounding: core.math3d). The last step, p * (1 / w) - camera, is one
    fused multiply-add where the reference computes the rays alone
    (``pixel_rays``) and two roundings inside its resolve, whose fusion
    keeps it apart (``fused=False``)."""
    m = inv_vp

    def mv(r):
        return fma(m[r, 0], ndc_x, m[r, 1] * ndc_y) + (m[r, 2] * 0.5 + m[r, 3])

    inv_w = 1.0 / mv(3)
    if fused:
        return torch.stack([fma(mv(i), inv_w, -camera_position[i]) for i in range(3)],
                           dim=-1)
    return torch.stack([mv(i) * inv_w for i in range(3)], dim=-1) - camera_position


def _pixel_ndc(height: int, width: int, row0, full_height: int, device, stride: int = 1,
               clamp_rows: bool = False):
    """NDC (ndc_x, ndc_y) of every ``stride``-th pixel centre,
    (ceil(H / stride), ceil(W / stride)) each; local row y maps through
    (y * stride + row0 + 0.5) / full_height, with y * stride + row0
    clamped into [0, full_height) when ``clamp_rows``. The reference's CPU
    build divides by the static sizes as products with their float32
    reciprocals, folds the doubling into them and fuses the offset:
    ndc_x = fma(x + 0.5, 2 * (1 / width), -1), and likewise y."""
    def ndc(n, size, offset, sign, clamp=False):
        k = 2.0 * float(torch.tensor(1.0 / size, dtype=torch.float32))
        c = torch.arange(n, dtype=torch.float32, device=device) * stride
        if clamp:
            c = torch.clamp(c + offset, 0.0, size - 1.0) + 0.5
        else:
            c = c + 0.5 + offset
        return fma(c, torch.full_like(c, sign * k), torch.full_like(c, -sign))

    ndc_y, ndc_x = torch.meshgrid(ndc(-(-height // stride), full_height, row0, -1.0, clamp_rows),
                                  ndc(-(-width // stride), width, 0, 1.0), indexing="ij")
    return ndc_x, ndc_y


def pixel_rays(inv_view_projection, camera_position, height: int, width: int,
               row0=0, full_height: int | None = None):
    """Per-pixel world-space ray directions (H, W, 3)."""
    fh = full_height if full_height is not None else height
    ndc_x, ndc_y = _pixel_ndc(height, width, row0, fh, inv_view_projection.device)
    return _unproject_rays(inv_view_projection.to(torch.float32),
                           camera_position.to(torch.float32), ndc_x, ndc_y)


def pixel_rays_strided(inv_view_projection, camera_position, height: int, width: int,
                       stride: int, row0=0, full_height: int | None = None,
                       fused: bool = True):
    """Rays of every ``stride``-th pixel, (ceil(H / stride), ceil(W /
    stride), 3): the centres 0.5, stride + 0.5, ... of the full grid, as
    ``x[::stride, ::stride]`` of ``pixel_rays``. ``fused`` as in
    ``_unproject_rays``: the reference's Sky node rounds its rays unfused
    (found against its frame graph), its cache key's corners fused."""
    fh = full_height if full_height is not None else height
    ndc_x, ndc_y = _pixel_ndc(height, width, row0, fh, inv_view_projection.device, stride)
    return _unproject_rays(inv_view_projection.to(torch.float32),
                           camera_position.to(torch.float32), ndc_x, ndc_y, fused=fused)


def pack_triangle_attributes(geometry, src_id, materials=None):
    """Per-raster-triangle packed attribute table (R, 37 | 49).

    Columns: v0(3) e1(3) e2(3) n0(3) dn1(3) dn2(3) uv0(2) duv1(2) duv2(2)
    c0(4) dc1(4) dc2(4) mat_id(1); deltas make each interpolation
    a0 + u*da1 + v*da2. With ``materials`` the material row follows, as
    it is constant per triangle: albedo(3) metallic roughness emissive(3)
    albedo_layer normal_layer opacity alpha_cutoff."""
    vidx = geometry.indices[src_id.long()].long()
    cols = []
    for attr in (geometry.position, geometry.normal, geometry.uv, geometry.color):
        a0, a1, a2 = attr[vidx[:, 0]], attr[vidx[:, 1]], attr[vidx[:, 2]]
        cols += [a0, a1 - a0, a2 - a0]
    mid = geometry.material_id[src_id.long()].long()
    cols.append(mid.to(torch.float32)[:, None])
    if materials is not None:
        m = materials
        cols += [m.albedo[mid], m.metallic[mid][:, None], m.roughness[mid][:, None],
                 m.emissive[mid], m.albedo_texture[mid].to(torch.float32)[:, None],
                 m.normal_texture[mid].to(torch.float32)[:, None],
                 m.opacity[mid][:, None], m.alpha_cutoff[mid][:, None]]
    return torch.cat(cols, dim=1)


def pack_source_attributes(geometry, materials=None):
    """pack_triangle_attributes over the original triangle list — camera
    independent, so a scene packs it once."""
    t = geometry.indices.shape[0]
    return pack_triangle_attributes(
        geometry, torch.arange(t, dtype=torch.int32, device=geometry.indices.device),
        materials)


def uv_screen_lod(uv, base_size: int, valid=None):
    """Per-pixel mip level from 2x2 quad derivatives, as a GPU sampler
    takes them: each aligned quad shares one (ddx, ddy) pair from inside
    the quad, wrap-folded to [-0.5, 0.5) so repeat seams do not blow the
    footprint; lod = log2 of the larger axis footprint in texels.
    ``valid``: optional (H, W) coverage; a delta that crosses a background
    pixel is dropped, and a quad with no valid partner samples mip 0. An
    odd last row or column takes its neighbour's level."""
    def fold(d):
        return d - torch.round(d)

    h, w = uv.shape[:2]
    he, we = h - (h % 2), w - (w % 2)
    uq = uv[:he, :we]
    dx = fold((uq[:, 1::2] - uq[:, ::2]).repeat_interleave(2, dim=1))
    dy = fold((uq[1::2] - uq[::2]).repeat_interleave(2, dim=0))
    rx = fma(dx[..., 0], dx[..., 0], dx[..., 1] * dx[..., 1])
    ry = fma(dy[..., 0], dy[..., 0], dy[..., 1] * dy[..., 1])
    if valid is not None:
        vq = valid[:he, :we]
        vx = (vq[:, 1::2] & vq[:, ::2]).repeat_interleave(2, dim=1)
        vy = (vq[1::2] & vq[::2]).repeat_interleave(2, dim=0)
        rx = torch.where(vx, rx, 0.0)
        ry = torch.where(vy, ry, 0.0)
    rho = torch.maximum(rx, ry) * float(base_size * base_size)
    lod = 0.5 * m3.log2(torch.clamp(rho, min=1e-12))
    if (he, we) != (h, w):
        lod = torch.nn.functional.pad(lod[None, None], (0, w - we, 0, h - he),
                                      mode="replicate")[0, 0]
    return lod


def _gbuffer(valid, wpos, normal, albedo, metallic=None, roughness=None, emissive=None):
    """The G-buffer with background pixels zeroed (an up-facing normal,
    roughness 1). Without material planes: vertex colour as albedo,
    metallic 0, roughness 0.5, no emission."""
    H, W = valid.shape
    dev = valid.device
    cov = valid.to(torch.float32)
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    if metallic is None:
        metallic = torch.zeros(H, W, device=dev)
        roughness = torch.full((H, W), 0.5, device=dev)
        emissive = torch.zeros(H, W, 3, device=dev)
    return GBuffer(
        world_position=wpos * cov[..., None],
        normal=torch.where(valid[..., None], normal, up),
        albedo=albedo * cov[..., None],
        metallic=metallic * cov,
        roughness=torch.where(valid, roughness, torch.ones_like(roughness)),
        ao=torch.ones(H, W, device=dev),
        emissive=emissive * cov[..., None],
        coverage=cov,
    )


def _det2(x0, y0, x1, y1):  # x0*y0 - x1*y1
    return fma(x0, y0, -(x1 * y1))


def _materials(materials, valid, uv, mat_id, normal, color, alb, layers, tangent):
    """The material branch of both resolves: the albedo (and normal) map
    at the quad-derivative lod, the albedo times the vertex colour, and the
    tangent-space normal mapping. ``alb``: the material's albedo planes;
    ``layers()``: (albedo layer, normal layer) per pixel; ``tangent()``:
    (the uv tangent's direction (H, W, 3), the uv determinant). Returns
    (albedo RGBA, normal)."""
    lod = (uv_screen_lod(uv, materials.textures.shape[1], valid)
           if materials.has_mips else None)
    quad = materials.has_quad and lod is not None
    n_ts = has_map = None
    if quad:
        # the combined quad rows: one gather a level covers albedo and normal
        tex, n_ts, has_map = materials.sample_combined(mat_id, uv, lod)
        alb = alb * tex[..., :3]
        alpha = tex[..., 3]
    elif materials.textures.shape[0] > 0:
        a_layer = layers()[0]
        tex = materials.sample_texture(a_layer, uv, lod)
        alb = alb * torch.where((a_layer >= 0)[..., None], tex[..., :3], 1.0)
        alpha = torch.where(a_layer >= 0, tex[..., 3], 1.0)
    else:
        alpha = torch.ones_like(alb[..., 0])
    albedo = torch.cat([alb, alpha[..., None]], -1) * color
    # quad rows without a normal block: no material has a normal map
    if materials.textures.shape[0] > 0 and not (quad and not materials.quad_has_normal):
        if n_ts is None:
            n_layer = layers()[1]
            n_ts = materials.sample_texture(n_layer, uv, lod)[..., :3] * 2.0 - 1.0
            has_map = n_layer >= 0
        t_raw, denom = tangent()
        # Gram-Schmidt against the shading normal; the bitangent's sign
        # from the uv determinant (mirrored uvs)
        t_ortho = m3.normalize(t_raw - normal * m3.dot(normal, t_raw, keepdims=True))
        b = m3.cross(normal, t_ortho) * torch.sign(denom)[..., None]
        n_mapped = m3.normalize(t_ortho * n_ts[..., 0:1] + b * n_ts[..., 1:2]
                                + normal * n_ts[..., 2:3])
        normal = torch.where((has_map & (denom.abs() > 1e-12))[..., None], n_mapped, normal)
    return albedo, normal


def _winner_uv(packed, tri_id, inv_view_projection, camera_position, row0, full_height):
    """The winners' packed rows (H, W, C) by one gather and their clamped
    barycentrics u, v (H, W, 1) along the pixel rays (rounded as the
    reference's resolve: the rays unfused)."""
    H, W = tri_id.shape
    px = packed[torch.clamp(tri_id, min=0).long()]
    v0, e1, e2 = px[..., 0:3], px[..., 3:6], px[..., 6:9]
    cam = camera_position.to(torch.float32)
    ndc_x, ndc_y = _pixel_ndc(H, W, row0, full_height or H, tri_id.device)
    d = _unproject_rays(inv_view_projection.to(torch.float32), cam, ndc_x, ndc_y,
                        fused=False)
    pvec = m3.cross(d, e2)
    det = m3.dot(e1, pvec, keepdims=True)
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, torch.zeros_like(det))
    tvec = cam - v0
    u = m3.dot(tvec, pvec, keepdims=True) * inv_det
    v = m3.dot(d, m3.cross(tvec, e1), keepdims=True) * inv_det
    u = torch.clamp(u, 0.0, 1.0)
    v = torch.minimum(torch.clamp(v, min=0.0), 1.0 - u)
    return px, u, v


def _lerp3(a0, a1, a2, u, v):  # a0 + a1*u + a2*v
    return fma(a2, v, fma(a1, u, a0))


def resolve_gbuffer(geometry, tri_setup, tri_id, inv_view_projection,
                    camera_position, materials=None,
                    full_height: int | None = None, row0=0):
    """GBuffer from the visibility buffer by one per-pixel gather of the
    winner's packed row, Moller-Trumbore u, v along the pixel ray, and the
    clamped interpolation; with ``materials`` their parameters, maps and
    normal mapping. Returns (GBuffer, uv, mat_id)."""
    valid = tri_id >= 0
    packed = pack_triangle_attributes(geometry, tri_setup.src_id, materials)
    px, u, v = _winner_uv(packed, tri_id, inv_view_projection, camera_position, row0,
                          full_height)
    e1, e2 = px[..., 3:6], px[..., 6:9]
    wpos = _lerp3(px[..., 0:3], e1, e2, u, v)
    normal = m3.normalize(_lerp3(px[..., 9:12], px[..., 12:15], px[..., 15:18], u, v))
    uv = _lerp3(px[..., 18:20], px[..., 20:22], px[..., 22:24], u, v)
    color = _lerp3(px[..., 24:28], px[..., 28:32], px[..., 32:36], u, v)
    mat_id = px[..., 36].to(torch.int32)
    if materials is None:
        return _gbuffer(valid, wpos, normal, color), uv, mat_id

    def tangent():
        duv1, duv2 = px[..., 20:22], px[..., 22:24]
        denom = _det2(duv1[..., 0], duv2[..., 1], duv2[..., 0], duv1[..., 1])
        inv = torch.where(denom.abs() > 1e-12, 1.0 / denom, torch.zeros_like(denom))
        return _det2(e1, duv2[..., 1:2], e2, duv1[..., 1:2]) * inv[..., None], denom

    albedo, normal = _materials(
        materials, valid, uv, mat_id, normal, color, px[..., 37:40],
        lambda: (px[..., 45].to(torch.int32), px[..., 46].to(torch.int32)), tangent)
    gb = _gbuffer(valid, wpos, normal, albedo, px[..., 40], px[..., 41], px[..., 42:45])
    return gb, uv, mat_id


def resolve_alpha(geometry, tri_setup, tri_id, inv_view_projection, camera_position,
                  materials, row0=0, full_height: int | None = None):
    """The masked peel's alpha test inputs for one layer by the gather
    path: the winner's uv, its material's albedo alpha (the narrow alpha
    table at the nearest mip where the table has quad rows) times the
    vertex colour's alpha. Returns (alpha (H, W), cutoff (H, W))."""
    packed = pack_triangle_attributes(geometry, tri_setup.src_id)
    px, u, v = _winner_uv(packed, tri_id, inv_view_projection, camera_position, row0,
                          full_height)
    uv = _lerp3(px[..., 18:20], px[..., 20:22], px[..., 22:24], u, v)
    mat_id = px[..., 36].to(torch.int32)
    lod = (uv_screen_lod(uv, materials.textures.shape[1], tri_id >= 0)
           if materials.has_mips else None)
    if materials.has_quad and lod is not None:
        alpha = materials.sample_alpha(mat_id, uv, lod)
    else:
        alpha = materials.sample(mat_id, uv, lod)[0][..., 3]
    ca = _lerp3(px[..., 27], px[..., 31], px[..., 35], u[..., 0], v[..., 0])
    return alpha * ca, materials.alpha_cutoff[mat_id.long()]


def _resolve_planes(sb, tri_id, inv_view_projection, camera_position, *,
                    tiles_y, tiles_x, width, full_height, row0, mode: str = "full"):
    """One bin set through the fused resolve: B2 on the work-list grid when
    the bins were built for it (``sb["worklist"]``), B10 on the grid-k
    windows otherwise. ``mode="alpha"`` (B2 only): the 5 peel planes
    [uv.x, uv.y, vertex alpha, mat id, cutoff] in place of all 29."""
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, na=int(sb["na"]), width=width,
              full_height=full_height, row0=row0)
    args = (sb["rows"], sb["big_rows"], tri_id, sb["starts"], sb["counts"],
            sb["n_big"], inv_view_projection, camera_position)
    if sb["worklist"]:
        return tile_raster.resolve_worklist(*args, chunk=int(sb["chunk"]), mode=mode, **kw)
    return tile_raster.resolve_stream(*args, chunk=int(sb["chunk"]), kmax=int(sb["kmax"]),
                                      **kw)


def resolve_gbuffer_stream(stream_bins, tri_id, inv_view_projection,
                           camera_position, materials=None, *, width: int,
                           height: int, tiles_y: int, tiles_x: int,
                           full_height: int | None = None, row0=0,
                           return_extras: bool = False):
    """GBuffer from the fused resolve over the raster's own bin windows.

    ``stream_bins``: one dict or a list of dicts (rows, big_rows, starts,
    counts, n_big, na, chunk, kmax, worklist) from DepthPrepass, one per
    queue that can win the visibility buffer; a pixel's winner matches in
    exactly one set, so their planes sum. With ``materials`` the rows hold
    49 columns and the resolve emits 29 planes. Returns (GBuffer, uv,
    mat_id), and with ``return_extras`` also {"cutoff", "opacity"} planes
    (empty without materials)."""
    H, W = tri_id.shape
    valid = tri_id >= 0
    fh = full_height if full_height is not None else H
    bin_sets = stream_bins if isinstance(stream_bins, (list, tuple)) else [stream_bins]
    planes = None
    for sb in bin_sets:
        ps = _resolve_planes(sb, tri_id, inv_view_projection, camera_position,
                             tiles_y=tiles_y, tiles_x=tiles_x, width=W,
                             full_height=fh, row0=row0)
        planes = ps if planes is None else [a + b for a, b in zip(planes, ps)]
    planes = [p[:H, :W] for p in planes]
    wpos = torch.stack(planes[0:3], dim=-1)
    normal = m3.normalize(torch.stack(planes[3:6], dim=-1))
    uv = torch.stack(planes[6:8], dim=-1)
    color = torch.stack(planes[8:12], dim=-1)
    mat_id = planes[12].to(torch.int32)
    if materials is None:
        gb = _gbuffer(valid, wpos, normal, color)
    else:
        def tangent():
            # the kernel emits the tangent without the gather path's
            # 1 / denom: normalising absorbs the size, the sign is restored
            denom = planes[26]
            return torch.stack(planes[23:26], dim=-1) * torch.sign(denom)[..., None], denom

        albedo, normal = _materials(
            materials, valid, uv, mat_id, normal, color, torch.stack(planes[13:16], dim=-1),
            lambda: (planes[21].to(torch.int32), planes[22].to(torch.int32)), tangent)
        gb = _gbuffer(valid, wpos, normal, albedo, planes[16], planes[17],
                      torch.stack(planes[18:21], dim=-1))
    if return_extras:
        extras = {}
        if materials is not None and len(planes) >= 29:
            extras = {"cutoff": planes[27], "opacity": planes[28]}
        return gb, uv, mat_id, extras
    return gb, uv, mat_id


def resolve_alpha_stream(stream_bins, tri_id, inv_view_projection, camera_position,
                         materials, *, width: int, height: int, tiles_y: int,
                         tiles_x: int, full_height: int | None = None, row0=0):
    """``resolve_alpha`` from the masked queue's bin windows: B2's 5-plane
    ``mode="alpha"`` emit on the work-list grid, B10's full emit on the
    grid-k windows. Returns (alpha (H, W), cutoff)."""
    H, W = tri_id.shape
    fh = full_height if full_height is not None else H
    slim = bool(stream_bins["worklist"])
    planes = _resolve_planes(stream_bins, tri_id, inv_view_projection, camera_position,
                             tiles_y=tiles_y, tiles_x=tiles_x, width=W, full_height=fh,
                             row0=row0, mode="alpha" if slim else "full")
    planes = [p[:H, :W] for p in planes]
    if slim:
        uv, color_a, mat_f, cutoff = torch.stack(planes[0:2], -1), planes[2], planes[3], planes[4]
    else:
        uv, color_a, mat_f, cutoff = (torch.stack(planes[6:8], -1), planes[11], planes[12],
                                      planes[27])
    if materials.textures.shape[0] == 0:
        return color_a, cutoff
    lod = (uv_screen_lod(uv, materials.textures.shape[1], tri_id >= 0)
           if materials.has_mips else None)
    if materials.has_quad and lod is not None:
        # the narrow alpha table: the peel only alpha-tests
        return materials.sample_alpha(mat_f.to(torch.int32), uv, lod) * color_a, cutoff
    # the slim emit carries the material id, not the albedo layer
    a_layer = (planes[21].to(torch.int32) if not slim
               else materials.albedo_texture[mat_f.long()])
    tex = materials.sample_texture(a_layer, uv, lod)
    return torch.where(a_layer >= 0, tex[..., 3], 1.0) * color_a, cutoff
