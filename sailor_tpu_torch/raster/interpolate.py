"""Visibility-buffer resolve: per-pixel attribute interpolation -> GBuffer
(counterpart of sailor_tpu/raster/interpolate.py, without materials): the
gather resolve ``resolve_gbuffer`` and the fused ``resolve_gbuffer_stream``
over the raster's bin windows (B2 on the work-list grid, B10 on the grid-k
windows).

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


def _pixel_ndc(height: int, width: int, row0, full_height: int, device, stride: int = 1):
    """NDC (ndc_x, ndc_y) of every ``stride``-th pixel centre,
    (ceil(H / stride), ceil(W / stride)) each; local row y maps through
    (y * stride + row0 + 0.5) / full_height. The reference's CPU build
    divides by the static sizes as products with their float32 reciprocals,
    folds the doubling into them and fuses the offset:
    ndc_x = fma(x + 0.5, 2 * (1 / width), -1), and likewise y."""
    def ndc(n, size, offset, sign):
        k = 2.0 * float(torch.tensor(1.0 / size, dtype=torch.float32))
        c = torch.arange(n, dtype=torch.float32, device=device) * stride + 0.5 + offset
        return fma(c, torch.full_like(c, sign * k), torch.full_like(c, -sign))

    ndc_y, ndc_x = torch.meshgrid(ndc(-(-height // stride), full_height, row0, -1.0),
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
    """Per-raster-triangle packed attribute table (R, 37).

    Columns: v0(3) e1(3) e2(3) n0(3) dn1(3) dn2(3) uv0(2) duv1(2) duv2(2)
    c0(4) dc1(4) dc2(4) mat_id(1); deltas make each interpolation
    a0 + u*da1 + v*da2."""
    if materials is not None:
        raise NotImplementedError("materials are not ported yet")
    vidx = geometry.indices[src_id.long()].long()
    cols = []
    for attr in (geometry.position, geometry.normal, geometry.uv, geometry.color):
        a0, a1, a2 = attr[vidx[:, 0]], attr[vidx[:, 1]], attr[vidx[:, 2]]
        cols += [a0, a1 - a0, a2 - a0]
    cols.append(geometry.material_id[src_id.long()].to(torch.float32)[:, None])
    return torch.cat(cols, dim=1)


def pack_source_attributes(geometry, materials=None):
    """pack_triangle_attributes over the original triangle list — camera
    independent, so a scene packs it once."""
    t = geometry.indices.shape[0]
    return pack_triangle_attributes(
        geometry, torch.arange(t, dtype=torch.int32, device=geometry.indices.device),
        materials)


def _gbuffer(valid, wpos, normal, color):
    """The material-less G-buffer: vertex colour as albedo, metallic 0,
    roughness 0.5, background pixels zeroed with an up-facing normal."""
    H, W = valid.shape
    dev = valid.device
    cov = valid.to(torch.float32)
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    return GBuffer(
        world_position=wpos * cov[..., None],
        normal=torch.where(valid[..., None], normal, up),
        albedo=color * cov[..., None],
        metallic=torch.zeros(H, W, device=dev),
        roughness=torch.where(valid, torch.full((H, W), 0.5, device=dev),
                              torch.ones(H, W, device=dev)),
        ao=torch.ones(H, W, device=dev),
        emissive=torch.zeros(H, W, 3, device=dev),
        coverage=cov,
    )


def resolve_gbuffer(geometry, tri_setup, tri_id, inv_view_projection,
                    camera_position, materials=None,
                    full_height: int | None = None, row0=0):
    """GBuffer from the visibility buffer by one per-pixel gather of the
    winner's packed row, Moller-Trumbore u, v along the pixel ray, and the
    clamped interpolation. Returns (GBuffer, uv, mat_id)."""
    if materials is not None:
        raise NotImplementedError("materials are not ported yet")
    H, W = tri_id.shape
    valid = tri_id >= 0
    packed = pack_triangle_attributes(geometry, tri_setup.src_id)
    px = packed[torch.clamp(tri_id, min=0).long()]          # (H, W, 37)
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
    qvec = m3.cross(tvec, e1)
    v = m3.dot(d, qvec, keepdims=True) * inv_det
    u = torch.clamp(u, 0.0, 1.0)
    v = torch.minimum(torch.clamp(v, min=0.0), 1.0 - u)

    def lerp3(a0, a1, a2):  # a0 + a1*u + a2*v
        return fma(a2, v, fma(a1, u, a0))

    wpos = lerp3(v0, e1, e2)
    normal = m3.normalize(lerp3(px[..., 9:12], px[..., 12:15], px[..., 15:18]))
    uv = lerp3(px[..., 18:20], px[..., 20:22], px[..., 22:24])
    color = lerp3(px[..., 24:28], px[..., 28:32], px[..., 32:36])
    mat_id = px[..., 36].to(torch.int32)
    return _gbuffer(valid, wpos, normal, color), uv, mat_id


def _resolve_planes(sb, tri_id, inv_view_projection, camera_position, *,
                    tiles_y, tiles_x, width, full_height, row0):
    """One bin set through the fused resolve: B2 on the work-list grid when
    the bins were built for it (``sb["worklist"]``), B10 on the grid-k
    windows otherwise."""
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, na=int(sb["na"]), width=width,
              full_height=full_height, row0=row0)
    args = (sb["rows"], sb["big_rows"], tri_id, sb["starts"], sb["counts"],
            sb["n_big"], inv_view_projection, camera_position)
    if sb["worklist"]:
        return tile_raster.resolve_worklist(*args, chunk=int(sb["chunk"]), **kw)
    return tile_raster.resolve_stream(*args, chunk=int(sb["chunk"]), kmax=int(sb["kmax"]),
                                      **kw)


def resolve_gbuffer_stream(stream_bins, tri_id, inv_view_projection,
                           camera_position, materials=None, *, width: int,
                           height: int, tiles_y: int, tiles_x: int,
                           full_height: int | None = None, row0=0):
    """GBuffer from the fused resolve over the raster's own bin windows.

    ``stream_bins``: one dict or a list of dicts (rows, big_rows, starts,
    counts, n_big, na, chunk, kmax, worklist) from DepthPrepass; a pixel's
    winner matches in exactly one set, so their planes sum. Returns (GBuffer, uv, mat_id)."""
    if materials is not None:
        raise NotImplementedError("materials are not ported yet")
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
    return _gbuffer(valid, wpos, normal, color), uv, mat_id
