"""Visibility-buffer resolve: per-pixel attribute interpolation -> GBuffer
(counterpart of sailor_tpu/raster/interpolate.py, fused work-list path
without materials).

The winning raster triangle of each pixel maps back to its source triangle;
a world-space ray barycentric solve (Moller-Trumbore u, v against the
source triangle) interpolates its attributes, perspective-correct and
unchanged for near-clipped sub-triangles.
"""

from __future__ import annotations

import torch

from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.kernels.pbr import GBuffer
from sailor_tpu_torch.raster import tile_raster


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


def resolve_gbuffer_stream(stream_bins, tri_id, inv_view_projection,
                           camera_position, materials=None, *, width: int,
                           height: int, tiles_y: int, tiles_x: int,
                           full_height: int | None = None, row0=0):
    """GBuffer from the fused resolve (B2) over the raster's own bin windows.

    ``stream_bins``: one dict or a list of dicts (rows, big_rows, starts,
    counts, n_big, na, chunk) from DepthPrepass; a pixel's winner matches in
    exactly one set, so their planes sum. Returns (GBuffer, uv, mat_id)."""
    if materials is not None:
        raise NotImplementedError("materials are not ported yet")
    H, W = tri_id.shape
    valid = tri_id >= 0
    fh = full_height if full_height is not None else H
    bin_sets = stream_bins if isinstance(stream_bins, (list, tuple)) else [stream_bins]
    planes = None
    for sb in bin_sets:
        ps = tile_raster.resolve_worklist(
            sb["rows"], sb["big_rows"], tri_id, sb["starts"], sb["counts"],
            sb["n_big"], inv_view_projection, camera_position,
            tiles_y=tiles_y, tiles_x=tiles_x, na=int(sb["na"]), width=W,
            full_height=fh, row0=row0, chunk=int(sb.get("chunk", 128)))
        planes = ps if planes is None else [a + b for a, b in zip(planes, ps)]
    planes = [p[:H, :W] for p in planes]
    wpos = torch.stack(planes[0:3], dim=-1)
    normal = m3.normalize(torch.stack(planes[3:6], dim=-1))
    uv = torch.stack(planes[6:8], dim=-1)
    color = torch.stack(planes[8:12], dim=-1)
    mat_id = planes[12].to(torch.int32)

    cov = valid.to(torch.float32)
    dev = tri_id.device
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    gb = GBuffer(
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
    return gb, uv, mat_id
