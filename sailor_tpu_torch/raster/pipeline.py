"""End-to-end raster pipeline: setup -> bin -> tile raster -> GBuffer
(counterpart of sailor_tpu/raster/pipeline.py).

One call produces the visibility buffer and the resolved GBuffer of a
frame through the dense bins: ``bin_all`` cuts each tile's candidates into
fixed-capacity passes plus a big-triangle pass, B9 rasters each pass, and a
strictly-greater depth merge keeps the nearest winner across them.
"""

from __future__ import annotations

import dataclasses

import torch

from sailor_tpu_torch.config import resolve_device
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.kernels.common import round_up
from sailor_tpu_torch.raster import interpolate, setup as rsetup, tile_raster


def raster_merge(tri, passes, tiles_y, tiles_x, z_bounds=None,
                 screen_aabb=None):
    """Rasterize every dense bin pass (B9) and keep the nearest winner: a
    later pass takes a pixel only with strictly greater reverse-Z. With
    ``screen_aabb`` B9 clamps each candidate to its screen AABB (the frame
    graph's dense path); without it, as ``rasterize`` calls it, it does
    not. The passes share one per-triangle row table (``dense_table``)."""
    depth = tid = None
    table = tile_raster.dense_table(tri, screen_aabb)
    for bins, counts in passes:
        d_r, t_r = tile_raster.rasterize_tiles(
            tri, bins, tiles_y=tiles_y, tiles_x=tiles_x, counts=counts,
            z_bounds=z_bounds, prebuilt=table)
        if depth is None:
            depth, tid = d_r, t_r
        else:
            take = d_r > depth
            depth = torch.where(take, d_r, depth)
            tid = torch.where(take, t_r, tid)
    return depth, tid


def rasterize(geometry, view_projection, camera_position=None, *, width: int,
              height: int, capacity: int = 512, rounds: int = 1,
              cull: str = "back", materials=None, device=None):
    """Rasterize world-space geometry into (GBuffer, depth, tri_id, stats).

    Runs on the card unless ``device`` names another; the geometry and
    matrices move there. ``width``/``height`` are padded to whole raster
    tiles internally and the outputs cropped back. Depth is reverse-Z
    (0 = background). Without ``camera_position`` the camera is recovered
    from inv(view_projection). ``stats``: "bin_overflow" (candidates past
    rounds * capacity, and big triangles past the big pass) and
    "tile_tri_counts" (the last pass's per-tile counts, as the reference
    returns them). Tiles are ``tile_raster.TILE_W`` x ``TILE_H`` as the
    module holds it at the call (ValueError naming SAILOR_RASTER_TILE_H,
    before anything runs, unless a positive multiple of 8)."""
    th = tile_raster.check_tile_h()
    dev = resolve_device(device)
    geometry = dataclasses.replace(geometry, **{
        f.name: getattr(geometry, f.name).to(dev) for f in dataclasses.fields(geometry)})
    inv_vp = m3.inverse(view_projection).to(dev)  # on the caller's copy
    view_projection = view_projection.to(dev, torch.float32)
    tiles_x = round_up(width, tile_raster.TILE_W) // tile_raster.TILE_W
    tiles_y = round_up(height, th) // th

    if camera_position is None:
        # the eye maps to clip (0, 0, c, 0) under a perspective VP, so
        # inv_vp @ (0, 0, 1, 0), inv_vp's third column, is its homogeneous point
        cam_h = inv_vp[:, 2]
        camera_position = cam_h[:3] / cam_h[3]
    camera_position = camera_position.to(dev, torch.float32)

    tri, aabb = rsetup.triangle_setup(geometry, view_projection, width=width,
                                      height=height, cull=cull,
                                      zplane_rounding="standalone")
    passes, overflow = rsetup.bin_all(
        tri.valid, aabb, tiles_x=tiles_x, tiles_y=tiles_y,
        tile_w=tile_raster.TILE_W, tile_h=th,
        capacity=capacity, rounds=rounds)
    depth, tid = raster_merge(tri, passes, tiles_y, tiles_x)
    depth = depth[:height, :width]
    tid = tid[:height, :width]
    gbuffer, _uv, _mat_id = interpolate.resolve_gbuffer(
        geometry, tri, tid, inv_vp, camera_position, materials=materials)
    stats = {"bin_overflow": overflow, "tile_tri_counts": passes[-1][1]}
    return gbuffer, depth, tid, stats
