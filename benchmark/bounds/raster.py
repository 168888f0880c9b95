"""The visibility raster's least work on a frame (B1's launches), from
the scene's triangles alone: each triangle of a pass read once (a 68-byte
row: 17 floats), depth and triangle id written (8 bytes a pixel), a
z-bounded peel reading its two depth bounds (8 bytes a pixel), and 16
float operations a (pixel, triangle) pair inside the triangle's screen
box (four plane evaluations)."""

from __future__ import annotations

from benchmark.bounds import peaks
from benchmark.reference import raster


def pass_s(h: dict, queues: tuple, cull_back: bool, z_bounded: bool, device) -> float:
    t = raster.setup(h, queues, cull_back, device=device)
    npix = h["width"] * h["height"]
    nbytes = t["x"].shape[0] * 68 + npix * 8 + (npix * 8 if z_bounded else 0)
    return peaks.least_s(nbytes, raster.aabb_pairs(t, h["width"], h["height"]) * 16)


def frame_s(h: dict, masked_layers: int, transparent_layers: int, device) -> float:
    """The opaque pass, the masked peel's layers and the transparent
    peel's two-sided layers of one cached frame."""
    return (pass_s(h, (0,), True, False, device)
            + masked_layers * pass_s(h, (1,), True, True, device)
            + transparent_layers * pass_s(h, (2,), False, True, device))
