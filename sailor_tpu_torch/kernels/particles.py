"""Tile-binned particle splatting in plain torch (counterpart of
sailor_tpu/kernels/particles.py; the reference's ParticlesNode.cpp draws
instanced quads). The JAX package computes the splat in plain jnp, with no
Pallas kernel, so the port computes it in plain PyTorch:

  project -> screen AABB per particle -> bin_all (16-px tiles, one sort,
  a dense pass of the big particles) -> per-slot soft-disc accumulation
  with a reverse-Z soft depth test -> additive HDR splat buffer.

The reference loops each pass's slots to the frame's largest live count
(``fori_loop`` with a traced bound); the port reads that bound to the host
once a pass and loops eagerly, adding the slots in slot order as the
reference does. A tile's per-slot values broadcast over its 16x16 pixels.
The slot step rounds as the reference's compiled loop (ROADMAP C 2): the
squared distance as fma(dx, dx, dy * dy), the soft-depth fade as
fma(z - depth, float32(1 / soft_depth), 1) (XLA turns the division by a
constant into a product by its reciprocal and fuses the add), and the
accumulation as fma(weight, colour, acc); so the splat equals the
reference's bit for bit on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from sailor_tpu_torch import config as cfg
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.raster.setup import bin_all

TILE = cfg.LIGHTS_CULLING_TILE_SIZE  # 16 px, shared with light culling


def project_particles(positions, radii, colors, view_projection, projection, *, width: int,
                      height: int, full_height: int | None = None, row0=0):
    """Screen centre, pixel radius and reverse-Z of each particle and its
    validity: (sx, sy, r_px, z_rev, valid), rounded as the reference's
    compiled splat rounds them."""
    fh = full_height if full_height is not None else height
    clip = m3.transform_point_h(view_projection, positions)
    w = clip[:, 3]
    in_front = w > 1e-4
    safe_w = torch.where(in_front, w, torch.ones_like(w))
    ndc = clip[:, :3] / safe_w[:, None]
    sx = (ndc[:, 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[:, 1] * 0.5) * fh - row0          # local rows
    px_scale = 0.5 * fh * projection[1, 1] / safe_w
    r_px = torch.clamp(radii * px_scale, 0.75, 4.0 * TILE)
    z_rev = ndc[:, 2]                                  # reverse-Z in [0, 1]
    valid = in_front & (z_rev > 0.0) & (z_rev <= 1.0) & (colors[:, 3] > 0.0)
    # cull off-slice particles (their AABB misses every local tile)
    valid = (valid & (sx + r_px > 0) & (sx - r_px < width)
             & (sy + r_px > 0) & (sy - r_px < height))
    return sx, sy, r_px, z_rev, valid


def splat_particles(positions, radii, colors, view_projection, projection, depth_rev, *,
                    width: int, height: int, full_height: int | None = None, row0=0,
                    capacity: int = 64, soft_depth: float = 0.35, stats: dict | None = None):
    """Additive soft-particle splat buffer (H, W, 3) on the inputs' device.

    positions (N, 3) world, radii (N,) world-space radius, colors (N, 4) HDR
    rgb + alpha, depth_rev (H, W) reverse-Z scene depth (0 = background).
    ``capacity`` slots per 16-px tile; particles bigger than a tile ride
    bin_all's dense big pass (16 slots). ``stats``, if given, receives
    "valid" (particles on screen), "overflow" (binned candidates dropped)
    and "slots" (slot iterations run), as tensors."""
    dev = positions.device
    sx, sy, r_px, z_rev, valid = project_particles(
        positions, radii, colors, view_projection, projection, width=width, height=height,
        full_height=full_height, row0=row0)
    # round the tile grid UP and pad the pixel planes to match (viewports
    # like 1080 rows are not multiples of 16); crop the splat at the end
    pw = -(-width // TILE) * TILE
    ph = -(-height // TILE) * TILE
    tiles_x, tiles_y = pw // TILE, ph // TILE
    passes, overflow = bin_all(valid, (sx - r_px, sx + r_px, sy - r_px, sy + r_px),
                               tiles_x=tiles_x, tiles_y=tiles_y, tile_w=TILE, tile_h=TILE,
                               capacity=capacity, rounds=1, big_capacity=16)
    # packed per-particle params: sx, sy, r_px, z_rev, r, g, b, a
    packed = torch.stack([sx, sy, r_px, z_rev, colors[:, 0], colors[:, 1], colors[:, 2],
                          colors[:, 3]], dim=1)  # (N, 8)
    # pixel centres and depth as (Ty, 16, Tx, 16): a tile's value broadcasts
    pix = torch.arange(pw, dtype=torch.float32, device=dev) + 0.5
    piy = torch.arange(ph, dtype=torch.float32, device=dev) + 0.5
    pix_x = pix.reshape(1, 1, tiles_x, TILE)
    pix_y = piy.reshape(tiles_y, TILE, 1, 1)
    depth_p = torch.nn.functional.pad(depth_rev, (0, pw - width, 0, ph - height),
                                      value=1.0)  # padded rows: nearest -> no splat
    depth_p = depth_p.reshape(tiles_y, TILE, tiles_x, TILE)
    bg = depth_p <= 0.0
    acc = torch.zeros(tiles_y, TILE, tiles_x, TILE, 3, device=dev)
    one = torch.ones((), device=dev)
    # the reference's compiled splat multiplies by the float32 reciprocal of
    # soft_depth and fuses the add: fma(z - depth, 1 / soft, 1)
    inv_soft = torch.tensor(float(np.float32(1.0) / np.float32(soft_depth)), device=dev)
    slots = 0
    for bins, counts in passes:
        c = bins.shape[-1]
        live = bins >= 0                                        # (Ty, Tx, C)
        prm = packed[torch.clamp(bins, min=0).long()]           # (Ty, Tx, C, 8)
        prm = torch.where(live[..., None], prm, torch.zeros_like(prm))
        prm_t = prm.permute(2, 3, 0, 1).reshape(c, 8, tiles_y, 1, tiles_x, 1)
        # slots are compacted per tile, so the frame's largest live count
        # covers every particle: one host read a pass
        n_loop = min(int(counts.max()), c)
        slots += n_loop
        for i in range(n_loop):
            row = prm_t[i]
            cx, cy, r, z, a = row[0], row[1], row[2], row[3], row[7]
            dx, dy = pix_x - cx, pix_y - cy
            d2 = m3.fma(dx, dx, dy * dy)
            r2 = torch.clamp(r * r, min=1e-6)
            # soft disc falloff, zero outside the radius
            fall = torch.clamp(1.0 - d2 / r2, min=0.0) ** 2
            # soft depth: fade where geometry is closer (higher reverse-Z);
            # the background (depth 0) never occludes
            fade = torch.clamp(m3.fma(z - depth_p, inv_soft, one), 0.0, 1.0)
            wgt = fall * torch.where(bg, one, fade) * a
            acc = m3.fma(wgt[..., None], row[4:7].permute(1, 2, 3, 4, 0), acc)
    if stats is not None:
        stats.update(valid=valid.sum(), overflow=overflow,
                     slots=torch.tensor(slots))
    return acc.reshape(ph, pw, 3)[:height, :width]
