"""Tiled Forward+ light culling in plain torch (counterpart of
sailor_tpu/kernels/light_culling.py, ComputeLightCulling.shader).

Per 16x16 tile: depth bounds, four side planes through the eye, a sphere
test of every light against the tile frustum and its widened depth slab,
then a sort that keeps the tile's K nearest hit lights (directional lights
first). The two-level form first shortlists ``coarse_capacity`` lights per
4x4-tile supertile and sorts each tile over its shortlist only.

Sort keys pack (camera-distance rank, light id) into one int64 (the JAX
twin packs uint32, which torch cannot sort); ranks come from a stable
argsort, as ``jnp.argsort`` is stable.
"""

from __future__ import annotations

import torch

from sailor_tpu_torch import config
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.kernels.lights import DIRECTIONAL

TILE = config.LIGHTS_CULLING_TILE_SIZE
SUPER = 4  # tiles per supertile edge for the two-level cull


def tile_depth_bounds(linear_depth, tiles_y: int, tiles_x: int):
    """Per-tile (min, max) of linear view-space depth (H, W padded)."""
    t = linear_depth.reshape(tiles_y, TILE, tiles_x, TILE)
    return t.amin(dim=(1, 3)), t.amax(dim=(1, 3))


def _tile_side_planes(tiles_y: int, tiles_x: int, viewport, inv_projection,
                      row0=0, scale: int = 1):
    """View-space side planes for every tile: (Ty, Tx, 4, 4), normals
    pointing into the tile frustum (left, right, top, bottom)."""
    vw, vh = viewport
    dev = inv_projection.device
    xs = torch.arange(tiles_x + 1, dtype=torch.float32, device=dev) * (TILE * scale)
    ys = torch.arange(tiles_y + 1, dtype=torch.float32, device=dev) * (TILE * scale) + row0
    ndc_x = xs / vw * 2.0 - 1.0
    ndc_y = 1.0 - ys / vh * 2.0
    gy, gx = torch.meshgrid(ndc_y, ndc_x, indexing="ij")  # (Ty+1, Tx+1)
    ones = torch.ones_like(gx)
    corners = torch.stack([gx, gy, ones * 0.5, ones], dim=-1)
    m = inv_projection
    # fixed-order 4-term dot, ((a+b)+(c+d)), as the JAX twin's einsum lowers
    v = torch.stack(
        [(m[r, 0] * corners[..., 0] + m[r, 1] * corners[..., 1])
         + (m[r, 2] * corners[..., 2] + m[r, 3] * corners[..., 3])
         for r in range(4)], dim=-1)
    rays = v[..., :3] / v[..., 3:4]
    tl, tr = rays[:-1, :-1], rays[:-1, 1:]
    bl, br = rays[1:, :-1], rays[1:, 1:]
    # the four planes' normalize(cross(a, b)) in one batch
    n = m3.normalize(m3.cross(torch.stack([bl, tr, tl, br], dim=-2),
                              torch.stack([tl, br, tr, bl], dim=-2)))
    return torch.cat([n, torch.zeros_like(n[..., :1])], dim=-1)


def cull_lights(lights, view, inv_projection, linear_depth, *, tiles_y: int,
                tiles_x: int, viewport, max_per_tile: int = config.LIGHTS_PER_TILE,
                row0=0, coarse_capacity: int | None = None):
    """Returns (indices (Ty, Tx, K) int32 with -1 padding, counts (Ty, Tx)
    int32). ``linear_depth``: (Ty*16, Tx*16) positive view-space depth;
    ``viewport`` is the full (w, h)."""
    dev = linear_depth.device
    planes = _tile_side_planes(tiles_y, tiles_x, viewport, inv_projection, row0)
    zmin, zmax = tile_depth_bounds(linear_depth, tiles_y, tiles_x)
    diff = zmax - zmin
    z0 = zmin - diff
    z1 = zmax + diff

    pos_vs = m3.transform_point(view, lights.position)
    is_dir = lights.type == DIRECTIONAL
    z = -pos_vs[..., 2]
    radius = lights.radius
    valid = lights.valid_mask

    k = min(max_per_tile, lights.capacity)
    ntiles = tiles_y * tiles_x
    L = pos_vs.shape[0]
    dist = m3.length(pos_vs)
    order = torch.argsort(torch.where(is_dir, torch.full_like(dist, -1.0), dist),
                          stable=True)
    rank = torch.argsort(order, stable=True)
    id_bits = max(1, (L - 1).bit_length())
    id_mask = (1 << id_bits) - 1
    sentinel = L << id_bits
    lid = torch.arange(L, dtype=torch.int64, device=dev)
    packed_key = (rank.to(torch.int64) << id_bits) | lid

    if coarse_capacity and coarse_capacity < L:
        cc = int(coarse_capacity)
        sy = -(-tiles_y // SUPER)
        sx = -(-tiles_x // SUPER)
        splanes = _tile_side_planes(sy, sx, viewport, inv_projection, row0, scale=SUPER)
        pad = (0, sx * SUPER - tiles_x, 0, sy * SUPER - tiles_y)
        pz0 = torch.nn.functional.pad(z0, pad, value=float("inf"))
        pz1 = torch.nn.functional.pad(z1, pad, value=float("-inf"))
        sz0 = pz0.reshape(sy, SUPER, sx, SUPER).amin(dim=(1, 3))
        sz1 = pz1.reshape(sy, SUPER, sx, SUPER).amax(dim=(1, 3))
        sside = m3.dot(splanes[..., None, :3], pos_vs)        # (Sy, Sx, 4, L)
        s_in = torch.all(sside >= -radius, dim=2)
        s_in &= (z + radius >= sz0[..., None]) & (z - radius <= sz1[..., None])
        s_hit = (s_in | is_dir) & valid
        ckeys = torch.where(s_hit.reshape(sy * sx, L), packed_key,
                            torch.full_like(packed_key, sentinel))
        short = torch.sort(ckeys, dim=-1).values[:, :cc].reshape(sy, sx, cc)
        sl_id = (short & id_mask)
        sl_live = (short >> id_bits) < L

        ldata = torch.cat([pos_vs, radius[:, None], z[:, None],
                           is_dir.to(torch.float32)[:, None]], dim=1)
        sl = ldata[sl_id]                                      # (Sy, Sx, cc, 6)
        p_sl, r_sl = sl[..., 0:3], sl[..., 3]
        z_sl, dir_sl = sl[..., 4], sl[..., 5] > 0.5
        pp = torch.nn.functional.pad(
            planes[..., :3], (0, 0, 0, 0, 0, sx * SUPER - tiles_x, 0, sy * SUPER - tiles_y))
        pp = pp.reshape(sy, SUPER, sx, SUPER, 4, 3)
        # side[a, A, b, B, p, c] = plane(a A b B p) . light(a b c)
        side = m3.dot(pp[..., None, :], p_sl[:, None, :, None, None])
        in_sides = torch.all(side >= -r_sl[:, None, :, None, None, :], dim=4)
        zp0 = pz0.reshape(sy, SUPER, sx, SUPER)
        zp1 = pz1.reshape(sy, SUPER, sx, SUPER)
        zs = z_sl[:, None, :, None]
        rs = r_sl[:, None, :, None]
        in_depth = (zs + rs >= zp0[..., None]) & (zs - rs <= zp1[..., None])
        hit = ((in_sides & in_depth) | dir_sl[:, None, :, None]) & sl_live[:, None, :, None]
        keys = torch.where(hit, short[:, None, :, None],
                           torch.full_like(hit, sentinel, dtype=torch.int64))
        keys = keys.reshape(sy * SUPER, sx * SUPER, cc)[:tiles_y, :tiles_x].reshape(ntiles, cc)
    else:
        side = m3.dot(planes[..., None, :3], pos_vs)           # (Ty, Tx, 4, L)
        in_sides = torch.all(side >= -radius, dim=2)
        in_depth = (z + radius >= z0[..., None]) & (z - radius <= z1[..., None])
        hit = ((in_sides & in_depth) | is_dir) & valid
        keys = torch.where(hit.reshape(ntiles, L), packed_key,
                           torch.full_like(packed_key, sentinel))

    skeys = torch.sort(keys, dim=-1).values[:, :k]
    counts = (keys < sentinel).sum(dim=-1).to(torch.int32)
    indices = torch.where((skeys >> id_bits) < L, skeys & id_mask,
                          torch.full_like(skeys, -1)).to(torch.int32)
    if indices.shape[1] < max_per_tile:  # fewer lights (or shortlist slots) than K
        indices = torch.nn.functional.pad(indices, (0, max_per_tile - indices.shape[1]),
                                          value=-1)
    return (indices.reshape(tiles_y, tiles_x, max_per_tile),
            torch.clamp(counts, max=k).reshape(tiles_y, tiles_x))
