"""Plain tiled Forward+ light culling (ComputeLightCulling.shader's
semantics, as the configuration runs it): per 16x16 tile the depth bounds
widened by their own span, four side planes through the eye, a sphere
test of every light against them and the depth slab, directional lights
always in; with a coarse capacity, each 4x4-tile supertile first keeps its
``coarse_capacity`` nearest candidates. A tile keeps its K nearest hit
lights (directional first, then by distance to the camera, then id)."""

from __future__ import annotations

import torch

TILE = 16
SUPER = 4
DIRECTIONAL = 0


def linearize(depth, z_near: float, z_far: float):
    """Reverse-Z depth to positive view distance; background (0) is z_far."""
    lin = z_near * z_far / (depth * (z_far - z_near) + z_near)
    return torch.where(depth > 0.0, lin, torch.full_like(lin, z_far))


def _normalize(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def side_planes(tiles_y, tiles_x, viewport, inv_proj, scale=1):
    vw, vh = viewport
    dev, dt = inv_proj.device, inv_proj.dtype
    xs = torch.arange(tiles_x + 1, device=dev, dtype=dt) * (TILE * scale)
    ys = torch.arange(tiles_y + 1, device=dev, dtype=dt) * (TILE * scale)
    gy, gx = torch.meshgrid(1.0 - ys / vh * 2.0, xs / vw * 2.0 - 1.0, indexing="ij")
    corners = torch.stack([gx, gy, torch.full_like(gx, 0.5), torch.ones_like(gx)], -1)
    v = corners @ inv_proj.T
    rays = v[..., :3] / v[..., 3:4]
    tl, tr = rays[:-1, :-1], rays[:-1, 1:]
    bl, br = rays[1:, :-1], rays[1:, 1:]
    a = torch.stack([bl, tr, tl, br], -2)
    b = torch.stack([tl, br, tr, bl], -2)
    return _normalize(torch.linalg.cross(a, b, dim=-1))


def cull(lights: dict, view, inv_proj, lin_depth, *, tiles_y, tiles_x, viewport,
         max_per_tile, coarse_capacity):
    """(indices (Ty, Tx, K) int32, -1 padded; counts (Ty, Tx)) of the
    lights dict (type, position, radius) in world space."""
    dev, dt = lin_depth.device, lin_depth.dtype
    planes = side_planes(tiles_y, tiles_x, viewport, inv_proj)
    t = lin_depth.reshape(tiles_y, TILE, tiles_x, TILE)
    zmin, zmax = t.amin(dim=(1, 3)), t.amax(dim=(1, 3))
    z0, z1 = zmin - (zmax - zmin), zmax + (zmax - zmin)
    pos = lights["position"].to(dev, dt)
    pos_vs = pos @ view[:3, :3].T + view[:3, 3]
    is_dir = lights["type"].to(dev) == DIRECTIONAL
    z = -pos_vs[:, 2]
    radius = lights["radius"].to(dev, dt)
    n = pos_vs.shape[0]
    k = min(max_per_tile, n)
    dist = torch.linalg.vector_norm(pos_vs.float(), dim=-1)
    order = torch.argsort(torch.where(is_dir, torch.full_like(dist, -1.0), dist), stable=True)
    rank = torch.argsort(order, stable=True)
    bits = max(1, (n - 1).bit_length())
    mask = (1 << bits) - 1
    sentinel = n << bits
    key = (rank.to(torch.int64) << bits) | torch.arange(n, device=dev)

    if coarse_capacity and coarse_capacity < n:
        cc = int(coarse_capacity)
        sy, sx = -(-tiles_y // SUPER), -(-tiles_x // SUPER)
        sp = side_planes(sy, sx, viewport, inv_proj, scale=SUPER)
        pad = (0, sx * SUPER - tiles_x, 0, sy * SUPER - tiles_y)
        pz0 = torch.nn.functional.pad(z0, pad, value=float("inf"))
        pz1 = torch.nn.functional.pad(z1, pad, value=float("-inf"))
        sz0 = pz0.reshape(sy, SUPER, sx, SUPER).amin(dim=(1, 3))
        sz1 = pz1.reshape(sy, SUPER, sx, SUPER).amax(dim=(1, 3))
        s_in = ((sp[..., None, :] * pos_vs).sum(-1) >= -radius).all(2)
        s_in &= (z + radius >= sz0[..., None]) & (z - radius <= sz1[..., None])
        ckeys = torch.where((s_in | is_dir).reshape(sy * sx, n), key,
                            torch.full_like(key, sentinel))
        short = torch.sort(ckeys, dim=-1).values[:, :cc].reshape(sy, sx, cc)
        sl_id, sl_live = short & mask, (short >> bits) < n
        p_sl, r_sl = pos_vs[sl_id], radius[sl_id]
        z_sl, dir_sl = z[sl_id], is_dir[sl_id]
        pp = torch.nn.functional.pad(
            planes, (0, 0, 0, 0, 0, sx * SUPER - tiles_x, 0, sy * SUPER - tiles_y))
        pp = pp.reshape(sy, SUPER, sx, SUPER, 4, 3)
        side = (pp[..., None, :] * p_sl[:, None, :, None, None]).sum(-1)
        in_sides = (side >= -r_sl[:, None, :, None, None, :]).all(4)
        zs, rs = z_sl[:, None, :, None], r_sl[:, None, :, None]
        zp0 = pz0.reshape(sy, SUPER, sx, SUPER)[..., None]
        zp1 = pz1.reshape(sy, SUPER, sx, SUPER)[..., None]
        hit = ((in_sides & (zs + rs >= zp0) & (zs - rs <= zp1)) | dir_sl[:, None, :, None]) \
            & sl_live[:, None, :, None]
        keys = torch.where(hit, short[:, None, :, None], torch.full_like(hit, sentinel,
                                                                          dtype=torch.int64))
        keys = keys.reshape(sy * SUPER, sx * SUPER, cc)[:tiles_y, :tiles_x].reshape(-1, cc)
    else:
        side = (planes[..., None, :] * pos_vs).sum(-1)
        hit = (side >= -radius).all(2) & (z + radius >= z0[..., None]) \
            & (z - radius <= z1[..., None]) | is_dir
        keys = torch.where(hit.reshape(-1, n), key, torch.full_like(key, sentinel))
    skeys = torch.sort(keys, dim=-1).values[:, :k]
    counts = (keys < sentinel).sum(-1).to(torch.int32)
    idx = torch.where((skeys >> bits) < n, skeys & mask, torch.full_like(skeys, -1)).to(
        torch.int32)
    if idx.shape[1] < max_per_tile:
        idx = torch.nn.functional.pad(idx, (0, max_per_tile - idx.shape[1]), value=-1)
    return (idx.reshape(tiles_y, tiles_x, max_per_tile),
            torch.clamp(counts, max=k).reshape(tiles_y, tiles_x))
