"""Vertex transform, triangle setup and tile binning (counterpart of
sailor_tpu/raster/setup.py).

Plain torch on whichever device the geometry lives on. The near clipper
keeps the JAX twin's static shape (two raster slots per source triangle),
so raster-triangle ids, and with them the bin order that the raster and
resolve windows index into, are the same in both packages.
"""

from __future__ import annotations

import dataclasses

import torch

from sailor_tpu_torch.core.math3d import (fma, fma_scalar, transform_point, transform_point_h,
                                           transform_vector)


@dataclasses.dataclass
class Geometry:
    """World-space scene geometry, SoA, merged over meshes/instances."""

    position: torch.Tensor     # (V, 3) world space
    normal: torch.Tensor       # (V, 3) world space
    uv: torch.Tensor           # (V, 2)
    color: torch.Tensor        # (V, 4)
    indices: torch.Tensor      # (T, 3) int32
    material_id: torch.Tensor  # (T,) int32


@dataclasses.dataclass
class TriangleSetup:
    """Per-raster-triangle screen-space data: R = 2T slots (two per source
    triangle) with the near clipper, R = T without it."""

    edge: torch.Tensor    # (R, 3, 3) E_j = A x + B y + C; inside => all >= 0
    zplane: torch.Tensor  # (R, 3) reverse-Z depth plane z = A x + B y + C
    valid: torch.Tensor   # (R,) bool live (on-screen, front-facing)
    src_id: torch.Tensor  # (R,) int32 source triangle index
    zmax: torch.Tensor    # (R,) max vertex reverse-Z


def transform_vertices(positions, normals, model, view_projection):
    """World and clip transform of one instance batch: ``positions`` and
    ``normals`` (V, 3), ``model`` (4, 4) or (I, 4, 4) for instancing.
    Returns (world_pos, world_normal, clip), with a leading instance axis
    when ``model`` is batched."""
    m = model[..., None, :, :] if model.dim() == 3 else model
    wp = transform_point(m, positions)
    return wp, transform_vector(m, normals), transform_point_h(view_projection, wp)


def _edge_coeffs(xa, ya, xb, yb):
    """Coefficients of E(x,y) = (x-xa)(yb-ya) - (y-ya)(xb-xa)."""
    a = yb - ya
    b = -(xb - xa)
    c = -fma(xa, a, ya * b)
    return a, b, c


_EPS_W = 1e-4  # near-plane clip epsilon in clip-space w


def _near_clip(clip_tri):
    """Clip (T, 3, 4) clip-space triangles against w > _EPS_W into two
    static slots (T, 2, 3, 4) + validity (T, 2); cases by inside count:
    3 -> (tri, invalid); 2 -> two clipped tris; 1 -> (clipped tri,
    invalid); 0 -> both invalid. Vertex order rotates so winding holds."""
    w = clip_tri[..., 3]
    inside = w > _EPS_W
    n_in = inside.sum(dim=-1)
    # first outside / first inside vertex (argmax of a bool picks the first)
    idx_out = torch.argmax((~inside).to(torch.uint8), dim=-1)
    idx_in = torch.argmax(inside.to(torch.uint8), dim=-1)
    rot = torch.where(n_in == 2, (idx_out + 1) % 3,
                      torch.where(n_in == 1, idx_in, torch.zeros_like(idx_in)))
    r1 = torch.cat([clip_tri[:, 1:], clip_tri[:, :1]], dim=1)
    r2 = torch.cat([clip_tri[:, 2:], clip_tri[:, :2]], dim=1)
    rc = rot[:, None, None]
    v = torch.where(rc == 0, clip_tri, torch.where(rc == 1, r1, r2))
    a, b, c = v[:, 0], v[:, 1], v[:, 2]
    wa, wb, wc = a[..., 3], b[..., 3], c[..., 3]

    def lerp_to_plane(p, q, wp, wq):
        dw = wq - wp
        t = (_EPS_W - wp) / torch.where(dw.abs() > 1e-12, dw, torch.full_like(dw, 1e-12))
        t = torch.clamp(t, 0.0, 1.0)[..., None]
        return fma(q - p, t, p)

    # the edges ab, ac and bc in one batch
    ab, ac, bc = lerp_to_plane(torch.stack([a, a, b]), torch.stack([b, c, c]),
                               torch.stack([wa, wa, wb]),
                               torch.stack([wb, wc, wc])).unbind(0)
    case2 = (n_in == 2)[:, None, None]
    case1 = (n_in == 1)[:, None, None]
    t1 = torch.where(case2, torch.stack([a, b, bc], dim=1),
                     torch.where(case1, torch.stack([a, ab, ac], dim=1),
                                 torch.stack([a, b, c], dim=1)))
    t2 = torch.stack([a, bc, ac], dim=1)
    out = torch.stack([t1, t2], dim=1)
    valid = torch.stack([n_in >= 1, n_in == 2], dim=1)
    return out, valid


def triangle_setup(geometry: Geometry, view_projection, *, width: int,
                   height: int, cull: str = "back", clip: bool = True,
                   zplane_rounding: str = "frame"):
    """Project triangles to screen space and build raster coefficients.

    Pixel (0,0) is top-left with samples at pixel centres; NDC y up, screen
    y down; reverse-Z depth in [0, 1]. Triangles crossing the near plane are
    clipped into up to two sub-triangles. Returns (TriangleSetup,
    (xmin, xmax, ymin, ymax)).

    ``clip=False`` (orthographic projections, where every w is 1, as the
    shadow cascades') skips the near clipper: one raster slot per source
    triangle (``src_id`` = arange(T)), live only if all three w exceed the
    clip epsilon.

    ``zplane_rounding``: the reference's CPU build fuses the depth plane's
    three-term sums in an order its fusion picks. Inside the frame graph's
    stream and DMA paths z1*c1 is rounded first ("frame"); where the setup
    compiles alone, as in ``raster.rasterize`` and beside the dense binning,
    z0*c0 is rounded first for the x slope and the constant ("standalone").
    The depth of every pixel follows, so the port takes the caller's.
    """
    if zplane_rounding not in ("frame", "standalone"):
        raise ValueError(f"unknown zplane_rounding {zplane_rounding!r}")
    p = geometry.position
    clip_pos = transform_point_h(view_projection, p)
    tri = geometry.indices.long()
    clip_tri = clip_pos[tri]                          # (T, 3, 4)
    src_id = torch.arange(tri.shape[0], dtype=torch.int32, device=p.device)
    if clip:
        clipped, clip_valid = _near_clip(clip_tri)
        t2 = clipped.reshape(-1, 3, 4)
        src_id = src_id.repeat_interleave(2)
        tw_ok = clip_valid.reshape(-1)
    else:
        t2 = clip_tri
        tw_ok = (clip_tri[..., 3] > _EPS_W).all(dim=-1)

    w = t2[..., 3]
    inv_w = torch.where(w > 1e-12, 1.0 / w, torch.zeros_like(w))
    ndc = t2[..., :3] * inv_w[..., None]
    u = ndc[..., 0] * 0.5 + 0.5
    v = 0.5 - ndc[..., 1] * 0.5
    tx = u * width
    ty = v * height
    tz = ndc[..., 2]

    # fused like the reference: each screen difference is one fma over the
    # other vertex's rounded product, u_i * width - u_0 * width as
    # fma(u_i, width, -(u_0 * width)), and the area fma(dx1, dy2, -dy1 * dx2);
    # so a triangle with coincident vertices keeps the rounding residue of
    # u_0 * width (or v_0 * height), as in the JAX package
    dx = fma(u[:, 1:], torch.full_like(u[:, 1:], width), -(u[:, :1] * width))
    dy = fma(v[:, 1:], torch.full_like(v[:, 1:], height), -(v[:, :1] * height))
    area2 = fma(dx[:, 0], dy[:, 1], -(dy[:, 0] * dx[:, 1]))
    if cull == "back":
        facing = area2 < 0.0
    elif cull == "front":
        facing = area2 > 0.0
    elif cull == "none":
        facing = area2.abs() > 0.0
    else:
        raise ValueError(f"unknown cull mode {cull!r}")
    one = torch.ones_like(area2)
    orient = torch.where(area2 < 0.0, one, -one)

    # edges (1, 2), (2, 0), (0, 1) in one batch: rolling the vertex axis by
    # -1 gives the first endpoints, by 1 the second
    xa, ya = torch.roll(tx, -1, 1), torch.roll(ty, -1, 1)
    xb, yb = torch.roll(tx, 1, 1), torch.roll(ty, 1, 1)
    # canonical endpoint order: a shared edge gives bit-identical E
    swap = (xa > xb) | ((xa == xb) & (ya > yb))
    a, b, c = _edge_coeffs(torch.where(swap, xb, xa), torch.where(swap, yb, ya),
                           torch.where(swap, xa, xb), torch.where(swap, ya, yb))
    s = torch.where(swap, -1.0, 1.0)
    edge = torch.stack([a * s, b * s, c * s], dim=-1) * orient[:, None, None]
    # normalise to signed pixel distance (uniform -0.05 px tolerance)
    escale = torch.rsqrt(fma(edge[..., 0], edge[..., 0], edge[..., 1] * edge[..., 1])
                         + 1e-20)
    edge = edge * escale[..., None]

    # reverse-Z depth plane via Cramer's rule
    x0, x1, x2 = tx[:, 0], tx[:, 1], tx[:, 2]
    y0, y1, y2 = ty[:, 0], ty[:, 1], ty[:, 2]
    m12 = fma(x1, y2, -(x2 * y1))
    det = fma(x0, y1 - y2, -(y0 * (x1 - x2))) + m12
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, torch.zeros_like(det))
    z0, z1, z2 = tz[:, 0], tz[:, 1], tz[:, 2]

    # za, zb, zc in one batch: z0*c0 + z1*c1 + z2*c2, contracted
    c0 = torch.stack([y1 - y2, x2 - x1, m12], dim=-1)
    c1 = torch.stack([y2 - y0, x0 - x2, fma(x2, y0, -(x0 * y2))], dim=-1)
    c2 = torch.stack([y0 - y1, x1 - x0, fma(x0, y1, -(x1 * y0))], dim=-1)
    first = fma(z0[:, None], c0, z1[:, None] * c1)
    if zplane_rounding == "standalone":
        x_and_c = torch.tensor([True, False, True], device=first.device)
        first = torch.where(x_and_c, fma(z1[:, None], c1, z0[:, None] * c0), first)
    zplane = fma(z2[:, None], c2, first) * inv_det[:, None]

    xmin = tx.amin(dim=-1)
    xmax = tx.amax(dim=-1)
    ymin = ty.amin(dim=-1)
    ymax = ty.amax(dim=-1)
    on_screen = (xmax >= 0) & (xmin < width) & (ymax >= 0) & (ymin < height)
    degenerate = area2.abs() < 1e-10
    valid = tw_ok & facing & on_screen & ~degenerate
    return TriangleSetup(
        edge=edge, zplane=zplane, valid=valid, src_id=src_id,
        zmax=torch.clamp(tz.amax(dim=-1), 0.0, 1.0),
    ), (xmin, xmax, ymin, ymax)


def shift_viewport_rows(tri: TriangleSetup, row0) -> TriangleSetup:
    """The setup re-expressed in the local rows of a viewport slice that
    starts at global row ``row0``: with y_global = y_local + row0,
    E_local(x, y') = E_global(x, y' + row0), so only the constant terms
    change (C += B * row0), for the edges and the depth plane; each as one
    fused multiply-add, as the reference's compiled shift rounds it."""
    def shifted(x):
        out = x.clone()
        out[..., 2] = fma_scalar(x[..., 1], float(row0), x[..., 2])
        return out

    return dataclasses.replace(tri, edge=shifted(tri.edge), zplane=shifted(tri.zplane))


def _tile_index(v, tile: int, n: int):
    """floor(v / tile) clipped to [0, n-1]; clamped in float first so that
    far off-screen coordinates cannot overflow the integer conversion."""
    return torch.clamp(torch.floor(v / tile), -1.0, float(n)).to(
        torch.int32).clamp(0, n - 1)


def _small_keys(valid, screen_aabb, *, tiles_x: int, tiles_y: int,
                tile_w: int, tile_h: int):
    """The sort shared by both binnings. Each small triangle (spanning <= 2x2
    tiles) emits its distinct corner tiles as keys tile * T + id; one sort
    groups them tile-major, so inside a tile's segment the ids ascend and
    appear once. Returns (order (4T,) int32 with -1 sentinels, starts,
    counts (Tiles,) int32, big (T,) bool, tile ranges (tx0, tx1, ty0, ty1))."""
    xmin, xmax, ymin, ymax = screen_aabb
    t = valid.shape[0]
    dev = valid.device
    ntiles = tiles_y * tiles_x
    tx0 = _tile_index(xmin, tile_w, tiles_x)
    tx1 = _tile_index(xmax, tile_w, tiles_x)
    ty0 = _tile_index(ymin, tile_h, tiles_y)
    ty1 = _tile_index(ymax, tile_h, tiles_y)
    small = valid & (tx1 - tx0 <= 1) & (ty1 - ty0 <= 1)
    big = valid & ~small

    tri_ids = torch.arange(t, dtype=torch.int64, device=dev)
    sentinel = ntiles * t
    keys = []
    seen = []
    for cy, cx in ((ty0, tx0), (ty0, tx1), (ty1, tx0), (ty1, tx1)):
        tile = cy.to(torch.int64) * tiles_x + cx
        dup = torch.zeros(t, dtype=torch.bool, device=dev)
        for p in seen:
            dup |= p == tile
        keys.append(torch.where(small & ~dup, tile * t + tri_ids,
                                torch.full_like(tile, sentinel)))
        seen.append(tile)
    skeys = torch.sort(torch.cat(keys)).values
    s_tile = skeys // t
    order = torch.where(s_tile < ntiles, skeys - s_tile * t,
                        torch.full_like(skeys, -1)).to(torch.int32)

    tile_ids = torch.arange(ntiles + 1, dtype=torch.int64, device=dev)
    bounds = torch.searchsorted(s_tile, tile_ids).to(torch.int32)
    starts = bounds[:-1]
    counts = bounds[1:] - starts
    return order, starts, counts, big, (tx0, tx1, ty0, ty1)


def bin_triangles(valid, screen_aabb, *, tiles_x: int, tiles_y: int, tile_w: int,
                  tile_h: int, capacity: int, slot_offset: int = 0):
    """Per-tile candidate lists by a dense overlap test: slot s of a tile
    holds the (slot_offset + s)-th valid triangle, in id order, whose
    tile range covers it. Returns (bins (Ty, Tx, C) int32 ids or -1,
    counts (Ty, Tx) int32 of the slots used, overflow: a 0-d int32 of the
    candidates past slot_offset + capacity over all tiles)."""
    xmin, xmax, ymin, ymax = screen_aabb
    dev = valid.device

    def tile(v, size, n):
        return torch.clamp(torch.floor(v / size).to(torch.int32), 0, n - 1)

    tx0, tx1 = tile(xmin, tile_w, tiles_x), tile(xmax, tile_w, tiles_x)
    ty0, ty1 = tile(ymin, tile_h, tiles_y), tile(ymax, tile_h, tiles_y)
    cy = torch.arange(tiles_y, dtype=torch.int32, device=dev)[:, None, None]
    cx = torch.arange(tiles_x, dtype=torch.int32, device=dev)[None, :, None]
    overlap = ((cy >= ty0) & (cy <= ty1) & (cx >= tx0) & (cx <= tx1) & valid.bool())
    csum = torch.cumsum(overlap.reshape(tiles_y * tiles_x, -1).to(torch.int32), -1)
    counts = csum[:, -1]
    slots = torch.arange(capacity, dtype=torch.int32, device=dev) + slot_offset
    target = (slots + 1)[None, :].expand(csum.shape[0], -1).contiguous()
    found = torch.searchsorted(csum, target).to(torch.int32)
    bins = torch.where(slots[None, :] < counts[:, None], found, torch.full_like(found, -1))
    overflow = torch.clamp(counts - (slot_offset + capacity), min=0).sum().to(torch.int32)
    used = torch.clamp(counts - slot_offset, 0, capacity).to(torch.int32)
    return bins.reshape(tiles_y, tiles_x, capacity), used.reshape(tiles_y, tiles_x), overflow


def bin_sorted(valid, screen_aabb, *, tiles_x: int, tiles_y: int,
               tile_w: int, tile_h: int, big_capacity: int = 64):
    """Ragged sort-based binning: the sorted candidate array IS the bin.

    Small triangles go to their tiles' segments (``_small_keys``); bigger
    ones to a separate compacted list that every tile tests.

    Returns (order, starts, counts, big_ids, n_big, overflow) like the JAX
    twin: order (4T,) int32 with -1 sentinels, starts/counts (Tiles,)
    int32, big_ids (big_capacity,) int32 -1 padded, n_big and overflow
    0-d int32.
    """
    dev = valid.device
    order, starts, counts, big, _ = _small_keys(
        valid, screen_aabb, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w,
        tile_h=tile_h)
    big_idx = torch.nonzero(big).flatten().to(torch.int32)
    n_big_raw = big_idx.shape[0]
    big_ids = torch.full((big_capacity,), -1, dtype=torch.int32, device=dev)
    kept = min(n_big_raw, big_capacity)
    big_ids[:kept] = big_idx[:kept]
    n_big = torch.tensor(kept, dtype=torch.int32, device=dev)
    overflow = torch.tensor(max(n_big_raw - big_capacity, 0),
                            dtype=torch.int32, device=dev)
    return order, starts, counts, big_ids, n_big, overflow


def bin_all(valid, screen_aabb, *, tiles_x: int, tiles_y: int, tile_w: int,
            tile_h: int, capacity: int, rounds: int = 1,
            big_capacity: int = 64):
    """Dense binning into fixed-capacity slot tables, for the dense raster.

    The small triangles' sorted segments (``_small_keys``) are cut into
    ``rounds`` passes of ``capacity`` slots per tile; the first
    ``big_capacity`` big triangles (ascending id) make one more pass, each
    tile listing those whose tile range covers it, live slots first.

    Returns (passes, overflow): passes a list of (bins (Ty, Tx, C) int32
    ids -1 padded, counts (Ty, Tx) int32), overflow a 0-d int32 of the
    small candidates past rounds * capacity plus the big triangles past
    big_capacity. The tables stay on the tensors' device.
    """
    t = valid.shape[0]
    dev = valid.device
    ntiles = tiles_y * tiles_x
    # the reference packs sort keys tile * t + id into int32
    if (ntiles + 1) * t >= 2**31:
        raise ValueError(
            f"bin_all: {t} raster triangles x {ntiles} tiles overflows the "
            "int32 sort key — split the scene or raster in slices")
    order, starts, counts, big, (tx0, tx1, ty0, ty1) = _small_keys(
        valid, screen_aabb, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w,
        tile_h=tile_h)
    passes = []
    slots = torch.arange(capacity, dtype=torch.int32, device=dev)
    for r in range(rounds):
        off = r * capacity
        ok = (off + slots[None, :]) < counts[:, None]
        idx = torch.where(ok, starts[:, None] + off + slots[None, :],
                          torch.zeros_like(ok, dtype=torch.int32))
        bins = torch.where(ok, order[idx.long()], torch.full_like(idx, -1))
        passes.append((bins.reshape(tiles_y, tiles_x, capacity),
                       torch.clamp(counts - off, 0, capacity).reshape(tiles_y, tiles_x)))
    overflow = torch.clamp(counts - rounds * capacity, min=0).sum().to(torch.int32)

    big_idx = torch.nonzero(big).flatten().to(torch.int32)
    n_big = big_idx.shape[0]
    big_ids = torch.full((big_capacity,), -1, dtype=torch.int32, device=dev)
    big_ids[:min(n_big, big_capacity)] = big_idx[:big_capacity]
    safe = torch.clamp(big_ids, min=0).long()
    cy = torch.arange(tiles_y, dtype=torch.int32, device=dev)[:, None, None]
    cx = torch.arange(tiles_x, dtype=torch.int32, device=dev)[None, :, None]
    ov = ((cy >= ty0[safe]) & (cy <= ty1[safe]) & (cx >= tx0[safe])
          & (cx <= tx1[safe]) & (big_ids >= 0))               # (Ty, Tx, B)
    big_bins = torch.where(ov, safe.to(torch.int32), torch.full_like(big_ids, -1))
    # live slots first, in slot order (a stable sort of the dead flags)
    perm = torch.sort((~ov).to(torch.uint8), dim=-1, stable=True).indices
    big_bins = torch.gather(big_bins, -1, perm)
    passes.append((big_bins, ov.sum(dim=-1, dtype=torch.int32)))
    overflow = overflow + max(n_big - big_capacity, 0)
    return passes, overflow.to(torch.int32)
