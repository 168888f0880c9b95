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

from sailor_tpu_torch.core.math3d import fma, transform_point_h


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
    """Per-raster-triangle screen-space data (2 slots per source triangle)."""

    edge: torch.Tensor    # (2T, 3, 3) E_j = A x + B y + C; inside => all >= 0
    zplane: torch.Tensor  # (2T, 3) reverse-Z depth plane z = A x + B y + C
    valid: torch.Tensor   # (2T,) bool live (on-screen, front-facing)
    src_id: torch.Tensor  # (2T,) int32 source triangle index
    zmax: torch.Tensor    # (2T,) max vertex reverse-Z


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
                   height: int, cull: str = "back"):
    """Project triangles to screen space and build raster coefficients.

    Pixel (0,0) is top-left with samples at pixel centres; NDC y up, screen
    y down; reverse-Z depth in [0, 1]. Triangles crossing the near plane are
    clipped into up to two sub-triangles. Returns (TriangleSetup,
    (xmin, xmax, ymin, ymax)).
    """
    p = geometry.position
    clip_pos = transform_point_h(view_projection, p)
    tri = geometry.indices.long()
    clip_tri = clip_pos[tri]                          # (T, 3, 4)
    clipped, clip_valid = _near_clip(clip_tri)
    t2 = clipped.reshape(-1, 3, 4)
    src_id = torch.arange(tri.shape[0], dtype=torch.int32,
                          device=p.device).repeat_interleave(2)
    tw_ok = clip_valid.reshape(-1)

    w = t2[..., 3]
    inv_w = torch.where(w > 1e-12, 1.0 / w, torch.zeros_like(w))
    ndc = t2[..., :3] * inv_w[..., None]
    tx = (ndc[..., 0] * 0.5 + 0.5) * width
    ty = (0.5 - ndc[..., 1] * 0.5) * height
    tz = ndc[..., 2]

    # fused like the reference: an exactly degenerate triangle keeps the
    # rounding residue of the second product, as in the JAX package
    area2 = fma(tx[:, 1] - tx[:, 0], ty[:, 2] - ty[:, 0],
                -((ty[:, 1] - ty[:, 0]) * (tx[:, 2] - tx[:, 0])))
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
    zplane = fma(z2[:, None], c2, fma(z0[:, None], c0, z1[:, None] * c1)) * inv_det[:, None]

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


def _tile_index(v, tile: int, n: int):
    """floor(v / tile) clipped to [0, n-1]; clamped in float first so that
    far off-screen coordinates cannot overflow the integer conversion."""
    return torch.clamp(torch.floor(v / tile), -1.0, float(n)).to(
        torch.int32).clamp(0, n - 1)


def bin_sorted(valid, screen_aabb, *, tiles_x: int, tiles_y: int,
               tile_w: int, tile_h: int, big_capacity: int = 64):
    """Ragged sort-based binning: the sorted candidate array IS the bin.

    Each small triangle (spanning <= 2x2 tiles) emits its distinct corner
    tiles as keys tile * T + id; one sort groups them tile-major, so inside
    a tile's segment the ids ascend and appear once. Bigger triangles go to
    a separate compacted list that every tile tests.

    Returns (order, starts, counts, big_ids, n_big, overflow) like the JAX
    twin: order (4T,) int32 with -1 sentinels, starts/counts (Tiles,)
    int32, big_ids (big_capacity,) int32 -1 padded, n_big and overflow
    0-d int32.
    """
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

    big_idx = torch.nonzero(big).flatten().to(torch.int32)
    n_big_raw = big_idx.shape[0]
    big_ids = torch.full((big_capacity,), -1, dtype=torch.int32, device=dev)
    kept = min(n_big_raw, big_capacity)
    big_ids[:kept] = big_idx[:kept]
    n_big = torch.tensor(kept, dtype=torch.int32, device=dev)
    overflow = torch.tensor(max(n_big_raw - big_capacity, 0),
                            dtype=torch.int32, device=dev)
    return order, starts, counts, big_ids, n_big, overflow
