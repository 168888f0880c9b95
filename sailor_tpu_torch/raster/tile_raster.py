"""Visibility-buffer raster (B1) and fused attribute resolve (B2).

Counterpart of sailor_tpu/raster/tile_raster.py, work-list path only:

- ``rasterize_worklist`` replaces the Pallas kernel ``_raster_kernel_worklist``
  (with ``_test_chunk`` and ``_merge_chunk``): per 64x128 screen tile, test
  the tile's binned candidate rows and keep the max reverse-Z winner id per
  pixel. On a CUDA tensor it launches ``csrc/raster.cu``; on a CPU tensor it
  runs ``rasterize_worklist_plain``, which walks the same work list in
  Python with vectorised torch ops per window.
- ``resolve_worklist`` replaces ``_resolve_kernel_worklist`` (with
  ``_resolve_accumulate`` and ``_resolve_emit``): fetch each pixel's winning
  attribute row and interpolate it along the pixel ray. ``csrc/resolve.cu``
  on the card, ``resolve_worklist_plain`` on the CPU.

Any other device raises; nothing falls back.
"""

from __future__ import annotations

import torch

from sailor_tpu_torch.core.math3d import fma
from sailor_tpu_torch.kernels import common
from sailor_tpu_torch.kernels import cuda_lib

TILE_H = 64
TILE_W = 128
CHUNK = 32  # candidate rows merged per group (the tie-break unit)
EPS = -0.05  # edge tolerance in pixels (watertightness)

#: attribute column groups (see interpolate.pack_triangle_attributes)
A_BASE = 37
A_MAT = 49


def _plane(a, b, c, px, py):
    """a*px + b*py + c as fma(a, px, b*py) + c (rounding: core.math3d)."""
    return fma(a, px, b * py) + c


def _test_chunk(s, px, py, zlo, zhi):
    """Edge/depth-test a (C, >=17) row chunk against (P,) pixel centres.

    Rows: edge coeffs (9), zplane (3), screen AABB (xmin, xmax, ymin,
    ymax), float id (-1 dead). Returns (zm (C, P) masked reverse-Z or -1,
    ids (C,) int32). The AABB clamp stops sub-pixel slivers from covering
    their whole supporting line."""
    col = [s[:, i:i + 1] for i in range(17)]
    ids = s[:, 16].to(torch.int32)
    inside = ((_plane(col[0], col[1], col[2], px, py) >= EPS)
              & (_plane(col[3], col[4], col[5], px, py) >= EPS)
              & (_plane(col[6], col[7], col[8], px, py) >= EPS))
    inside &= ((px >= col[12] + EPS) & (px <= col[13] - EPS)
               & (py >= col[14] + EPS) & (py <= col[15] - EPS))
    z = _plane(col[9], col[10], col[11], px, py)
    ok = inside & (ids >= 0)[:, None] & (z > 0.0) & (z <= 1.0)
    if zlo is not None:
        ok &= (z > zlo) & (z < zhi)
    return torch.where(ok, z, torch.full_like(z, -1.0)), ids


def _merge_chunk(best_z, best_id, zm, ids):
    """Within a chunk the max z wins and equal z goes to the larger id; a
    later chunk takes a pixel only with strictly greater z."""
    k_z = zm.amax(dim=0)
    k_id = torch.where(zm == k_z[None], ids[:, None],
                       torch.full_like(zm, -1, dtype=torch.int32)).amax(dim=0)
    take = k_z > best_z
    return torch.where(take, k_z, best_z), torch.where(take, k_id, best_id)


def _window_worklist(starts, counts, ntiles: int, chunk: int, nw_max: int):
    """Flatten ragged per-tile window segments into per-window work arrays.

    Returns (wt, wk, wabs, b0, b1) over nw_max steps: tile id, window index
    within the tile (-1 for dead tail steps), absolute window-block index
    into the sorted rows, and the live CHUNK range [b0, b1) in the window.
    Every tile has >= 1 window, so the list is tile-major ascending."""
    dev = starts.device
    starts = starts.to(torch.int32)
    counts = counts.to(torch.int32)
    ends = starts + counts
    c0 = torch.div(starts, chunk, rounding_mode="floor")
    c1 = torch.maximum(torch.div(ends + chunk - 1, chunk, rounding_mode="floor"), c0 + 1)
    spt = c1 - c0
    off = torch.cumsum(spt, 0).to(torch.int32)
    nw = off[-1]
    w = torch.arange(nw_max, dtype=torch.int32, device=dev)
    t = torch.searchsorted(off, w, right=True).to(torch.int32)
    live = w < nw
    last = torch.full_like(t, ntiles - 1)
    t = torch.where(live, torch.clamp(t, max=ntiles - 1), last)
    base = torch.where(t > 0, off[torch.clamp(t - 1, min=0).long()],
                       torch.zeros_like(t))
    k = w - base
    wk = torch.where(live, k, torch.full_like(k, -1))
    tail = torch.clamp(spt[ntiles - 1] - 1, min=0)
    wabs = c0[t.long()] + torch.where(live, k, tail.expand_as(k))
    lo = torch.clamp(starts[t.long()] - wabs * chunk, 0, chunk)
    hi = torch.clamp(ends[t.long()] - wabs * chunk, 0, chunk)
    zero = torch.zeros_like(lo)
    b0 = torch.where(live, torch.div(lo, CHUNK, rounding_mode="floor"), zero)
    b1 = torch.where(live, torch.div(hi + CHUNK - 1, CHUNK, rounding_mode="floor"), zero)
    return t, wk, wabs, b0, b1


def build_stream_rows(setup, screen_aabb, order, big_ids, attrs=None,
                      chunk: int = 256):
    """ONE gather shared by the raster and the resolve: cols 0:17 =
    edge/zplane/aabb/id (raster), 17: = packed attributes. The id column is
    the table row index; dead slots read a sentinel row (zeros, id -1).

    Returns (rows, big_rows, n_attr_cols)."""
    ab = torch.stack(screen_aabb, dim=1)
    r_rows = setup.zplane.shape[0]
    dev = ab.device
    idcol = torch.arange(r_rows, dtype=torch.float32, device=dev)[:, None]
    cols = [setup.edge.reshape(-1, 9), setup.zplane, ab, idcol]
    if attrs is not None:
        cols.append(attrs)
    table = torch.cat(cols, dim=1)
    na = 0 if attrs is None else attrs.shape[1]
    dead_row = torch.zeros(1, 17 + na, dtype=torch.float32, device=dev)
    dead_row[0, 16] = -1.0
    table = torch.cat([table, dead_row])

    def packed_rows(idx, pad_to):
        if pad_to > idx.shape[0]:
            idx = torch.cat([idx, torch.full((pad_to - idx.shape[0],), -1,
                                             dtype=idx.dtype, device=dev)])
        return table[torch.where(idx >= 0, idx, torch.full_like(idx, r_rows)).long()]

    n = order.shape[0]
    rows = packed_rows(order, common.round_up(n, chunk) + chunk)
    bpad = max(common.round_up(big_ids.shape[0], CHUNK), CHUNK)
    big_rows = packed_rows(big_ids, bpad)
    return rows, big_rows, na


def _tile_pixels(t: int, tiles_x: int, device):
    """Pixel-centre coordinates (TILE_H*TILE_W,) of tile t, row-major."""
    ti, tj = divmod(t, tiles_x)
    iy = torch.arange(TILE_H, dtype=torch.float32, device=device)
    ix = torch.arange(TILE_W, dtype=torch.float32, device=device)
    py = (float(ti * TILE_H) + iy + 0.5)[:, None].expand(TILE_H, TILE_W)
    px = (float(tj * TILE_W) + ix + 0.5)[None, :].expand(TILE_H, TILE_W)
    return px.reshape(-1), py.reshape(-1)


def _pad_bounds(z_bounds, H, W):
    zlo, zhi = z_bounds
    if tuple(zlo.shape) != (H, W):
        zlo = torch.nn.functional.pad(zlo, (0, W - zlo.shape[1], 0, H - zlo.shape[0]))
        zhi = torch.nn.functional.pad(zhi, (0, W - zhi.shape[1], 0, H - zhi.shape[0]),
                                      value=2.0)
    return zlo.contiguous(), zhi.contiguous()


def rasterize_worklist_plain(rows, big_rows, starts, counts, n_big, *,
                             tiles_y: int, tiles_x: int, z_bounds=None,
                             chunk: int = 128):
    """Plain PyTorch B1: walk the work list window by window, in the
    kernel's order (big list at each tile's first window, then the window's
    live CHUNK groups), merging each group with _merge_chunk."""
    dev = rows.device
    H, W = tiles_y * TILE_H, tiles_x * TILE_W
    ntiles = tiles_y * tiles_x
    nw_max = ntiles + rows.shape[0] // chunk
    wt, wk, wabs, b0, b1 = (x.tolist() for x in _window_worklist(
        starts, counts, ntiles, chunk, nw_max))
    nb = common.cdiv(int(n_big), CHUNK)
    zlo = zhi = None
    if z_bounds is not None:
        zlo, zhi = _pad_bounds(z_bounds, H, W)
    depth = torch.zeros(H, W, dtype=torch.float32, device=dev)
    tid = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    best = None
    for p in range(nw_max):
        t, k = wt[p], wk[p]
        if k < 0:
            continue
        ti, tj = divmod(t, tiles_x)
        win = (slice(ti * TILE_H, (ti + 1) * TILE_H),
               slice(tj * TILE_W, (tj + 1) * TILE_W))
        if k == 0:
            px, py = _tile_pixels(t, tiles_x, dev)
            zl = zlo[win].reshape(-1) if zlo is not None else None
            zh = zhi[win].reshape(-1) if zhi is not None else None
            best = (torch.zeros(TILE_H * TILE_W, dtype=torch.float32, device=dev),
                    torch.full((TILE_H * TILE_W,), -1, dtype=torch.int32, device=dev))
            for b in range(nb):
                zm, ids = _test_chunk(big_rows[b * CHUNK:(b + 1) * CHUNK],
                                      px, py, zl, zh)
                best = _merge_chunk(*best, zm, ids)
        base = wabs[p] * chunk
        for b in range(b0[p], b1[p]):
            s = rows[base + b * CHUNK:base + (b + 1) * CHUNK]
            zm, ids = _test_chunk(s, px, py, zl, zh)
            best = _merge_chunk(*best, zm, ids)
        depth[win] = best[0].reshape(TILE_H, TILE_W)
        tid[win] = best[1].reshape(TILE_H, TILE_W)
    return depth, tid


def rasterize_worklist_cuda(rows, big_rows, starts, counts, n_big, *,
                            tiles_y: int, tiles_x: int, z_bounds=None,
                            chunk: int = 128):
    """B1 on the card: csrc/raster.cu, one launch."""
    dev = rows.device
    ntiles = tiles_y * tiles_x
    H, W = tiles_y * TILE_H, tiles_x * TILE_W
    ncols = rows.shape[1]
    if ncols < 17 or big_rows.shape[1] != ncols:
        raise ValueError("rows and big_rows need the same >= 17 columns")
    if chunk % CHUNK or rows.shape[0] % chunk or big_rows.shape[0] % CHUNK:
        raise ValueError("rows must pad to whole windows and CHUNK groups")
    cuda_lib.require(rows, "rows", torch.float32)
    cuda_lib.require(big_rows, "big_rows", torch.float32, device=dev)
    cuda_lib.require(starts, "starts", torch.int32, (ntiles,), dev)
    cuda_lib.require(counts, "counts", torch.int32, (ntiles,), dev)
    cuda_lib.require(n_big, "n_big", torch.int32, (), dev)
    zlo = zhi = None
    if z_bounds is not None:
        zlo, zhi = _pad_bounds(z_bounds, H, W)
        cuda_lib.require(zlo, "zlo", torch.float32, (H, W), dev)
        cuda_lib.require(zhi, "zhi", torch.float32, (H, W), dev)
    depth = torch.empty(H, W, dtype=torch.float32, device=dev)
    tid = torch.empty(H, W, dtype=torch.int32, device=dev)
    lib = cuda_lib.load()
    err = lib.sailor_raster_worklist(
        rows.data_ptr(), ncols, big_rows.data_ptr(), big_rows.shape[0],
        n_big.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        cuda_lib.ptr(zlo), cuda_lib.ptr(zhi), depth.data_ptr(), tid.data_ptr(),
        tiles_y, tiles_x, chunk, cuda_lib.stream_of(rows))
    cuda_lib.check(err, "sailor_raster_worklist")
    cuda_lib.LAUNCHES["raster_worklist"] += 1
    return depth, tid


def rasterize_worklist(setup, screen_aabb, order, starts, counts, big_ids,
                       n_big, *, tiles_y: int, tiles_x: int, z_bounds=None,
                       chunk: int = 128, prebuilt=None):
    """Raster from bin_sorted's ragged bins over the work-list windows.

    Returns (depth (H, W) f32 reverse-Z, tid (H, W) int32 table row or -1,
    overflow=0) with H, W padded to whole tiles."""
    if prebuilt is not None:
        rows, big_rows = prebuilt
    else:
        rows, big_rows, _ = build_stream_rows(setup, screen_aabb, order,
                                              big_ids, attrs=None, chunk=chunk)
    fn = cuda_lib.dispatch(rows, rasterize_worklist_plain, rasterize_worklist_cuda)
    depth, tid = fn(rows, big_rows, starts.to(torch.int32).contiguous(),
                    counts.to(torch.int32).contiguous(),
                    n_big.to(torch.int32).reshape(()), tiles_y=tiles_y,
                    tiles_x=tiles_x, z_bounds=z_bounds, chunk=chunk)
    return depth, tid, torch.zeros((), dtype=torch.int32, device=rows.device)


# --------------------------------------------------------------------------
# B2: fused resolve
# --------------------------------------------------------------------------

# attribute columns the "alpha" emit reads: uv0/duv1/duv2, the vertex-colour
# alpha of c0/dc1/dc2, material id, alpha cutoff
_ALPHA_UV = ((18, 20, 22), (19, 21, 23))
_ALPHA_A = (27, 31, 35)
_ALPHA_MAT, _ALPHA_CUT = 36, 48


def n_planes(na: int, mode: str) -> int:
    if mode == "alpha":
        if na < A_MAT:
            raise ValueError("mode='alpha' needs the 49-column material rows")
        return 5
    if mode != "full":
        raise ValueError(f"unknown resolve mode {mode!r}")
    return 29 if na >= A_MAT else 13


def _resolve_params(inv_vp, camera_position, width, full_height, row0, dev):
    """[0:16] inv_vp row-major, [16:19] camera, [19] 1/width,
    [20] 1/full_height, [21] row0 (float32, like the kernel's par block)."""
    par = torch.zeros(32, dtype=torch.float32, device=dev)
    par[0:16] = inv_vp.to(torch.float32).reshape(16)
    par[16:19] = camera_position.to(torch.float32)
    par[19] = torch.tensor(1.0 / width, dtype=torch.float32)
    par[20] = torch.tensor(1.0 / full_height, dtype=torch.float32)
    par[21] = float(row0)
    return par


def _emit(a, par, px, py, n_out, mode):
    """Interpolate the winner rows ``a`` (A, P) at pixel centres (P,) —
    the plain twin of the kernel's emit (rounding: core.math3d)."""
    p = [par[i] for i in range(22)]
    ndc_x = px * p[19] * 2.0 - 1.0
    ndc_y = 1.0 - (py + p[21]) * p[20] * 2.0

    def mv(r):
        return fma(p[4 * r], ndc_x, p[4 * r + 1] * ndc_y) + (p[4 * r + 2] * 0.5 + p[4 * r + 3])

    inv_w = 1.0 / mv(3)
    cx, cy, cz = p[16], p[17], p[18]
    dx = fma(mv(0), inv_w, -cx)
    dy = fma(mv(1), inv_w, -cy)
    dz = fma(mv(2), inv_w, -cz)
    v0x, v0y, v0z = a[0], a[1], a[2]
    e1x, e1y, e1z = a[3], a[4], a[5]
    e2x, e2y, e2z = a[6], a[7], a[8]

    def det2(x0, y0, x1, y1):  # x0*y0 - x1*y1
        return fma(x0, y0, -(x1 * y1))

    def dot3(x0, y0, x1, y1, x2, y2):  # x0*y0 + x1*y1 + x2*y2
        return fma(x2, y2, fma(x0, y0, x1 * y1))

    pvx = det2(dy, e2z, dz, e2y)
    pvy = det2(dz, e2x, dx, e2z)
    pvz = det2(dx, e2y, dy, e2x)
    det = dot3(e1x, pvx, e1y, pvy, e1z, pvz)
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, torch.zeros_like(det))
    tvx = cx - v0x
    tvy = cy - v0y
    tvz = cz - v0z
    u = dot3(tvx, pvx, tvy, pvy, tvz, pvz) * inv_det
    qvx = det2(tvy, e1z, tvz, e1y)
    qvy = det2(tvz, e1x, tvx, e1z)
    qvz = det2(tvx, e1y, tvy, e1x)
    v = dot3(dx, qvx, dy, qvy, dz, qvz) * inv_det
    u = torch.clamp(u, 0.0, 1.0)
    v = torch.minimum(torch.clamp(v, min=0.0), 1.0 - u)

    def lerp3(r0, r1, r2):  # r0 + r1*u + r2*v
        return fma(r2, v, fma(r1, u, r0))

    def row3(b0, b1, b2):
        return lerp3(a[b0], a[b1], a[b2])

    if mode == "alpha":
        return [row3(*_ALPHA_UV[0]), row3(*_ALPHA_UV[1]), row3(*_ALPHA_A),
                a[_ALPHA_MAT], a[_ALPHA_CUT]]
    out = [lerp3(v0x, e1x, e2x), lerp3(v0y, e1y, e2y), lerp3(v0z, e1z, e2z)]
    out += [row3(9 + c, 12 + c, 15 + c) for c in range(3)]     # normal
    out += [row3(18 + c, 20 + c, 22 + c) for c in range(2)]    # uv
    out += [row3(24 + c, 28 + c, 32 + c) for c in range(4)]    # vertex colour
    out.append(a[36])                                          # material id
    if n_out == 29:
        out += [a[37 + c] for c in range(3)]                   # albedo
        out += [a[40], a[41]]                                  # metallic, roughness
        out += [a[42 + c] for c in range(3)]                   # emissive
        out += [a[45], a[46]]                                  # texture layers
        duv1y, duv2y = a[21], a[23]
        out += [det2(e1x, duv2y, e2x, duv1y), det2(e1y, duv2y, e2y, duv1y),
                det2(e1z, duv2y, e2z, duv1y)]                  # tangent seed
        out.append(det2(a[20], a[23], a[22], a[21]))           # uv determinant
        out += [a[48], a[47]]                                  # cutoff, opacity
    return out


def resolve_worklist_plain(rows, big_rows, tid, starts, counts, par, *,
                           tiles_y: int, tiles_x: int, na: int,
                           chunk: int = 128, mode: str = "full"):
    """Plain PyTorch B2: per work-list window, the one-hot selection of the
    reference (row id == pixel tid, restricted to the tile's own
    [start, end) segment; the big list unrestricted) accumulates each
    pixel's winner row; the emit then interpolates. Pixels with no match
    (tid < 0) get all-zero planes."""
    dev = rows.device
    H, W = tiles_y * TILE_H, tiles_x * TILE_W
    ntiles = tiles_y * tiles_x
    n_out = n_planes(na, mode)
    nw_max = ntiles + rows.shape[0] // chunk
    wt, wk, wabs, _, _ = (x.tolist() for x in _window_worklist(
        starts, counts, ntiles, chunk, nw_max))
    st, en = starts.tolist(), (starts + counts).tolist()
    acc = torch.zeros(na, H, W, dtype=torch.float32, device=dev)

    def accumulate(s, ids_ok, tid_f, win):
        match = ((s[:, 16:17] == tid_f[None]) & ids_ok[:, None]).to(torch.float32)
        acc[(slice(None),) + win] += (s[:, 17:].T @ match).reshape(-1, TILE_H, TILE_W)

    for p in range(nw_max):
        t, k = wt[p], wk[p]
        if k < 0:
            continue
        ti, tj = divmod(t, tiles_x)
        win = (slice(ti * TILE_H, (ti + 1) * TILE_H),
               slice(tj * TILE_W, (tj + 1) * TILE_W))
        tid_f = tid[win].reshape(-1).to(torch.float32)
        if k == 0:
            accumulate(big_rows[:, :17 + na], big_rows[:, 16] >= 0, tid_f, win)
        lo, hi = wabs[p] * chunk, wabs[p] * chunk + chunk
        if min(en[t], hi) > max(st[t], lo):
            ridx = torch.arange(lo, hi, device=dev)
            ok = (rows[lo:hi, 16] >= 0) & (ridx >= st[t]) & (ridx < en[t])
            accumulate(rows[lo:hi, :17 + na], ok, tid_f, win)
    a = acc.reshape(na, -1)
    ys = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    py = ys[:, None].expand(H, W).reshape(-1)
    px = xs[None, :].expand(H, W).reshape(-1)
    return [o.reshape(H, W) for o in _emit(a, par, px, py, n_out, mode)]


def resolve_worklist_cuda(rows, big_rows, tid, starts, counts, par, *,
                          tiles_y: int, tiles_x: int, na: int,
                          chunk: int = 128, mode: str = "full"):
    """B2 on the card: csrc/resolve.cu, one launch, one thread per pixel.

    Each thread finds its winner by binary search over the tile's segment
    (ids ascend there, see setup.bin_sorted) and a scan of the big list —
    the same rows the reference's one-hot selects — then emits."""
    dev = rows.device
    ntiles = tiles_y * tiles_x
    H, W = tiles_y * TILE_H, tiles_x * TILE_W
    n_out = n_planes(na, mode)
    ncols = rows.shape[1]
    if ncols < 17 + na or big_rows.shape[1] != ncols:
        raise ValueError(f"rows need >= {17 + na} columns")
    cuda_lib.require(rows, "rows", torch.float32)
    cuda_lib.require(big_rows, "big_rows", torch.float32, device=dev)
    cuda_lib.require(tid, "tid", torch.int32, (H, W), dev)
    cuda_lib.require(starts, "starts", torch.int32, (ntiles,), dev)
    cuda_lib.require(counts, "counts", torch.int32, (ntiles,), dev)
    cuda_lib.require(par, "par", torch.float32, (32,), dev)
    out = torch.empty(n_out, H, W, dtype=torch.float32, device=dev)
    lib = cuda_lib.load()
    err = lib.sailor_resolve_worklist(
        rows.data_ptr(), ncols, big_rows.data_ptr(), big_rows.shape[0],
        tid.data_ptr(), starts.data_ptr(), counts.data_ptr(), par.data_ptr(),
        out.data_ptr(), n_out, 1 if mode == "alpha" else 0, tiles_y, tiles_x,
        cuda_lib.stream_of(rows))
    cuda_lib.check(err, "sailor_resolve_worklist")
    cuda_lib.LAUNCHES["resolve_worklist"] += 1
    return list(out.unbind(0))


def resolve_worklist(rows, big_rows, tid, starts, counts, n_big,
                     inv_vp, camera_position, *, tiles_y: int, tiles_x: int,
                     na: int, width: int, full_height: int, row0=0,
                     chunk: int = 128, mode: str = "full"):
    """Expand each pixel's winning row and interpolate. Returns the list of
    (H, W) planes in the reference's write order: full mode 13 planes for
    the 37-column rows (world position 3, normal 3, uv 2, vertex colour 4,
    material id) or 29 for 49 columns; alpha mode 5."""
    H, W = tiles_y * TILE_H, tiles_x * TILE_W
    if tuple(tid.shape) != (H, W):
        tid = torch.nn.functional.pad(
            tid, (0, W - tid.shape[1], 0, H - tid.shape[0]), value=-1)
    par = _resolve_params(inv_vp, camera_position, width, full_height, row0,
                          rows.device)
    fn = cuda_lib.dispatch(rows, resolve_worklist_plain, resolve_worklist_cuda)
    return fn(rows, big_rows, tid.to(torch.int32).contiguous(),
              starts.to(torch.int32).contiguous(),
              counts.to(torch.int32).contiguous(), par, tiles_y=tiles_y,
              tiles_x=tiles_x, na=na, chunk=chunk, mode=mode)
