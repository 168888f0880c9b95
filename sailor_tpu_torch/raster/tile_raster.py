"""Visibility-buffer raster and fused attribute resolve (counterpart of
sailor_tpu/raster/tile_raster.py).

Each TPU kernel has a wrapper that launches its CUDA kernel for a CUDA
tensor and runs its plain PyTorch twin for a CPU tensor; any other device
raises and nothing falls back:

- B1 ``rasterize_worklist`` (``_raster_kernel_worklist``): per TILE_H x 128
  tile, the tile's binned candidates over a flat work list of windows;
  ``csrc/raster.cu``.
- B7 ``rasterize_stream`` (``_raster_kernel_stream`` and
  ``_raster_kernel_stream_mxu``): B1's math over each tile's first
  ``kmax`` whole ``chunk``-aligned windows; B1's kernel in
  ``csrc/raster.cu``, over runs of 32-row groups, or of 128-row groups
  with the MXU plane form.
- B8 ``rasterize_dma`` (``_raster_kernel_dma``): each tile walks its exact
  span of ``dchunk`` windows, no cap; B1's kernel over that row span.
- B9 ``rasterize_tiles`` (``_raster_kernel``): fixed-capacity dense bins,
  one pass per call, AABB clamp optional; B1's kernel over each tile's
  slots, each slot's row read by its id from a per-triangle table.
- B2 ``resolve_worklist`` (``_resolve_kernel_worklist``) and B10
  ``resolve_stream`` (``_resolve_kernel``): fetch each pixel's winning
  attribute row and interpolate it along the pixel ray;
  ``csrc/resolve.cu`` and ``csrc/resolve_stream.cu``.

The raster twins share one merge rule, the reference's: candidates are
tested in groups (32 rows, 128 for the MXU form); within a group the max
reverse-Z wins and equal z goes to the larger id, a later group takes a
pixel only with strictly greater z. Which rows share a group is part of
each variant's walk, so each twin walks its own.

The tile height ``TILE_H`` is read from ``SAILOR_RASTER_TILE_H`` at import
(64 by default), as the reference reads it, and by every function here and
every caller at call time, so setting the module's ``TILE_H`` takes effect
at the next call. It must be a positive multiple of 8 (``check_tile_h``):
the kernels give each 8-row strip of a tile a block of its own.
"""

from __future__ import annotations

import os

import torch

from sailor_tpu_torch.core.math3d import fma
from sailor_tpu_torch.kernels import common
from sailor_tpu_torch.kernels import cuda_lib

TILE_H = int(os.environ.get("SAILOR_RASTER_TILE_H", "64"))
TILE_W = 128
CHUNK = 32  # candidate rows merged per group (the tie-break unit)
EPS = -0.05  # edge tolerance in pixels (watertightness)

#: attribute column groups (see interpolate.pack_triangle_attributes)
A_BASE = 37
A_MAT = 49
STRIP_H = 8  # pixel rows of a strip: one block of the raster kernel


def check_tile_h() -> int:
    """TILE_H as the module holds it now, or ValueError naming
    SAILOR_RASTER_TILE_H when it is not a positive multiple of 8 (the
    reference asserts the multiple of 8 at import and fails later on 0)."""
    th = TILE_H
    if isinstance(th, bool) or int(th) != th or th < STRIP_H or th % STRIP_H:
        raise ValueError(f"SAILOR_RASTER_TILE_H={th!r}: the raster tile height must be a "
                         f"positive multiple of {STRIP_H}")
    return int(th)


check_tile_h()


def strips() -> int:
    """The 8-row strips of a tile at the current TILE_H, one block each."""
    return check_tile_h() // STRIP_H


def _plane(a, b, c, px, py):
    """a*px + b*py + c as fma(a, px, b*py) + c (rounding: core.math3d)."""
    return fma(a, px, b * py) + c


def _test_rows(s, ids, px, py, zlo, zhi, clamp=True, plane=_plane):
    """Edge/depth-test (C, >=12) candidate rows against (P,) pixel centres.

    Rows: edge coeffs (9), zplane (3), with ``clamp`` the screen AABB
    (xmin, xmax, ymin, ymax) at 12:16; ids (C,) int32, -1 dead. Returns zm
    (C, P), the masked reverse-Z or -1. The AABB clamp stops sub-pixel
    slivers from covering their whole supporting line."""
    col = [s[:, i:i + 1] for i in range(16 if clamp else 12)]
    inside = ((plane(col[0], col[1], col[2], px, py) >= EPS)
              & (plane(col[3], col[4], col[5], px, py) >= EPS)
              & (plane(col[6], col[7], col[8], px, py) >= EPS))
    if clamp:
        inside &= ((px >= col[12] + EPS) & (px <= col[13] - EPS)
                   & (py >= col[14] + EPS) & (py <= col[15] - EPS))
    z = plane(col[9], col[10], col[11], px, py)
    ok = inside & (ids >= 0)[:, None] & (z > 0.0) & (z <= 1.0)
    if zlo is not None:
        ok &= (z > zlo) & (z < zhi)
    return torch.where(ok, z, torch.full_like(z, -1.0))


def _test_chunk(s, px, py, zlo, zhi):
    """_test_rows on (C, >=17) rows whose column 16 holds the float id.
    Returns (zm (C, P), ids (C,) int32)."""
    ids = s[:, 16].to(torch.int32)
    return _test_rows(s, ids, px, py, zlo, zhi), ids


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


def worklist_span(starts, counts):
    """Per tile, the rows [lo, hi) that B1 walks after the big list. Its
    work-list windows are ``chunk``-aligned and each walks its live 32-row
    groups b0..b1 around the tile's [start, end) segment, so together they
    walk floor(start / 32) * 32 .. ceil(end / 32) * 32 in order (``chunk``
    is a multiple of 32)."""
    lo = torch.div(starts, CHUNK, rounding_mode="floor") * CHUNK
    hi = torch.div(starts + counts + CHUNK - 1, CHUNK, rounding_mode="floor") * CHUNK
    return lo, hi


def rasterize_worklist_plain(rows, big_rows, starts, counts, n_big, *,
                             tiles_y: int, tiles_x: int, z_bounds=None,
                             chunk: int = 128):
    """Plain PyTorch B1: per tile, the big list, then the live 32-row
    groups of its work-list windows (``worklist_span``)."""
    dev = rows.device
    big = _rows_or_dead(big_rows, common.cdiv(int(n_big), CHUNK) * CHUNK)
    lo, hi = (x.tolist() for x in worklist_span(starts, counts))

    def tile_rows(t, px, py, zl, zh):
        def test(s):
            return _test_chunk(s, px, py, zl, zh)
        best = _walk(_empty_best(dev), big, CHUNK, test)
        return _walk(best, rows[lo[t]:hi[t]], CHUNK, test)

    return _raster_tiles_plain(tiles_y, tiles_x, z_bounds, dev, tile_rows)


#: B1's, B7's, B8's and B9's runs: each tile's walk is cut into runs of at
#: most RUN_GROUPS groups of 32 rows (B7: STREAM_RUN_ROWS rows, in groups of
#: 32 or of 128 for the MXU form; its rows are mostly neighbours' that the
#: rectangle tests reject, so its runs are longer; B8: DMA_RUN_ROWS; B9:
#: DENSE_RUN_ROWS), doubled on the device until the runs of the tiles with
#: more than one fit ``worklist_slots``, one block per (run, strip);
#: csrc/raster.cu. tests/torch_kernel_variants.py times each length.
RUN_GROUPS = 4
STREAM_RUN_ROWS = 512
DMA_RUN_ROWS = 256
DENSE_RUN_ROWS = 64


def worklist_slots(ntiles: int) -> int:
    """Scratch runs of B1, B7, B8 and B9 (a partial depth and id per pixel
    of a run)."""
    return max(ntiles, 64)


def _worklist_workspace(ntiles: int, slots: int) -> int:
    """int32 words of the run kernel's workspace (csrc/raster.cu ``carve``): the run
    records (8 words each), the arrival counts and the runs' partial depth
    and id."""
    n = strips()
    return 8 * (ntiles + slots) + ntiles * n + 2 * slots * n * STRIP_H * TILE_W


def rasterize_worklist_cuda(rows, big_rows, starts, counts, n_big, *,
                            tiles_y: int, tiles_x: int, z_bounds=None,
                            chunk: int = 128):
    """B1 on the card: csrc/raster.cu, its plan and raster kernels counted
    as one launch; no host synchronisation."""
    dev = rows.device
    ntiles = tiles_y * tiles_x
    th = check_tile_h()
    H, W = tiles_y * th, tiles_x * TILE_W
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
    zlo, zhi = _bounds_for_kernel(z_bounds, H, W, dev)
    depth = torch.empty(H, W, dtype=torch.float32, device=dev)
    tid = torch.empty(H, W, dtype=torch.int32, device=dev)
    slots = worklist_slots(ntiles)
    ws = torch.empty(_worklist_workspace(ntiles, slots), dtype=torch.int32, device=dev)
    lib = cuda_lib.load()
    err = cuda_lib.launch(rows, lib.sailor_raster_worklist,
        rows.data_ptr(), ncols, big_rows.data_ptr(), big_rows.shape[0],
        n_big.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        cuda_lib.ptr(zlo), cuda_lib.ptr(zhi), depth.data_ptr(), tid.data_ptr(),
        tiles_y, tiles_x, th, RUN_GROUPS, slots, ws.data_ptr(), cuda_lib.stream_of(rows))
    cuda_lib.check(err, "sailor_raster_worklist")
    cuda_lib.count("raster_worklist")
    return depth, tid


def rasterize_worklist(setup, screen_aabb, order, starts, counts, big_ids,
                       n_big, *, tiles_y: int, tiles_x: int, z_bounds=None,
                       chunk: int = 128, prebuilt=None):
    """Raster from bin_sorted's ragged bins over the work-list windows.

    Returns (depth (H, W) f32 reverse-Z, tid (H, W) int32 table row or -1,
    overflow=0) with H, W padded to whole tiles."""
    check_tile_h()
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
# B7, B8, B9: the raster variants. Each twin lists, per tile, the candidate
# rows of its variant's walk in walk order and merges them group by group.
# --------------------------------------------------------------------------

CHUNK_MXU = 128  # candidates per group of B7's MXU form
MXU_STRIP = 8    # pixel rows per strip of the MXU form (the TPU's VMEM bound)
_TWIN_ROWS = 512  # candidate rows a twin tests at once (bounds its memory)


def _merge_groups(best_z, best_id, zm, ids):
    """Merge G consecutive groups (zm (G, C, P), ids (G, C)) into the
    running winners: within a group the max z wins and equal z goes to the
    larger id; merging the groups one by one with strictly greater z keeps,
    per pixel, the first group that reaches the maximum, and only if it
    beats the running best."""
    k_z = zm.amax(dim=1)
    k_id = torch.where(zm == k_z[:, None], ids[:, :, None],
                       torch.full_like(zm, -1, dtype=torch.int32)).amax(dim=1)
    m = k_z.amax(dim=0)
    g = torch.arange(k_z.shape[0], device=zm.device)[:, None]
    first = torch.where(k_z == m[None], g, torch.full_like(g, k_z.shape[0])).amin(dim=0)
    pick = k_id.gather(0, first[None]).squeeze(0)
    take = m > best_z
    return torch.where(take, m, best_z), torch.where(take, pick, best_id)


def _walk(best, rows, group, test):
    """Merge ``rows`` (N, cols), N a multiple of ``group``, into ``best`` in
    consecutive groups of ``group`` rows; ``test(s) -> (zm, ids)``."""
    step = max(group, _TWIN_ROWS // group * group)
    for i in range(0, rows.shape[0], step):
        zm, ids = test(rows[i:i + step])
        g = zm.shape[0] // group
        best = _merge_groups(*best, zm.reshape(g, group, -1), ids.reshape(g, group))
    return best


def _rows_or_dead(rows, n):
    """The first n rows of ``rows``, padded with dead rows (id -1) to n."""
    if rows.shape[0] >= n:
        return rows[:n]
    dead = torch.zeros(n - rows.shape[0], rows.shape[1], dtype=rows.dtype,
                       device=rows.device)
    dead[:, 16] = -1.0
    return torch.cat([rows, dead])


def _empty_best(dev):
    return (torch.zeros(TILE_H * TILE_W, dtype=torch.float32, device=dev),
            torch.full((TILE_H * TILE_W,), -1, dtype=torch.int32, device=dev))


def _raster_tiles_plain(tiles_y, tiles_x, z_bounds, dev, tile_rows):
    """Run ``tile_rows(t, px, py, zl, zh) -> (depth, tid)`` per tile and
    assemble the (H, W) outputs."""
    th = check_tile_h()
    H, W = tiles_y * th, tiles_x * TILE_W
    zlo = zhi = None
    if z_bounds is not None:
        zlo, zhi = _pad_bounds(z_bounds, H, W)
    depth = torch.zeros(H, W, dtype=torch.float32, device=dev)
    tid = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    for t in range(tiles_y * tiles_x):
        ti, tj = divmod(t, tiles_x)
        win = (slice(ti * th, (ti + 1) * th), slice(tj * TILE_W, (tj + 1) * TILE_W))
        px, py = _tile_pixels(t, tiles_x, dev)
        zl = zlo[win].reshape(-1) if zlo is not None else None
        zh = zhi[win].reshape(-1) if zhi is not None else None
        d, i = tile_rows(t, px, py, zl, zh)
        depth[win] = d.reshape(th, TILE_W)
        tid[win] = i.reshape(th, TILE_W)
    return depth, tid


def _bounds_for_kernel(z_bounds, H, W, dev):
    if z_bounds is None:
        return None, None
    zlo, zhi = _pad_bounds(z_bounds, H, W)
    cuda_lib.require(zlo, "zlo", torch.float32, (H, W), dev)
    cuda_lib.require(zhi, "zhi", torch.float32, (H, W), dev)
    return zlo, zhi


def _raster_window_checks(rows, big_rows, chunk, group):
    ncols = rows.shape[1]
    if ncols < 17 or big_rows.shape[1] != ncols:
        raise ValueError("rows and big_rows need the same >= 17 columns")
    if chunk % group or rows.shape[0] % chunk:
        raise ValueError(f"windows of {chunk} rows must hold whole groups of "
                         f"{group} and tile the rows")


def _mxu_plane(ox, oy):
    """The MXU form's plane: the constant re-centred on the tile origin,
    c_t = c + a*ox + b*oy, then a dot of [a, b, c_t] with the tile-local
    [dx, dy, 1] (rounding: core.math3d, as the reference's CPU build)."""
    def plane(a, b, c, px, py):
        o_x, o_y = (torch.full_like(c, o) for o in (ox, oy))
        ct = fma(b, o_y, fma(a, o_x, c))
        return fma(b, py - oy, a * (px - ox)) + ct
    return plane


def _test_chunk_mxu(ox, oy):
    plane = _mxu_plane(ox, oy)

    def test(s, px, py, zlo, zhi):
        ids = s[:, 16].to(torch.int32)
        return _test_rows(s, ids, px, py, zlo, zhi, plane=plane), ids
    return test


def stream_windows(starts, counts, chunk: int, kmax: int):
    """B7's windows: per tile the first window c0 and the count spt of
    chunk-aligned windows walked (>= 1, at most kmax), and the candidates
    the kmax cap leaves out (the reference's overflow)."""
    starts = starts.to(torch.int32)
    ends = starts + counts.to(torch.int32)
    c0 = torch.div(starts, chunk, rounding_mode="floor")
    c1 = torch.maximum(torch.div(ends + chunk - 1, chunk, rounding_mode="floor"), c0 + 1)
    spt = torch.clamp(c1 - c0, max=kmax)
    overflow = torch.clamp(ends - (c0 + kmax) * chunk, min=0).sum().to(torch.int32)
    return c0.contiguous(), spt.contiguous(), overflow


def rasterize_stream_plain(rows, big_rows, c0, spt, n_big, *, tiles_y: int,
                           tiles_x: int, z_bounds=None, chunk: int = 256,
                           mxu: bool = False):
    """Plain PyTorch B7: per tile, the big list, then the whole windows
    c0 .. c0 + max(spt, 1) - 1 (rows of neighbouring tiles included, which
    the AABB clamp rejects), in groups of 32 rows, or of 128 with the MXU
    plane form."""
    dev = rows.device
    group = CHUNK_MXU if mxu else CHUNK
    big = _rows_or_dead(big_rows, common.cdiv(int(n_big), group) * group)
    c0l, sptl = c0.tolist(), spt.tolist()

    def tile_rows(t, px, py, zl, zh):
        ti, tj = divmod(t, tiles_x)
        chunk_test = (_test_chunk_mxu(float(tj * TILE_W), float(ti * TILE_H))
                      if mxu else _test_chunk)

        def test(s):
            return chunk_test(s, px, py, zl, zh)
        best = _walk(_empty_best(dev), big, group, test)
        win = rows[c0l[t] * chunk:(c0l[t] + max(sptl[t], 1)) * chunk]
        return _walk(best, win, group, test)

    return _raster_tiles_plain(tiles_y, tiles_x, z_bounds, dev, tile_rows)


def rasterize_stream_cuda(rows, big_rows, c0, spt, n_big, *, tiles_y: int,
                          tiles_x: int, z_bounds=None, chunk: int = 256,
                          mxu: bool = False):
    """B7 on the card: B1's plan and raster kernels (csrc/raster.cu) over
    each tile's windows, counted as one launch; no host synchronisation."""
    dev = rows.device
    ntiles = tiles_y * tiles_x
    th = check_tile_h()
    H, W = tiles_y * th, tiles_x * TILE_W
    _raster_window_checks(rows, big_rows, chunk, CHUNK_MXU if mxu else CHUNK)
    cuda_lib.require(rows, "rows", torch.float32)
    cuda_lib.require(big_rows, "big_rows", torch.float32, device=dev)
    cuda_lib.require(c0, "c0", torch.int32, (ntiles,), dev)
    cuda_lib.require(spt, "spt", torch.int32, (ntiles,), dev)
    cuda_lib.require(n_big, "n_big", torch.int32, (), dev)
    zlo, zhi = _bounds_for_kernel(z_bounds, H, W, dev)
    depth = torch.empty(H, W, dtype=torch.float32, device=dev)
    tid = torch.empty(H, W, dtype=torch.int32, device=dev)
    slots = worklist_slots(ntiles)
    ws = torch.empty(_worklist_workspace(ntiles, slots), dtype=torch.int32, device=dev)
    lib = cuda_lib.load()
    err = cuda_lib.launch(rows, lib.sailor_raster_stream,
        rows.data_ptr(), rows.shape[1], big_rows.data_ptr(), big_rows.shape[0],
        n_big.data_ptr(), c0.data_ptr(), spt.data_ptr(), cuda_lib.ptr(zlo),
        cuda_lib.ptr(zhi), depth.data_ptr(), tid.data_ptr(), tiles_y, tiles_x, th,
        chunk, 1 if mxu else 0, STREAM_RUN_ROWS // (CHUNK_MXU if mxu else CHUNK), slots,
        ws.data_ptr(), cuda_lib.stream_of(rows))
    cuda_lib.check(err, "sailor_raster_stream")
    cuda_lib.count("raster_stream_mxu" if mxu else "raster_stream")
    return depth, tid


def rasterize_stream(setup, screen_aabb, order, starts, counts, big_ids,
                     n_big, *, tiles_y: int, tiles_x: int, z_bounds=None,
                     chunk: int = 256, kmax: int = 16, prebuilt=None,
                     mxu: bool = False):
    """Raster from bin_sorted's ragged bins over each tile's first ``kmax``
    whole ``chunk``-aligned windows (B7); ``mxu`` evaluates each plane
    re-centred on the tile origin, 128 candidates a group.

    ``prebuilt``: (rows, big_rows) from build_stream_rows, shared with the
    fused resolve. Returns (depth, tid, overflow): the candidates past the
    kmax cap are not tested, and overflow counts them."""
    check_tile_h()
    if mxu and (chunk % CHUNK_MXU or chunk < CHUNK_MXU):
        raise ValueError(f"mxu=True requires chunk % {CHUNK_MXU} == 0, got {chunk}")
    if prebuilt is not None:
        rows, big_rows = prebuilt
    else:
        rows, big_rows, _ = build_stream_rows(setup, screen_aabb, order,
                                              big_ids, attrs=None, chunk=chunk)
    c0, spt, overflow = stream_windows(starts, counts, chunk, kmax)
    fn = cuda_lib.dispatch(rows, rasterize_stream_plain, rasterize_stream_cuda)
    depth, tid = fn(rows, big_rows, c0, spt, n_big.to(torch.int32).reshape(()),
                    tiles_y=tiles_y, tiles_x=tiles_x, z_bounds=z_bounds,
                    chunk=chunk, mxu=mxu)
    return depth, tid, overflow


def dma_windows(starts, counts, dchunk: int):
    """B8's windows: per tile the first window w0 and the count nw of
    dchunk windows that cover its segment (0 for an empty tile)."""
    starts = starts.to(torch.int32)
    counts = counts.to(torch.int32)
    w0 = torch.div(starts, dchunk, rounding_mode="floor")
    nw = torch.where(counts > 0,
                     torch.div(starts + counts + dchunk - 1, dchunk, rounding_mode="floor") - w0,
                     torch.zeros_like(w0))
    return w0.contiguous(), nw.contiguous()


def rasterize_dma_plain(rows, big_rows, w0, nw, n_big, *, tiles_y: int,
                        tiles_x: int, z_bounds=None, dchunk: int = 128):
    """Plain PyTorch B8: per tile, the big list, then its whole windows
    w0 .. w0 + nw - 1 of ``dchunk`` rows, in groups of 32 rows."""
    dev = rows.device
    big = _rows_or_dead(big_rows, common.cdiv(int(n_big), CHUNK) * CHUNK)
    w0l, nwl = w0.tolist(), nw.tolist()

    def tile_rows(t, px, py, zl, zh):
        def test(s):
            return _test_chunk(s, px, py, zl, zh)
        best = _walk(_empty_best(dev), big, CHUNK, test)
        return _walk(best, rows[w0l[t] * dchunk:(w0l[t] + nwl[t]) * dchunk], CHUNK, test)

    return _raster_tiles_plain(tiles_y, tiles_x, z_bounds, dev, tile_rows)


def rasterize_dma_cuda(rows, big_rows, w0, nw, n_big, *, tiles_y: int,
                       tiles_x: int, z_bounds=None, dchunk: int = 128):
    """B8 on the card: B1's plan and raster kernels (csrc/raster.cu) over
    each tile's rows w0 * dchunk .. (w0 + nw) * dchunk, in runs of
    DMA_RUN_ROWS rows, counted as one launch; no host synchronisation."""
    dev = rows.device
    ntiles = tiles_y * tiles_x
    th = check_tile_h()
    H, W = tiles_y * th, tiles_x * TILE_W
    _raster_window_checks(rows, big_rows, dchunk, CHUNK)
    if big_rows.shape[0] % CHUNK:
        raise ValueError(f"big_rows must pad to whole groups of {CHUNK}")
    cuda_lib.require(rows, "rows", torch.float32)
    cuda_lib.require(big_rows, "big_rows", torch.float32, device=dev)
    cuda_lib.require(w0, "w0", torch.int32, (ntiles,), dev)
    cuda_lib.require(nw, "nw", torch.int32, (ntiles,), dev)
    cuda_lib.require(n_big, "n_big", torch.int32, (), dev)
    zlo, zhi = _bounds_for_kernel(z_bounds, H, W, dev)
    starts, counts = w0 * dchunk, nw * dchunk
    depth = torch.empty(H, W, dtype=torch.float32, device=dev)
    tid = torch.empty(H, W, dtype=torch.int32, device=dev)
    slots = worklist_slots(ntiles)
    ws = torch.empty(_worklist_workspace(ntiles, slots), dtype=torch.int32, device=dev)
    lib = cuda_lib.load()
    err = cuda_lib.launch(rows, lib.sailor_raster_worklist,
        rows.data_ptr(), rows.shape[1], big_rows.data_ptr(), big_rows.shape[0],
        n_big.data_ptr(), starts.data_ptr(), counts.data_ptr(), cuda_lib.ptr(zlo),
        cuda_lib.ptr(zhi), depth.data_ptr(), tid.data_ptr(), tiles_y, tiles_x, th,
        DMA_RUN_ROWS // CHUNK, slots, ws.data_ptr(), cuda_lib.stream_of(rows))
    cuda_lib.check(err, "sailor_raster_worklist")
    cuda_lib.count("raster_dma")
    return depth, tid


def rasterize_dma(setup, screen_aabb, order, starts, counts, big_ids, n_big,
                  *, tiles_y: int, tiles_x: int, z_bounds=None,
                  dchunk: int = 128):
    """Raster from bin_sorted's ragged bins, each tile walking its exact
    window span (B8). No per-tile cap: returns (depth, tid, overflow=0)."""
    check_tile_h()
    rows, big_rows, _ = build_stream_rows(setup, screen_aabb, order, big_ids,
                                          attrs=None, chunk=dchunk)
    w0, nw = dma_windows(starts, counts, dchunk)
    fn = cuda_lib.dispatch(rows, rasterize_dma_plain, rasterize_dma_cuda)
    depth, tid = fn(rows, big_rows, w0, nw, n_big.to(torch.int32).reshape(()),
                    tiles_y=tiles_y, tiles_x=tiles_x, z_bounds=z_bounds,
                    dchunk=dchunk)
    return depth, tid, torch.zeros((), dtype=torch.int32, device=rows.device)


def _dense_plane(a, b, c, px, py):
    """B9's inline plane evaluation, a*px + b*py + c, in the rounding of
    the reference's CPU build (core.math3d)."""
    return fma(a, px, b * py) + c


def dense_table(setup, screen_aabb=None):
    """B9's per-triangle table (R, 12 | 16) float32: edges and depth plane,
    with ``screen_aabb`` the AABB (the clamp applies only then). Built once
    a call; a slot's row is read by its id."""
    parts = [setup.edge.reshape(-1, 9), setup.zplane]
    if screen_aabb is not None:
        parts.append(torch.stack(screen_aabb, dim=1))
    return torch.cat(parts, dim=1).contiguous()


def rasterize_tiles_plain(table, ids, counts, *, tiles_y: int, tiles_x: int,
                          z_bounds=None):
    """Plain PyTorch B9: per tile, slots 0 .. ceil(count / 32) * 32 of its
    bin (``ids`` (Tiles * C,) int32, -1 dead), in groups of 32, each live
    slot's row gathered by its id from ``table`` (R, 12 | 16), with the AABB
    clamp when the table carries the screen AABB at 12:16."""
    dev = table.device
    cap = ids.shape[0] // (tiles_y * tiles_x)
    clamp = table.shape[1] == 16
    cl = counts.tolist()

    def tile_rows(t, px, py, zl, zh):
        i = ids[t * cap:t * cap + common.cdiv(cl[t], CHUNK) * CHUNK]

        def test(s):
            n = s[:, -1].to(torch.int32)
            return _test_rows(s[:, :-1], n, px, py, zl, zh, clamp, _dense_plane), n
        rows = table[torch.clamp(i, min=0).long()]
        return _walk(_empty_best(dev), torch.cat([rows, i[:, None].to(torch.float32)], 1),
                     CHUNK, test)

    return _raster_tiles_plain(tiles_y, tiles_x, z_bounds, dev, tile_rows)


def rasterize_tiles_cuda(table, ids, counts, *, tiles_y: int, tiles_x: int,
                         z_bounds=None):
    """B9 on the card: B1's plan and raster kernels (csrc/raster.cu) over
    each tile's slots t * C .. t * C + count, in runs of DENSE_RUN_ROWS
    rows, each slot's row read by id from the table in the kernel; counted
    as one launch, no host synchronisation."""
    dev = table.device
    ntiles = tiles_y * tiles_x
    th = check_tile_h()
    H, W = tiles_y * th, tiles_x * TILE_W
    width = table.shape[-1]
    if table.dim() != 2 or width not in (12, 16) or ids.shape[0] % ntiles:
        raise ValueError("the table needs 12 or 16 columns and the ids one bin per tile")
    cap = ids.shape[0] // ntiles
    if cap % CHUNK:
        raise ValueError(f"bin capacity must be a multiple of {CHUNK}")
    cuda_lib.require(table, "table", torch.float32)
    cuda_lib.require(ids, "ids", torch.int32, (ids.shape[0],), dev)
    cuda_lib.require(counts, "counts", torch.int32, (ntiles,), dev)
    if table.data_ptr() % 16:
        raise ValueError("table: expected 16-byte alignment")
    zlo, zhi = _bounds_for_kernel(z_bounds, H, W, dev)
    starts = torch.arange(0, ntiles * cap, cap, dtype=torch.int32, device=dev)
    depth = torch.empty(H, W, dtype=torch.float32, device=dev)
    tid = torch.empty(H, W, dtype=torch.int32, device=dev)
    slots = worklist_slots(ntiles)
    ws = torch.empty(_worklist_workspace(ntiles, slots), dtype=torch.int32, device=dev)
    lib = cuda_lib.load()
    err = cuda_lib.launch(table, lib.sailor_raster_dense,
        table.data_ptr(), width, ids.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        cuda_lib.ptr(zlo), cuda_lib.ptr(zhi), depth.data_ptr(), tid.data_ptr(), tiles_y,
        tiles_x, th, DENSE_RUN_ROWS // CHUNK, slots, ws.data_ptr(), cuda_lib.stream_of(table))
    cuda_lib.check(err, "sailor_raster_dense")
    cuda_lib.count("raster_dense")
    return depth, tid


def rasterize_tiles(setup, bins, *, tiles_y: int, tiles_x: int, counts=None,
                    z_bounds=None, screen_aabb=None, prebuilt=None):
    """Raster one pass of dense bins (B9): ``bins`` (Ty, Tx, C) candidate
    ids, -1 padded; ``counts`` (Ty, Tx) live counts (from the bins when
    omitted) end each tile's walk early. With ``screen_aabb`` the AABB
    clamp applies, without it none. ``prebuilt``: ``dense_table(setup,
    screen_aabb)``, shared by a frame's passes. Returns (depth (H, W), tid
    (H, W))."""
    check_tile_h()
    if bins.shape[-1] % CHUNK:
        raise ValueError("bin capacity must be a CHUNK multiple")
    table = prebuilt if prebuilt is not None else dense_table(setup, screen_aabb)
    if counts is None:
        counts = (bins >= 0).sum(dim=-1)
    counts = counts.reshape(-1).to(torch.int32).contiguous()
    ids = bins.reshape(-1).to(torch.int32).contiguous()
    fn = cuda_lib.dispatch(table, rasterize_tiles_plain, rasterize_tiles_cuda)
    return fn(table, ids, counts, tiles_y=tiles_y, tiles_x=tiles_x, z_bounds=z_bounds)


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


def _resolve_plain(rows, big_rows, tid, starts, ends, par, *, tiles_y: int,
                   tiles_x: int, na: int, mode: str):
    """The reference's one-hot selection, tile by tile: the big list and
    the tile's rows [starts[t], ends[t]) whose id equals the pixel's tid
    accumulate its winner row (pixels with none, tid < 0 among them, get
    all-zero planes); the emit then interpolates."""
    dev = rows.device
    th = check_tile_h()
    H, W = tiles_y * th, tiles_x * TILE_W
    n_out = n_planes(na, mode)
    st, en = starts.tolist(), ends.tolist()
    acc = torch.zeros(na, H, W, dtype=torch.float32, device=dev)
    for t in range(tiles_y * tiles_x):
        ti, tj = divmod(t, tiles_x)
        win = (slice(ti * th, (ti + 1) * th), slice(tj * TILE_W, (tj + 1) * TILE_W))
        tid_f = tid[win].reshape(-1).to(torch.float32)
        s = torch.cat([big_rows[:, :17 + na], rows[st[t]:max(en[t], st[t]), :17 + na]])
        match = ((s[:, 16:17] == tid_f[None]) & (s[:, 16:17] >= 0)).to(torch.float32)
        acc[(slice(None),) + win] = (s[:, 17:].T @ match).reshape(-1, th, TILE_W)
    a = acc.reshape(na, -1)
    ys = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    py = ys[:, None].expand(H, W).reshape(-1)
    px = xs[None, :].expand(H, W).reshape(-1)
    return [o.reshape(H, W) for o in _emit(a, par, px, py, n_out, mode)]


def resolve_worklist_plain(rows, big_rows, tid, starts, counts, par, *,
                           tiles_y: int, tiles_x: int, na: int,
                           chunk: int = 128, mode: str = "full"):
    """Plain PyTorch B2: its work-list windows select from the tile's whole
    [start, end) segment (``chunk`` changes only the walk's steps)."""
    return _resolve_plain(rows, big_rows, tid, starts, starts + counts, par,
                          tiles_y=tiles_y, tiles_x=tiles_x, na=na, mode=mode)


def resolve_worklist_cuda(rows, big_rows, tid, starts, counts, par, *,
                          tiles_y: int, tiles_x: int, na: int,
                          chunk: int = 128, mode: str = "full"):
    """B2 on the card: csrc/resolve.cu, one launch, one thread per pixel.

    Each thread finds its winner by binary search over the tile's segment
    (ids ascend there, see setup.bin_sorted) and a scan of the big list —
    the same rows the reference's one-hot selects — then emits."""
    dev = rows.device
    ntiles = tiles_y * tiles_x
    th = check_tile_h()
    H, W = tiles_y * th, tiles_x * TILE_W
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
    err = cuda_lib.launch(rows, lib.sailor_resolve_worklist,
        rows.data_ptr(), ncols, big_rows.data_ptr(), big_rows.shape[0],
        tid.data_ptr(), starts.data_ptr(), counts.data_ptr(), par.data_ptr(),
        out.data_ptr(), n_out, 1 if mode == "alpha" else 0, tiles_y, tiles_x, th,
        cuda_lib.stream_of(rows))
    cuda_lib.check(err, "sailor_resolve_worklist")
    cuda_lib.count("resolve_worklist")
    if mode == "alpha":  # the masked peel's 5-plane form, counted apart as well
        cuda_lib.count("resolve_worklist_alpha")
    return list(out.unbind(0))


def resolve_worklist(rows, big_rows, tid, starts, counts, n_big,
                     inv_vp, camera_position, *, tiles_y: int, tiles_x: int,
                     na: int, width: int, full_height: int, row0=0,
                     chunk: int = 128, mode: str = "full"):
    """Expand each pixel's winning row and interpolate. Returns the list of
    (H, W) planes in the reference's write order: full mode 13 planes for
    the 37-column rows (world position 3, normal 3, uv 2, vertex colour 4,
    material id) or 29 for 49 columns; alpha mode 5."""
    th = check_tile_h()
    H, W = tiles_y * th, tiles_x * TILE_W
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


def resolve_stream_plain(rows, big_rows, tid, starts, counts, c0, spt, par, *,
                         tiles_y: int, tiles_x: int, na: int,
                         chunk: int = 256):
    """Plain PyTorch B10: the tile's windows c0 .. c0 + max(spt, 1) - 1
    select from the rows of its [start, end) segment before them; rows past
    the kmax cap are never read. Full mode."""
    ends = torch.minimum(starts + counts, (c0 + torch.clamp(spt, min=1)) * chunk)
    return _resolve_plain(rows, big_rows, tid, starts, ends, par, tiles_y=tiles_y,
                          tiles_x=tiles_x, na=na, mode="full")


def resolve_stream_cuda(rows, big_rows, tid, starts, counts, c0, spt, par, *,
                        tiles_y: int, tiles_x: int, na: int, chunk: int = 256):
    """B10 on the card: csrc/resolve_stream.cu, one launch, one thread per
    pixel; B2's row search bounded by the tile's kmax cap."""
    dev = rows.device
    ntiles = tiles_y * tiles_x
    th = check_tile_h()
    H, W = tiles_y * th, tiles_x * TILE_W
    n_out = n_planes(na, "full")
    ncols = rows.shape[1]
    if ncols < 17 + na or big_rows.shape[1] != ncols:
        raise ValueError(f"rows need >= {17 + na} columns")
    cuda_lib.require(rows, "rows", torch.float32)
    cuda_lib.require(big_rows, "big_rows", torch.float32, device=dev)
    cuda_lib.require(tid, "tid", torch.int32, (H, W), dev)
    for name, x in (("starts", starts), ("counts", counts), ("c0", c0), ("spt", spt)):
        cuda_lib.require(x, name, torch.int32, (ntiles,), dev)
    cuda_lib.require(par, "par", torch.float32, (32,), dev)
    out = torch.empty(n_out, H, W, dtype=torch.float32, device=dev)
    lib = cuda_lib.load()
    err = cuda_lib.launch(rows, lib.sailor_resolve_stream,
        rows.data_ptr(), ncols, big_rows.data_ptr(), big_rows.shape[0],
        tid.data_ptr(), starts.data_ptr(), counts.data_ptr(), c0.data_ptr(),
        spt.data_ptr(), par.data_ptr(), out.data_ptr(), n_out, tiles_y,
        tiles_x, th, chunk, cuda_lib.stream_of(rows))
    cuda_lib.check(err, "sailor_resolve_stream")
    cuda_lib.count("resolve_stream")
    return list(out.unbind(0))


def resolve_stream(rows, big_rows, tid, starts, counts, n_big, inv_vp,
                   camera_position, *, tiles_y: int, tiles_x: int, na: int,
                   width: int, full_height: int, row0=0, chunk: int = 256,
                   kmax: int = 16):
    """The fused resolve over B7's grid-k windows (full mode): expand each
    pixel's winning row from the tile's first ``kmax`` windows and
    interpolate. Returns the planes in resolve_worklist's order."""
    th = check_tile_h()
    H, W = tiles_y * th, tiles_x * TILE_W
    if tuple(tid.shape) != (H, W):
        tid = torch.nn.functional.pad(
            tid, (0, W - tid.shape[1], 0, H - tid.shape[0]), value=-1)
    c0, spt, _ = stream_windows(starts, counts, chunk, kmax)
    par = _resolve_params(inv_vp, camera_position, width, full_height, row0,
                          rows.device)
    fn = cuda_lib.dispatch(rows, resolve_stream_plain, resolve_stream_cuda)
    return fn(rows, big_rows, tid.to(torch.int32).contiguous(),
              starts.to(torch.int32).contiguous(),
              counts.to(torch.int32).contiguous(), c0, spt, par,
              tiles_y=tiles_y, tiles_x=tiles_x, na=na, chunk=chunk)
