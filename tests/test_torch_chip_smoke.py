"""The work counts behind chip_smoke.py's bounds, checked on the CPU.

``raster_work`` counts the (pixel, candidate) pairs the raster must test
from the rows' AABB columns in closed form; here it is held, exactly, to
a brute-force count that applies the raster's own float32 AABB test to
every pixel of every tile (256x128 flagship frame, CPU path), over the
rows each raster variant walks: B1's tile segments, B7's whole windows,
B8's window spans, and B9's dense slots with and without the clamp.

``chip_smoke.stream_runs`` (``worklist_runs`` over B7's windows, in
groups of 32, or of 128 with the MXU plane form) is the plain model of
B7's mapping on the card (B1's runs of groups, merged in order, and
per-warp rectangles); here it is held bit for bit to
``rasterize_stream_plain`` in both forms, with and without z bounds, on the
frame's rows (runs of 128 rows, so that every tile splits) and on
``heavy_tile_rows`` cut into several runs of the wrapper's length.
``chip_smoke.dma_runs`` (B8: ``worklist_runs`` over each tile's window
span) is held the same way to ``rasterize_dma_plain``, and
``chip_smoke.dense_runs`` (B9: ``worklist_runs`` over each tile's bin
slots, rows read by id, the AABB open with 12 columns) to
``rasterize_tiles_plain`` on ``bin_all``'s first and big-triangle passes,
with and without the clamp; a dead slot reads no table row.

``chip_smoke.cascade_inputs`` and ``evsm_shadow_factor`` make the card's
shadow checks' inputs; here B1's twin on each cascade's inputs is held to
the shadowed frame's own ShadowMaps, and the factor to the one its
RenderScene shades with (256x128, 128x128 maps, exact).

``sweep.sweep_plain``'s ``work`` counts the (sub-block, step) pairs B5's
walk takes and the (ray, triangle) tests of rays live at their step; here
they, and the walk's t and ids, are held exactly to a numpy walk of one
sub-block at a time (a random soup of 1500 triangles, 4096 rays, some
dead). ``sweep.sweep_grid_plain``'s (B6) are held the same way to a numpy
walk over every step of the grid, with no stop.

``chip_smoke.bvh8_schedule`` is the plain model of the BVH8 kernel's
persistent warps; here, on the walks of the twin (``bvh8_walks``), it
runs every ray's rows exactly once under any warp count, refill threshold
and leaf wait, and with a warp for every 32 rays, no refill and no wait it
is the one-thread-a-ray mapping whose lane, warp and warp-branch steps the
twin's ``work`` counts.

The engine phase's helpers: ``full_frame_agreement`` (the bars of the
small full and engine frames, card against CPU) accepts and refuses at
its bars; ``timed_methods`` sums host ms and a measure's growth over an
instance's calls and restores the methods; ``content_copy`` runs in a
scratch copy of content/ and leaves the working directory as it was.

The content phases' inputs: ``flagship_glb`` read back through the
registry is the flagship scene's geometry with its material ids and maps;
``material_world_doc``, ``material_folder``, ``edit_material`` and
``edited_pixels`` make and read the hot-reload cell.
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from sailor_tpu_torch.raster import setup as rsetup
from sailor_tpu_torch.raster import tile_raster as tr
from sailor_tpu_torch.raytracing import bvh8, sweep
from sailor_tpu_torch.scenes import flagship_scene
from torch_bvh8_soups import rays, soup

W, H = 256, 128


def _brute_pairs(blocks, tiles_x, clamp=True):
    """blocks: per tile, its (C, >=17) candidate rows; without the clamp
    every pixel of the tile is tested."""
    pairs = 0
    for t, q in enumerate(blocks):
        q = q[q[:, 16] >= 0]
        px, py = tr._tile_pixels(t, tiles_x, "cpu")
        ok = ((px >= q[:, 12:13] + tr.EPS) & (px <= q[:, 13:14] - tr.EPS)
              & (py >= q[:, 14:15] + tr.EPS) & (py <= q[:, 15:16] - tr.EPS))
        pairs += int(ok.sum()) if clamp else q.shape[0] * px.numel()
    return pairs


@pytest.fixture(scope="module")
def frame_rows():
    scene = flagship_scene(W, H, 24, 10, device="cpu")
    sb, *_, tiles_y, tiles_x = chip_smoke.frame_inputs(scene, W, H)
    return sb, tiles_y, tiles_x


@pytest.mark.parametrize("source", ["tile_rows", "big_list"])
def test_raster_work_counts_aabb_pairs(frame_rows, source):
    sb, tiles_y, tiles_x = frame_rows
    rows, starts, counts = sb["rows"], sb["starts"], sb["counts"]
    ntiles = tiles_y * tiles_x
    if source == "tile_rows":
        big, n_big = sb["big_rows"], sb["n_big"]
        segments = [rows[s:s + c] for s, c in zip(starts.tolist(), counts.tolist())]
        blocks = [torch.cat([seg, big[:int(n_big)]]) for seg in segments]
        live_rows = segments + [big[:int(n_big)]]
    else:  # some live rows as a big list (and a dead row), tested at every tile
        live = rows[rows[:, 16] >= 0][:64]
        big, n_big = torch.cat([live, rows[-1:]]), torch.tensor(65)
        starts = counts = torch.zeros(ntiles, dtype=torch.int32)
        blocks, live_rows = [live] * ntiles, [live]
    cand, pairs = chip_smoke.raster_work(rows, big, starts, counts, n_big,
                                         tiles_y, tiles_x)
    assert cand == sum(int((r[:, 16] >= 0).sum()) for r in live_rows)
    expected = _brute_pairs(blocks, tiles_x)
    assert expected > 1000
    assert pairs == expected


def _walk(p, g_cluster, any_hit, grid=False):
    """B5's walk (B6's with ``grid``: every step, no stop) for one sub-block
    at a time, in numpy float32."""
    sub, cl = sweep.SUB, g_cluster.shape[2]
    e_bits, order, blk_bits, nlive, feats, tmax = (
        p[k].numpy() for k in ("e_bits", "order", "blk_bits", "nlive", "feats", "tmax"))
    g_all = g_cluster.numpy()
    nsub = sweep.RAY_BLOCK // sub
    best_t, best_i = tmax.copy(), np.full(tmax.shape, -1, np.int32)
    pairs = tests = 0
    for sb in range(feats.shape[0] // sub):
        b, rows = sb // nsub, slice(sb * sub, (sb + 1) * sub)
        f, t, idx = feats[rows], best_t[rows], best_i[rows]
        bound = t.view(np.int32).max()
        for j in range(order.shape[1] if grid else nlive[b]):
            if not grid and blk_bits[b, j] >= bound:
                break
            if e_bits[sb, j] >= bound:
                continue
            pairs += 1
            cid = order[b, j]
            g = g_all[cid]
            sides = []
            for e in range(3):
                acc = f[:, 0:1] * g[8 * e]
                for k in range(1, 6):
                    acc = acc + f[:, k:k + 1] * g[8 * e + k]
                sides.append(acc)
            s0, s1, s2 = sides
            num = ((f[:, 8:9] * g[24] + f[:, 9:10] * g[25]) + f[:, 10:11] * g[26]) + g[27]
            den = (f[:, 0:1] * g[36] + f[:, 1:2] * g[37]) + f[:, 2:3] * g[38]
            agree = (((s0 >= 0) & (s1 >= 0) & (s2 >= 0))
                     | ((s0 <= 0) & (s1 <= 0) & (s2 <= 0)))
            tval = num / np.where(den == 0, np.float32(1), den)
            ok = agree & (den != 0) & (tval > np.float32(1e-4)) & (tval < t[:, None])
            live, found = t > np.float32(1e-4), ok.any(1)
            if any_hit:
                tests += int(np.where(found, ok.argmax(1) + 1, cl)[live].sum())
                t[found], idx[found] = -1.0, 0
            else:
                tests += int(live.sum()) * cl
                tm = np.where(ok, tval, np.float32(np.inf))
                row_best = tm.min(1)
                gidx = np.where((tm == row_best[:, None]) & ok, cid * cl + np.arange(cl), -1)
                t[found], idx[found] = row_best[found], gidx.max(1)[found]
            bound = t.view(np.int32).max()
    return best_t, best_i, pairs, tests


# the sweep's (RAY_BLOCK, SUB) pairs the work counts are held at, after
# the default (under the old ids): a sub-block no power of two, and one
# smaller than a warp
ANY_HIT_PAIRS = pytest.mark.parametrize(
    "any_hit,pair", [(a, p) for p in (None, (1536, 192), (512, 16)) for a in (False, True)],
    ids=[f"{'any' if a else 'closest'}" + (f"-{p[0]}-{p[1]}" if p else "")
         for p in (None, (1536, 192), (512, 16)) for a in (False, True)])


@pytest.fixture
def at_pair(pair, monkeypatch):
    if pair is not None:
        monkeypatch.setattr(sweep, "RAY_BLOCK", pair[0])
        monkeypatch.setattr(sweep, "SUB", pair[1])
    return pair


def _sweep_inputs():
    rng = np.random.default_rng(3)
    v0 = rng.uniform(-5, 5, (1500, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-1, 1, (1500, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-1, 1, (1500, 3)).astype(np.float32)
    scene = sweep.build(v0, v1, v2, device="cpu")
    r = 2 * max(sweep.RAY_BLOCK, 2048)
    o = torch.from_numpy(rng.uniform(-8, 8, (r, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(r, 3)).astype(np.float32)),
                                      dim=1)
    active = torch.from_numpy(rng.random(r) > 0.3)
    return scene, sweep.prepare(scene, o, d, active=active)


def _check_work(t, i, work, want):
    want_t, want_i, pairs, tests = want
    np.testing.assert_array_equal(t.numpy(), want_t)
    np.testing.assert_array_equal(i.numpy(), want_i)
    assert (i >= 0).sum() > 100
    assert work == {"pairs": pairs, "tests": tests}
    # dead rays (and, for any hit, the rest of a step after its first hit)
    # are not charged: fewer tests than 256 x 256 a pair
    assert 0 < tests < pairs * sweep.SUB * sweep.CLUSTER


@ANY_HIT_PAIRS
def test_sweep_work_counts_walked_pairs_and_live_tests(at_pair, any_hit):
    scene, p = _sweep_inputs()
    work = {}
    t, i = sweep.sweep_plain(p["e_bits"], p["order"], p["blk_bits"], p["nlive"], p["feats"],
                             p["tmax"], scene.g_cluster, any_hit=any_hit, work=work)
    _check_work(t, i, work, _walk(p, scene.g_cluster, any_hit))


@ANY_HIT_PAIRS
def test_sweep_grid_work_counts_walked_pairs_and_live_tests(at_pair, any_hit):
    """B6's grid visits every step; it walks (stages and tests) the same
    live pairs as B5, which the bound charges."""
    scene, p = _sweep_inputs()
    work = {}
    t, i = sweep.sweep_grid_plain(p["e_bits"], p["order"], p["feats"], p["tmax"],
                                  scene.g_cluster, any_hit=any_hit, work=work)
    want = _walk(p, scene.g_cluster, any_hit, grid=True)
    _check_work(t, i, work, want)
    assert want[2:] == _walk(p, scene.g_cluster, any_hit)[2:]


@pytest.mark.parametrize("variant", ["stream", "dma", "dense_aabb", "dense_no_aabb"])
def test_raster_work_counts_variant_walks(frame_rows, variant):
    """The walks chip_smoke.check_variant_kernels charges each variant."""
    sb, tiles_y, tiles_x = frame_rows
    rows, big, starts, counts, n_big = (sb["rows"], sb["big_rows"], sb["starts"],
                                        sb["counts"], sb["n_big"])
    ntiles = tiles_y * tiles_x
    clamp = variant != "dense_no_aabb"
    if variant == "stream":
        c0, spt, _ = tr.stream_windows(starts, counts, 256, 2)
        first, walked = c0 * 256, torch.clamp(spt, min=1) * 256
    elif variant == "dma":
        w0, nw = tr.dma_windows(starts, counts, 128)
        first, walked = w0 * 128, nw * 128
    else:  # dense slots: each tile's segment copied into a bin of 256 slots
        cap = 256
        dense = torch.zeros(ntiles * cap, rows.shape[1])
        dense[:, 16] = -1.0
        for t, (s0, c) in enumerate(zip(starts.tolist(), counts.tolist())):
            dense[t * cap:t * cap + min(c, cap)] = rows[s0:s0 + min(c, cap)]
        rows, big, n_big = dense, rows[:0], 0
        first = torch.arange(ntiles, dtype=torch.int32) * cap
        walked = (torch.clamp(counts, max=cap) + 31) // 32 * 32
    blocks = [torch.cat([rows[f:f + w], big[:int(n_big)]])
              for f, w in zip(first.tolist(), walked.tolist())]
    cand, pairs = chip_smoke.raster_work(rows, big, first, walked, n_big, tiles_y, tiles_x,
                                         clamp=clamp)
    assert cand == (sum(int((rows[f:f + w, 16] >= 0).sum())
                        for f, w in zip(first.tolist(), walked.tolist()))
                    + int((big[:int(n_big)][:, 16] >= 0).sum()))
    expected = _brute_pairs(blocks, tiles_x, clamp)
    assert expected > 1000
    assert pairs == expected


def _stream_case(frame_rows, case):
    if case == "heavy_tile":
        rows, big, starts, counts, n_big, ty, tx = chip_smoke.heavy_tile_rows()
        chunk = chip_smoke.HEAVY_CHUNK
    else:
        sb, ty, tx = frame_rows
        rows, big, starts, counts, n_big = (sb["rows"], sb["big_rows"], sb["starts"],
                                            sb["counts"], sb["n_big"])
        chunk = 256
    c0, spt, _ = tr.stream_windows(starts, counts, chunk, 16)
    return (rows, big, c0, spt, n_big.to(torch.int32).reshape(())), chunk, ty, tx


@pytest.mark.parametrize("bounded", [False, True], ids=["no_bounds", "z_bounds"])
@pytest.mark.parametrize("case", ["frame_rows", "heavy_tile"])
@pytest.mark.parametrize("mxu", [False, True], ids=["vpu", "mxu"])
def test_stream_mapping_matches_rasterize_stream_plain(frame_rows, mxu, case, bounded):
    args, chunk, ty, tx = _stream_case(frame_rows, case)
    kw = dict(tiles_y=ty, tiles_x=tx)
    run_rows = 128 if case == "frame_rows" else tr.STREAM_RUN_ROWS
    if bounded:
        d0, t0 = tr.rasterize_stream_plain(*args, **kw, chunk=chunk, mxu=mxu)
        kw["z_bounds"] = (torch.zeros_like(d0), torch.where(t0 >= 0, d0, 2.0))
    d_p, t_p = tr.rasterize_stream_plain(*args, **kw, chunk=chunk, mxu=mxu)
    stats = {}
    d_m, t_m = chip_smoke.stream_runs(*args, **kw, chunk=chunk, mxu=mxu, run_rows=run_rows,
                                      stats=stats)
    assert int((t_p >= 0).sum()) > 100
    assert stats["runs"] > ty * tx  # a tile is split
    assert stats["run_groups"] * (tr.CHUNK_MXU if mxu else tr.CHUNK) == run_rows
    torch.testing.assert_close(t_m, t_p, rtol=0, atol=0)
    torch.testing.assert_close(d_m, d_p, rtol=0, atol=0)


def _same_raster(got, want):
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)


def _second_layer(depth, tid):
    return torch.zeros_like(depth), torch.where(tid >= 0, depth, 2.0)


@pytest.mark.parametrize("bounded", [False, True], ids=["no_bounds", "z_bounds"])
@pytest.mark.parametrize("case", ["frame_rows", "heavy_tile"])
def test_dma_mapping_matches_rasterize_dma_plain(frame_rows, case, bounded):
    """B8 on B1's kernel: the big list, then each tile's rows w0 * dchunk ..
    (w0 + nw) * dchunk, cut into runs (of 64 rows on the frame, so that
    tiles split; of the wrapper's length on the heavy tile)."""
    if case == "heavy_tile":
        rows, big, starts, counts, n_big, ty, tx = chip_smoke.heavy_tile_rows()
        dchunk, run_rows = chip_smoke.HEAVY_CHUNK, tr.DMA_RUN_ROWS
    else:
        sb, ty, tx = frame_rows
        rows, big, starts, counts, n_big = (sb["rows"], sb["big_rows"], sb["starts"],
                                            sb["counts"], sb["n_big"])
        dchunk, run_rows = 128, 64
    w0, nw = tr.dma_windows(starts, counts, dchunk)
    args = (rows, big, w0, nw, n_big.to(torch.int32).reshape(()))
    kw = dict(tiles_y=ty, tiles_x=tx, dchunk=dchunk)
    if bounded:
        kw["z_bounds"] = _second_layer(*tr.rasterize_dma_plain(*args, **kw))
    want = tr.rasterize_dma_plain(*args, **kw)
    stats = {}
    got = chip_smoke.dma_runs(*args, **kw, run_rows=run_rows, stats=stats)
    assert int((want[1] >= 0).sum()) > 100
    assert stats["runs"] > ty * tx  # a tile is split
    assert stats["run_groups"] * tr.CHUNK == run_rows
    _same_raster(got, want)


@pytest.fixture(scope="module")
def dense_frame():
    """The flagship scene at 512x256 (4x4 tiles: a triangle over more than
    2x2 of them is big) through the dense path's setup and bin_all
    (capacity 512, 2 rounds): the setup, the AABB and the passes."""
    w, h = 2 * W, 2 * H
    scene = flagship_scene(w, h, 24, 10, device="cpu")
    tri, aabb = rsetup.triangle_setup(scene.geometry, scene.frame.view_projection, width=w,
                                      height=h, zplane_rounding="standalone")
    passes, _ = rsetup.bin_all(tri.valid, aabb, tiles_x=w // tr.TILE_W, tiles_y=h // tr.TILE_H,
                               tile_w=tr.TILE_W, tile_h=tr.TILE_H, capacity=512, rounds=2)
    return tri, aabb, passes, dict(tiles_y=h // tr.TILE_H, tiles_x=w // tr.TILE_W)


def _dense_case(dense_frame, npass, clamp):
    """B9's inputs from pass ``npass``: the per-triangle table (with the
    AABB when ``clamp``), the ids and counts."""
    tri, aabb, passes, kw = dense_frame
    bins, counts = passes[npass]
    table = tr.dense_table(tri, aabb if clamp else None)
    args = (table, bins.reshape(-1).to(torch.int32).contiguous(),
            counts.reshape(-1).to(torch.int32).contiguous())
    return args, dict(kw)


@pytest.mark.parametrize("bounded", [False, True], ids=["no_bounds", "z_bounds"])
@pytest.mark.parametrize("clamp", [True, False], ids=["aabb", "no_aabb"])
@pytest.mark.parametrize("npass", [0, -1], ids=["first_pass", "big_pass"])
def test_dense_mapping_matches_rasterize_tiles_plain(dense_frame, npass, clamp, bounded):
    """B9 on B1's kernel: each tile's slots t * C .. t * C + count in runs
    of one group, each slot's row read by id (the AABB open without the
    clamp); bounded: behind the first pass's winners."""
    args, kw = _dense_case(dense_frame, npass, clamp)
    unbounded = tr.rasterize_tiles_plain(*args, **kw)
    if bounded:
        first, _ = _dense_case(dense_frame, 0, clamp)
        kw["z_bounds"] = _second_layer(*tr.rasterize_tiles_plain(*first, **kw))
    want = tr.rasterize_tiles_plain(*args, **kw)
    stats = {}
    got = chip_smoke.dense_runs(*args, **kw, run_rows=tr.CHUNK, stats=stats)
    assert int((unbounded[1] >= 0).sum()) > 1000
    assert bounded != torch.equal(want[1], unbounded[1])
    if npass == 0:
        assert stats["runs"] > kw["tiles_y"] * kw["tiles_x"]  # a tile is split
    _same_raster(got, want)


def test_open_aabb_equals_clamp_free_twin(dense_frame):
    """The AABB (-inf, +inf, -inf, +inf) that B9 stages for a 12-column
    table passes every clamp test: the clamped twin on it equals the
    clamp-free twin."""
    (table, ids, counts), kw = _dense_case(dense_frame, 0, False)
    inf = float("inf")
    open_aabb = torch.tensor([-inf, inf, -inf, inf]).expand(table.shape[0], 4)
    want = tr.rasterize_tiles_plain(table, ids, counts, **kw)
    assert int((want[1] >= 0).sum()) > 100
    _same_raster(tr.rasterize_tiles_plain(torch.cat([table, open_aabb], 1), ids, counts, **kw),
                 want)


@pytest.mark.parametrize("raster", ["twin", "mapping"])
def test_dense_dead_slot_reads_no_table_row(dense_frame, raster):
    """A table row at index -1 that would cover every pixel nearest leaves
    B9's output unchanged: a dead slot (-1) in a tile's walk reads no row."""
    (table, ids, counts), kw = _dense_case(dense_frame, 0, True)
    cap = ids.shape[0] // counts.numel()
    assert any(c % tr.CHUNK and ids[t * cap + c] < 0 for t, c in enumerate(counts.tolist()))
    poison = torch.tensor([[0.0, 0.0, 1.0] * 3 + [0.0, 0.0, 0.99, -1e4, 1e4, -1e4, 1e4]])
    fn = tr.rasterize_tiles_plain if raster == "twin" else chip_smoke.dense_runs
    want = fn(table, ids, counts, **kw)
    _same_raster(fn(torch.cat([table, poison]), ids, counts, **kw), want)



@pytest.fixture(scope="module")
def shadow_frame():
    """The shadowed frame at 256x128 (128x128 maps), with the factor its
    RenderScene shaded with and the G-buffer it came from."""
    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset, nodes

    config = dict(chip_smoke.SHADOW_HIZ_CONFIG, shadow_resolution=128)
    scene = flagship_scene(W, H, 24, 10, device="cpu")
    fg = FrameGraph(FrameGraphAsset.from_nodes(chip_smoke.SHADOW_HIZ_GRAPH,
                                               chip_smoke.SHADOW_HIZ_VALUES),
                    W, H, config, device="cpu")
    shadows = []
    real = nodes.RenderSceneNode._shadow
    mp = pytest.MonkeyPatch()
    mp.setattr(nodes.RenderSceneNode, "_shadow", staticmethod(
        lambda ctx, targets, gb: shadows.append((real(ctx, targets, gb), gb)) or shadows[-1][0]))
    try:
        targets, _ = fg.process(scene, fg.initial_state())
    finally:
        mp.undo()
    return scene, config, targets, shadows[0]


@pytest.mark.parametrize("cascade", [0, 1, 2, 3])
def test_cascade_inputs_are_the_shadow_frames(shadow_frame, cascade):
    scene, config, targets, _ = shadow_frame
    rows, big, starts, counts, n_big, tiles_y, tiles_x = chip_smoke.cascade_inputs(
        scene, cascade, config)
    d, _ = tr.rasterize_worklist_plain(rows, big, starts, counts, n_big, tiles_y=tiles_y,
                                       tiles_x=tiles_x)
    assert torch.equal(d[:128, :128], targets["ShadowMaps"][cascade])


def test_evsm_shadow_factor_is_the_shadow_frames(shadow_frame, monkeypatch):
    scene, config, _, (factor, gb) = shadow_frame
    monkeypatch.setattr(chip_smoke, "SHADOW_HIZ_CONFIG", config)
    assert torch.equal(chip_smoke.evsm_shadow_factor(scene, W, H, gb), factor)


@pytest.mark.parametrize("name", ["uv", "deep", "leaf_root"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_bvh8_schedule_model_walks_every_row(name, any_hit):
    table = torch.from_numpy(bvh8.build_table(*soup(name)))
    o, d, act = (torch.from_numpy(x) for x in rays(1000, seed=3))
    args = bvh8.ray_inputs(o, d, None, act)
    *out, work, walks = chip_smoke.bvh8_walks(table, args, any_hit)
    for got, want in zip(out, bvh8.intersect_plain(table, *args, any_hit=any_hit)):
        assert torch.equal(got, want)
    active = act.numpy()
    n = len(active)
    old = chip_smoke.bvh8_schedule(walks, active, (n + 31) // 32, 32, 0)
    for key in ("lane_steps", "warp_steps", "warp_branch_steps"):
        assert old[key] == work[key], key
    assert work["lane_steps"] == work["leaf_rows"] + work["inner_rows"] == walks[1].sum()
    for warps, refill, wait in ((4, 8, 0), (3, 1, 2), (7, 32, 1 << 30), (50, 16, 4)):
        m = chip_smoke.bvh8_schedule(walks, active, warps, refill, wait)
        assert (m["rows"] == walks[1]).all()
        assert m["lane_steps"] == work["lane_steps"]
        assert m["warp_branch_steps"] >= m["warp_steps"] >= -(-m["lane_steps"] // 32)


def test_full_frame_agreement_bars():
    """The card-versus-CPU bars of the full and engine frames: exact
    planes, Sky within 5e-5 * (1 + |ref|), Main within 1e-4 relative on
    >= 99.5% of pixels, Final within 2/255."""
    gen = torch.Generator().manual_seed(0)
    ref = {k: torch.rand(32, 64, 3, generator=gen) for k in ("Sky", "Main", "Final")}
    ref.update(Depth=torch.rand(32, 64, generator=gen), TriId=torch.arange(32 * 64).reshape(32, 64),
               ShadowMaps=torch.rand(4, 8, 8, generator=gen), HiZCulledCount=torch.tensor(3))
    ok, line = chip_smoke.full_frame_agreement(dict(ref), ref)
    assert ok and "Depth_equal=True" in line and "hiz_culled=3" in line
    for key, change, want in (
            ("TriId", lambda t: t + (t == 5), False),
            ("Sky", lambda t: t * (1 + 4e-5), True), ("Sky", lambda t: t + 2e-4, False),
            ("Main", lambda t: t.index_put((torch.tensor([0]), torch.tensor([0])),
                                           t[0, 0] * 1.01), True),
            ("Main", lambda t: t * 1.01, False),
            ("Final", lambda t: t + 1.9 / 255, True), ("Final", lambda t: t + 2.1 / 255, False)):
        got = dict(ref, **{key: change(ref[key])})
        assert chip_smoke.full_frame_agreement(got, ref)[0] == want, (key, want)


def test_timed_methods_sums_host_ms_and_restores():
    class Thing:
        def work(self, x):
            return x + 1

    t, count = Thing(), [0]

    def measure():
        count[0] += 1
        return count[0]

    with chip_smoke.timed_methods(t, ("work",), measure) as acc:
        assert t.work(1) == 2 and t.work(2) == 3
        assert acc["work"][0] >= 0.0 and acc["work"][1] == 2 and "work" in vars(t)
    assert "work" not in vars(t) and t.work(3) == 4


def test_content_copy_is_a_scratch_working_directory():
    import os

    cwd = os.getcwd()
    with chip_smoke.content_copy() as tmp:
        assert os.getcwd() == tmp and os.path.exists(os.path.join("content", "Editor.world"))
        open(os.path.join("content", "Editor.world.asset"), "w").close()
    assert os.getcwd() == cwd and not os.path.exists(tmp)


def test_night_frame_agreement_bars():
    """The night frame's card-versus-CPU bars: exact planes (LightIndices
    too), Sky within 5e-5 * (1 + |ref|) + 2e-3 * |star term|, Main within
    1e-4 relative or within the star term's allowance over 2 px on >= 99.5%
    of pixels, Final within 2/255."""
    gen = torch.Generator().manual_seed(1)
    ref = {k: torch.rand(32, 64, 3, generator=gen) for k in ("Sky", "Main", "Final")}
    ref.update(Depth=torch.rand(32, 64, generator=gen), TriId=torch.arange(32 * 64).reshape(32, 64),
               LightIndices=torch.arange(4 * 8 * 16).reshape(4, 8, 16),
               ShadowMaps=torch.rand(4, 8, 8, generator=gen), HiZCulledCount=torch.tensor(3))
    term = torch.zeros(32, 64, 3)
    term[10, 20] = 0.5  # one star
    ok, line = chip_smoke.night_frame_agreement(dict(ref), ref, term)
    assert ok and "LightIndices_equal=True" in line
    star = torch.zeros(32, 64, 1)
    star[10, 20] = 1.0
    near = torch.zeros(32, 64, 1)
    near[8:13, 18:23] = 1.0
    for key, change, want in (
            ("LightIndices", lambda t: t + (t == 7), False),
            ("Sky", lambda t: t + star * 9e-4, True), ("Sky", lambda t: t + star * 1.2e-3, False),
            ("Sky", lambda t: t + 2e-4, False),
            ("Main", lambda t: t + near * 9e-4, True), ("Main", lambda t: t * 1.01, False),
            ("Main", lambda t: t + torch.roll(near, 10, 1)[:, :, :] * (torch.arange(32) == 10)[
                :, None, None] * 9e-4, True),  # 5 px away from the star: 0.24% of the frame
            ("Main", lambda t: t + torch.roll(near, 10, 1) * 9e-4, False),  # 25 px: 1.2%
            ("Final", lambda t: t + 2.1 / 255, False)):
        got = dict(ref, **{key: change(ref[key])})
        assert chip_smoke.night_frame_agreement(got, ref, term)[0] == want, (key, want)


def test_twin_checked_holds_each_launch_and_restores(monkeypatch):
    """twin_checked runs each B1-B3 launch's twin and fails on a launch
    that disagrees; the wrappers are restored after."""
    from sailor_tpu_torch.kernels import pbr_kernel

    inner = pbr_kernel.shade_tiles_cuda
    args = [torch.zeros(2, 16), torch.zeros(1, 1, 4, dtype=torch.int32),
            torch.zeros(1, 1, dtype=torch.int32)] + [torch.rand(16, 16, k) for k in (3, 1, 1, 3, 3)]
    args = args[:3] + [args[3], args[4][..., 0], args[5][..., 0], args[6], args[7], None,
                       torch.zeros(3)]
    want = pbr_kernel.shade_tiles_plain(*args)
    monkeypatch.setattr(pbr_kernel, "shade_tiles_cuda", lambda *a: pbr_kernel.shade_tiles_plain(*a))
    record = {}
    with chip_smoke.twin_checked(record):
        assert torch.equal(pbr_kernel.shade_tiles_cuda(*args), want)
    assert record == {"shade_forward_plus": [0.0]}
    monkeypatch.setattr(pbr_kernel, "shade_tiles_cuda",
                        lambda *a: pbr_kernel.shade_tiles_plain(*a) * 1.001 + 1e-3)
    with pytest.raises(RuntimeError, match="shade_forward_plus disagrees"):
        with chip_smoke.twin_checked({}):
            pbr_kernel.shade_tiles_cuda(*args)
    assert pbr_kernel.shade_tiles_cuda is not inner  # the monkeypatched one, restored


def test_content_glb_is_the_flagship_geometry(tmp_path):
    """``flagship_glb`` holds the flagship scene's meshes: read back through
    the port's registry, its soup is the flagship scene's, object by object
    (within 1e-6: the node translation is applied by another product), and
    its material ids are the ground's 0 and 1 + i % 7."""
    from sailor_tpu_torch.assets.registry import AssetRegistry
    from sailor_tpu_torch.scenes import procedural_test_maps

    path = tmp_path / "f.glb"
    path.write_bytes(chip_smoke.flagship_glb(6, procedural_test_maps(0, 16)))
    soup, mats = AssetRegistry(str(tmp_path)).load(str(path))
    # the loader walks the scene's nodes with a stack: the last object first
    objects = chip_smoke.flagship_objects(6)
    ref = flagship_scene(64, 32, 4, 6, device="cpu").geometry
    nv = np.cumsum([0] + [len(m.positions) for m, _ in objects])
    nt = np.cumsum([0] + [len(m.indices) for m, _ in objects])
    order = range(len(objects) - 1, -1, -1)
    want_pos = np.concatenate([ref.position.numpy()[nv[i]:nv[i + 1]] for i in order])
    want_idx = np.concatenate([ref.indices.numpy()[nt[i]:nt[i + 1]] - nv[i] for i in order])
    want_mid = np.concatenate([np.full(nt[i + 1] - nt[i], 0 if i == 0 else 1 + (i - 1) % 7)
                               for i in order])
    np.testing.assert_allclose(soup["position"], want_pos, rtol=0, atol=1e-6)
    starts = np.repeat(np.cumsum([0] + [nv[i + 1] - nv[i] for i in order])[:-1],
                       [nt[i + 1] - nt[i] for i in order])
    np.testing.assert_array_equal(soup["indices"] - starts[:, None], want_idx)
    np.testing.assert_array_equal(soup["material_id"], want_mid)
    assert len(mats["albedo"]) == 8
    assert list(mats["albedo_texture"]) == [0, 0, 0, 0, -1, -1, -1, -1]
    assert list(mats["normal_texture"]) == [1, 1, -1, -1, -1, -1, -1, -1]


def test_material_world_doc_and_edit(tmp_path):
    """The material world spreads its objects over the 8 .mat files, stops
    the camera when asked, and ``edit_material`` rewrites the edited
    file's albedo with a later time stamp; ``edited_pixels`` maps raster
    ids (two slots a source triangle) to the source's material."""
    import os

    doc = chip_smoke.material_world_doc(4, 10, 2.0, orbit=False)
    ids = [c["material_id"] for o in doc["gameObjects"] for c in o["components"]
           if c["typename"] == "MeshRendererComponent"]
    assert ids == [i % 8 for i in range(11)]
    assert [c["orbit_speed"] for o in doc["gameObjects"] for c in o["components"]
            if c["typename"] == "TestComponent"] == [0.0]
    paths = chip_smoke.material_folder(str(tmp_path), 16)
    assert [os.path.basename(p) for p in paths] == list(chip_smoke.MATERIAL_FILES)
    t0 = os.path.getmtime(paths[chip_smoke.EDITED])
    chip_smoke.edit_material(paths[chip_smoke.EDITED])
    assert chip_smoke.EDITED_ALBEDO[1] in open(paths[chip_smoke.EDITED]).read()
    assert os.path.getmtime(paths[chip_smoke.EDITED]) > t0

    class _World:
        class meshes:
            class geometry:
                material_id = torch.tensor([0, 2, 5])

    tid = torch.tensor([[-1, 0, 1], [2, 3, 5]])
    assert chip_smoke.edited_pixels(_World, tid, 2).tolist() == [[False, False, False],
                                                                 [True, True, False]]


# --- rehearsals of the examples, editor and host-runtime phases on the CPU ----------

_TWINS = (  # (module, wrapper, plain twin, LAUNCHES key)
    (tr, "rasterize_worklist_cuda", tr.rasterize_worklist_plain, "raster_worklist"),
    (tr, "resolve_worklist_cuda", tr.resolve_worklist_plain, "resolve_worklist"),
    (sweep, "visit_tables_cuda", sweep.visit_tables_plain, "slab_entry"),
    (sweep, "sweep_cuda", sweep.sweep_plain, "sweep"),
    (bvh8, "intersect_cuda", bvh8.intersect_plain, "bvh8_intersect"),
    (tr, "rasterize_tiles_cuda", tr.rasterize_tiles_plain, "raster_dense"),
)


@pytest.fixture
def rehearsal(monkeypatch):
    """The card's phases on the CPU: every entry point's device resolved to
    the CPU, the dispatch returning the kernel's wrapper and each of B1-B5
    and the BVH8 wrapper a plain twin that counts its launches as the
    wrapper does; torch.cuda's synchronise, memory stats and sync-debug
    mode stubbed; the examples' frame graph shades through B3 as on the
    card."""
    import importlib

    from sailor_tpu_torch.examples import render_frame
    from sailor_tpu_torch.kernels import cuda_lib, pbr_kernel

    cpu = torch.device("cpu")
    for name in ("config", "examples.render_frame", "examples.trace", "engine.world",
                 "engine.app", "framegraph.graph", "scenes", "assets.materials",
                 "raytracing.path_tracer", "raster.pipeline", "kernels.cubemap",
                 "kernels.ibl", "utils.benchmarks", "parallel.mesh"):
        mod = importlib.import_module(f"sailor_tpu_torch.{name}")
        monkeypatch.setattr(mod, "resolve_device", lambda device=None: cpu)
    monkeypatch.setattr(cuda_lib, "dispatch", lambda t, plain, kernel: kernel)

    def counting(plain, key):
        def twin(*args, **kw):
            cuda_lib.LAUNCHES[key] += 1
            if kw.get("mode") == "alpha":
                cuda_lib.LAUNCHES["resolve_worklist_alpha"] += 1
            return plain(*args, **kw)
        return twin

    for mod, wrapper, plain, key in _TWINS:
        monkeypatch.setattr(mod, wrapper, counting(plain, key))
    monkeypatch.setattr(pbr_kernel, "shade_tiles_cuda",
                        counting(pbr_kernel.shade_tiles_plain, "shade_forward_plus"))
    for name in ("synchronize", "reset_peak_memory_stats", "set_sync_debug_mode"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    frame_graph = render_frame.frame_graph

    def shaded_graph(width, height, device):
        fg = frame_graph(width, height, device)
        fg.config["pallas_shading"] = True
        return fg

    monkeypatch.setattr(render_frame, "frame_graph", shaded_graph)
    cuda_lib.LAUNCHES.clear()
    return "rehearsal"


def test_example_frame_phase_rehearsal(rehearsal, monkeypatch):
    """run_example_frame at 128x64 with 8 lights and 1 timed frame (the
    CPU trace holds aten ops, not the card's kernels: the names it must
    hold are patched) and check_small_example_frame."""
    monkeypatch.setattr(chip_smoke, "EXAMPLE_FRAME", (128, 64, 8, 1))
    monkeypatch.setattr(chip_smoke, "FRAME_KERNEL_NAMES",
                        dict.fromkeys(chip_smoke.FRAME_KERNEL_NAMES, "aten::"))
    launches = chip_smoke.run_example_frame(rehearsal)
    assert all(launches[k] >= 2 for k in chip_smoke.PATH_KERNELS)
    chip_smoke.check_small_example_frame()


def test_example_trace_phase_rehearsal(rehearsal, monkeypatch):
    """run_example_trace at 32x32 (1 spp, 2 bounces) and the card-vs-CPU
    render of the example's scene."""
    monkeypatch.setattr(chip_smoke, "EXAMPLE_TRACE", (32, 1, 2))
    monkeypatch.setattr(chip_smoke, "EXAMPLE_TRACE_SPP_CUT", 1)
    launches = chip_smoke.run_example_trace(rehearsal)
    assert launches["sweep"] == launches["slab_entry"] > 0
    chip_smoke.check_small_trace(chip_smoke.example_trace_scene, "example_trace")


def test_editor_material_edit_phase_rehearsal(rehearsal, monkeypatch):
    """run_editor_material_edit at 128x64 over material_world_doc(24, 16):
    the HTTP calls, the edit reaching a later frame, the loop stopped."""
    monkeypatch.setattr(chip_smoke, "FLAGSHIP", (128, 64, 24, 16))
    launches = chip_smoke.run_editor_material_edit(rehearsal, 128, 64, "cpu")
    assert launches["raster_worklist"] > 0 and launches["resolve_worklist"] > 0


def test_host_runtime_phase_rehearsal(rehearsal):
    launches = chip_smoke.run_host_runtime(rehearsal)
    assert launches["bvh8_intersect"] == 2  # bvh.benchmark: two tables traversed


def test_sharded_phases_rehearsal(rehearsal, monkeypatch):
    """run_sharded_frames and run_sharded_forward at 256x128 over 2 shards
    (shadow_resolution 256), run_sharded_trace at 32x32 over 4 shards (1
    spp), check_small_sharded_frame (CPU shards against CPU shards here)
    and check_image_decoders: the shards run in their threads, every
    B1-B3 and B9 launch of each shard is twin-checked, the trace equals
    trace_rays."""
    monkeypatch.setattr(chip_smoke, "SHARDED", (256, 128, 2))
    monkeypatch.setattr(chip_smoke, "SHARDED_FRAMES", 1)
    monkeypatch.setattr(chip_smoke, "SHARDED_TRACE", (32, 32, 4, 1, 2))
    monkeypatch.setattr(chip_smoke, "FULL_CONFIG",
                        dict(chip_smoke.FULL_CONFIG, shadow_resolution=256))
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
    from sailor_tpu_torch.scenes import flagship_scene

    scene = flagship_scene(256, 128, 24, 6, device="cpu")
    frames = chip_smoke.run_sharded_frames(scene, rehearsal)
    assert frames["raster_worklist"] == 2 * 3 + 2 and frames["shade_forward_plus"] == 2 * 2
    forward = chip_smoke.run_sharded_forward(scene, rehearsal)
    assert forward["raster_dense"] >= 8
    trace = chip_smoke.run_sharded_trace(rehearsal)
    assert trace["slab_entry"] == trace["sweep"] >= 12
    chip_smoke.check_small_sharded_frame()
    chip_smoke.check_image_decoders()


def test_content_jpeg_and_hiz_heavy_phases_rehearsal(rehearsal, monkeypatch):
    """run_content_jpeg at 128x64 (6 objects, 64-px JPEG maps, 1 timed
    frame) with its twin-checked frame, check_small_content_jpeg,
    run_hiz_heavy at 128x64 (40 cubes, 8 lights, 1 timed frame each way,
    256-px shadow maps) with its cull, frame comparison and twin-checked
    frames, and run_content_jpeg_trace at 32x32 (2 bounces, 1 spp)."""
    from sailor_tpu_torch.tools import time_hiz

    monkeypatch.setattr(chip_smoke, "FLAGSHIP", (128, 64, 24, 6))
    monkeypatch.setattr(chip_smoke, "JPEG_MAP_SIZE", 64)
    monkeypatch.setattr(chip_smoke, "JPEG_FRAMES", 1)
    monkeypatch.setattr(chip_smoke, "FULL_CONFIG",
                        dict(chip_smoke.FULL_CONFIG, shadow_resolution=256))
    monkeypatch.setattr(chip_smoke, "HIZ_HEAVY", (128, 64, 40, 8))
    monkeypatch.setattr(chip_smoke, "HIZ_FRAMES", 1)
    monkeypatch.setattr(time_hiz, "CONFIG", dict(time_hiz.CONFIG, shadow_resolution=256))
    monkeypatch.setattr(chip_smoke, "TRACER", (32, 32, 2, 1))
    monkeypatch.setattr(chip_smoke, "TRACER_SPP_CUT", 1)
    launches = chip_smoke.run_content_jpeg(rehearsal)
    assert all(launches[k] >= 2 for k in chip_smoke.PATH_KERNELS)
    chip_smoke.check_small_content_jpeg()
    launches = chip_smoke.run_hiz_heavy(rehearsal)
    assert all(launches[k] >= 4 for k in chip_smoke.PATH_KERNELS)
    launches = chip_smoke.run_content_jpeg_trace(rehearsal)
    assert launches["slab_entry"] == launches["sweep"] == 4 * 2 * 2 * 1


def test_content_jpeg_codings_phase_rehearsal(rehearsal, monkeypatch, capsys):
    """run_content_jpeg_codings at 128x64 (6 objects) with 64-px maps and
    32-px files held to the plain decode: the arithmetic map equal to its
    Huffman source, every file's C++ decode equal to the plain one, the
    arithmetic-albedo frame equal to the Huffman-albedo frame and its
    twin-checked frame."""
    monkeypatch.setattr(chip_smoke, "FLAGSHIP", (128, 64, 24, 6))
    monkeypatch.setattr(chip_smoke, "JPEG_MAP_SIZE", 64)
    monkeypatch.setattr(chip_smoke, "JPEG_CODINGS_SIZE", 32)
    monkeypatch.setattr(chip_smoke, "FULL_CONFIG",
                        dict(chip_smoke.FULL_CONFIG, shadow_resolution=256))
    launches = chip_smoke.run_content_jpeg_codings(rehearsal)
    assert all(launches[k] >= 1 for k in chip_smoke.PATH_KERNELS)
    out = capsys.readouterr().out
    assert out.count("equal to plain") == 9 and ": False" not in out, out
    assert re.search(r"frame vs huffman-albedo frame bit-equal \{[^}]*\}", out), out
    files = chip_smoke.jpeg_coding_files(32)
    assert set(files) == {"arith", "arith_progressive_cut", "arith_progressive", "cmyk", "ycck",
                          "lossless_p1", "lossless_p4", "lossless_p7", "dnl"}


def test_tools_phase_rehearsal(rehearsal, monkeypatch, capsys):
    """run_tools with time_hiz at 128x64 (TH_W, TH_H; the phase sets the
    cubes, lights and frames) and profile_frame --small run for real;
    time_sweep and profile_trace, which tests/test_torch_tools.py runs on
    the CPU, stubbed here to keep the rehearsal short."""
    from sailor_tpu_torch.tools import profile_trace, time_sweep

    monkeypatch.setenv("TH_W", "128")
    monkeypatch.setenv("TH_H", "64")
    for mod in (time_sweep, profile_trace):
        monkeypatch.setattr(mod, "main", lambda argv, _n=mod.__name__: print(_n, argv) or 0)
    chip_smoke.run_tools(rehearsal)
    out = capsys.readouterr().out
    assert re.search(r"hiz=1  frame [\d.]+ ms .* culled [1-9]\d*/", out), out
    assert re.search(r"hiz=0  frame [\d.]+ ms .* culled 0/", out), out
    assert re.search(r"== frames: best [\d.]+ ms", out) and "TOTAL" in out, out


def test_sweep_clusters_phase_rehearsal(rehearsal, monkeypatch, capsys):
    """run_sweep_clusters at 32x32 and clusters of 64 and 512 on the tracer
    scene with 2 spheres (4,610 triangles, so cluster size 1 still passes
    B4's shared tables): at every size the render's launches, the twins
    held to themselves, the bounds; the tool's subprocess and the two small renders, which other
    rehearsals and tests/test_torch_tools.py run, stubbed (the cluster-37
    scene is built)."""
    import subprocess
    import types

    from sailor_tpu_torch import scenes
    from sailor_tpu_torch.kernels import cuda_lib

    soup = scenes.tracer_soup
    monkeypatch.setattr(scenes, "tracer_soup", lambda rings=24, sectors=48, spheres=2:
                        soup(rings, sectors, spheres))
    monkeypatch.setattr(chip_smoke, "TRACER", (32, 32, 2, 1))
    monkeypatch.setattr(chip_smoke, "SWEEP_CLUSTERS", (64, 512))  # one chunk, and two

    def grid_twin(*args, **kw):
        cuda_lib.LAUNCHES["sweep_grid"] += 1
        return sweep.sweep_grid_plain(*args, **kw)

    monkeypatch.setattr(sweep, "sweep_grid_cuda", grid_twin)
    monkeypatch.setattr(chip_smoke, "profiled_us", lambda fns, reps=5: {
        k: (fn() and 1.0, "profiler") for k, fn in fns.items()})
    monkeypatch.setattr(chip_smoke, "_time_ms", lambda fn, reps: fn() and 1.0)
    tool = subprocess.CompletedProcess(
        [], 0, stdout="T(1)=1 ms  T(9)=2 ms  per-dispatch=0.125 ms  (1 Mrays/s)  cluster=512\n",
        stderr="# clusters of 512\n")
    monkeypatch.setattr(chip_smoke, "subprocess", types.SimpleNamespace(run=lambda *a, **k: tool))
    small = []

    def small_trace(scene_fn, label, grid=False, spp=2):
        small.append((label, spp))
        cuda_lib.LAUNCHES.update(["slab_entry", "sweep"])  # as a render would
        if "37" in label:
            assert scene_fn("cpu")[0].sweep.cluster == 37

    monkeypatch.setattr(chip_smoke, "check_small_trace", small_trace)
    rows, launches = chip_smoke.run_sweep_clusters(rehearsal)
    assert small == [("tracer_cluster_37", 2), ("tracer_dense_sweep", 1)]
    sizes = [str(c) for c in chip_smoke.SWEEP_CLUSTERS]
    assert list(rows["sweep"]) == list(rows["sweep_grid"]) == sizes
    assert list(rows["slab_entry"]) == sizes + ["1"]
    assert rows["sweep"]["64"]["bounce1"]["n_clusters"] == 73
    assert all(r["bounce1"]["bound_ms"] > 0 for r in rows["sweep"].values())
    assert launches["slab_entry"] == launches["sweep"] == 4 * len(sizes) + 2
    out = capsys.readouterr().out
    assert out.count("b4_equal=True b5_equal=True b6_equal=True tied_equal=True") == 2 * len(sizes)
    assert "4610 clusters" in out and "cluster=512" in out, out


def test_sweep_rayblocks_phase_rehearsal(rehearsal, monkeypatch, capsys):
    """run_sweep_rayblocks at 32x32 on the tracer scene with 2 spheres, at
    three of its pairs and one small pair: at every pair the render's
    route and launches, the twins held to themselves on the bounce-1
    passes (the small pair's two middle ray blocks), the bounds; at
    (8192, 1024) the 4-sample pool on the sweep; the tool's subprocess and
    the small render stubbed (the render is asked at the pair)."""
    import subprocess
    import types

    from sailor_tpu_torch import scenes
    from sailor_tpu_torch.kernels import cuda_lib

    soup = scenes.tracer_soup
    monkeypatch.setattr(scenes, "tracer_soup", lambda rings=24, sectors=48, spheres=2:
                        soup(rings, sectors, spheres))
    monkeypatch.setattr(chip_smoke, "TRACER", (32, 32, 2, 1))
    monkeypatch.setattr(chip_smoke, "SWEEP_RAY_BLOCKS", ((1024, 128), (2048, 2048), (8192, 1024)))
    monkeypatch.setattr(chip_smoke, "SMALL_RAY_BLOCKS", ((96, 1),))

    def grid_twin(*args, **kw):
        cuda_lib.LAUNCHES["sweep_grid"] += 1
        return sweep.sweep_grid_plain(*args, **kw)

    monkeypatch.setattr(sweep, "sweep_grid_cuda", grid_twin)
    monkeypatch.setattr(chip_smoke, "profiled_us", lambda fns, reps=5: {
        k: (fn() and 1.0, "profiler") for k, fn in fns.items()})
    tool = subprocess.CompletedProcess(
        [], 0, stdout="T(1)=1 ms  T(9)=2 ms  per-dispatch=0.125 ms  (1 Mrays/s)  cluster=256 "
                      "ray_block=4096 sub=512\n", stderr="# RAY_BLOCK=4096 SUB=512\n")
    runs = []

    def run(cmd, **kw):
        runs.append({k: kw["env"][k] for k in ("SAILOR_SWEEP_RAY_BLOCK", "SAILOR_SWEEP_SUB")})
        return tool

    monkeypatch.setattr(chip_smoke, "subprocess", types.SimpleNamespace(run=run))
    small = []

    def small_trace(scene_fn=None, label="tracer", grid=False, spp=2):
        small.append((label, sweep.RAY_BLOCK, sweep.SUB, spp))
        cuda_lib.LAUNCHES.update(["slab_entry", "sweep"])  # as a render would

    monkeypatch.setattr(chip_smoke, "check_small_trace", small_trace)
    rows, launches = chip_smoke.run_sweep_rayblocks(rehearsal)
    assert (sweep.RAY_BLOCK, sweep.SUB) == (2048, 256)  # restored
    assert small == [("tracer_ray_block_1536_192", 1536, 192, 1)]
    assert runs == [{"SAILOR_SWEEP_RAY_BLOCK": "4096", "SAILOR_SWEEP_SUB": "512"}]
    keys = ["1024/128", "2048/2048", "8192/1024", "96/1"]
    assert list(rows["sweep"]) == list(rows["sweep_grid"]) == list(rows["slab_entry"]) == keys
    assert all(r["bounce1"]["bound_ms"] > 0 for r in rows["sweep"].values())
    # 4 passes a 1-sample render, 4 more for the 4-sample pool, 1 small render
    assert launches["slab_entry"] == launches["sweep"] == 4 * len(keys) + 4 + 1
    out = capsys.readouterr().out
    assert out.count("b4_equal=True b5_equal=True b6_equal=True tied_equal=True") == 2 * len(keys)
    assert "sweep-rayblocks[8192/1024] sample_batch=4" in out and "route=bvh8" not in out, out
    assert "rays=192 " in out, out


# --- the raster tile height (SAILOR_RASTER_TILE_H) ------------------------------------

@pytest.fixture(scope="module")
def height_rows():
    """The 256x128 flagship frame's inputs at a tile height, made at that
    height by the frame's own nodes (``frame_inputs``), each height once."""
    made = {}

    def get(th):
        if th not in made:
            with chip_smoke.tile_height(th):
                scene = flagship_scene(W, H, 24, 10, device="cpu")
                sb, targets, *_, tiles_y, tiles_x = chip_smoke.frame_inputs(scene, W, H)
                made[th] = scene, sb, targets, tiles_y, tiles_x
        return made[th]

    return get


@pytest.mark.parametrize("kernel", ["worklist", "stream", "stream_mxu", "dma", "dense"])
@pytest.mark.parametrize("th", [16, 128])
def test_mappings_match_twins_at_tile_height(height_rows, th, kernel):
    """worklist_runs (with worklist_plan), stream_runs in both forms,
    dma_runs and dense_runs at tile heights 16 and 128 (2 strips and 16
    of 8 warp rectangles each) bit-equal to the twins, with runs short
    enough that tiles split."""
    scene, sb, targets, ty, tx = height_rows(th)
    kw = dict(tiles_y=ty, tiles_x=tx)
    rows, big, starts, counts = sb["rows"], sb["big_rows"], sb["starts"], sb["counts"]
    n_big = sb["n_big"].to(torch.int32).reshape(())
    with chip_smoke.tile_height(th):
        if kernel == "worklist":
            args = (rows, big, starts, counts, n_big)
            want = tr.rasterize_worklist_plain(*args, **kw)
            model = lambda **k: chip_smoke.worklist_runs(*args, **kw, run_groups=1, **k)  # noqa
        elif kernel.startswith("stream"):
            mxu = kernel == "stream_mxu"
            c0, spt, _ = tr.stream_windows(starts, counts, 256, 16)
            args, k7 = (rows, big, c0, spt, n_big), dict(kw, chunk=256, mxu=mxu)
            want = tr.rasterize_stream_plain(*args, **k7)
            model = lambda **k: chip_smoke.stream_runs(*args, **k7, run_rows=128, **k)  # noqa
        elif kernel == "dma":
            w0, nw = tr.dma_windows(starts, counts, 128)
            args, k8 = (rows, big, w0, nw, n_big), dict(kw, dchunk=128)
            want = tr.rasterize_dma_plain(*args, **k8)
            model = lambda **k: chip_smoke.dma_runs(*args, **k8, run_rows=32, **k)  # noqa
        else:
            tri, aabb = targets["TriSetup"], targets["TriAABB"]
            passes, _ = rsetup.bin_all(tri.valid, aabb, tile_w=tr.TILE_W, tile_h=th,
                                       capacity=256, rounds=2, **kw)
            bins, pcounts = passes[0]
            args = (tr.dense_table(tri, aabb), bins.reshape(-1).to(torch.int32).contiguous(),
                    pcounts.reshape(-1).to(torch.int32).contiguous())
            want = tr.rasterize_tiles_plain(*args, **kw)
            model = lambda **k: chip_smoke.dense_runs(*args, **kw, run_rows=tr.CHUNK, **k)  # noqa
        stats = {}
        got = model(stats=stats)
    assert got[0].shape == (ty * th, W)
    assert int((want[1] >= 0).sum()) > (100 if kernel == "dense" else 1000)
    assert stats["runs"] > ty * tx  # a tile is split
    _same_raster(got, want)


def test_raster_tile_heights_phase_rehearsal(rehearsal, monkeypatch, capsys):
    """run_raster_tile_heights on the 256x128 flagship scene at heights 16
    and 128: every frame's launches (the work-list frame's B1-B3, one frame
    each of B7 in both forms, B8, B9 and B10), the twins held to
    themselves and the bounds at each height and at the default; the small
    frame stubbed (it is asked at SMALL_TILE_HEIGHT); the height
    restored."""
    from sailor_tpu_torch.kernels import cuda_lib

    def counting(plain, key):
        def twin(*args, **kw):
            cuda_lib.LAUNCHES[key + ("_mxu" if kw.get("mxu") else "")] += 1
            return plain(*args, **kw)
        return twin

    for wrapper, plain, key in (("rasterize_stream_cuda", tr.rasterize_stream_plain,
                                 "raster_stream"),
                                ("rasterize_dma_cuda", tr.rasterize_dma_plain, "raster_dma"),
                                ("resolve_stream_cuda", tr.resolve_stream_plain,
                                 "resolve_stream")):
        monkeypatch.setattr(tr, wrapper, counting(plain, key))
    monkeypatch.setattr(chip_smoke, "profiled_us", lambda fns, reps=5, per_call=False: {
        k: (fn() and 1.0, "profiler") for k, fn in fns.items()})
    monkeypatch.setattr(chip_smoke, "TILE_HEIGHTS", (16, 128))
    small = []

    def small_frame(change=None):
        small.append(tr.TILE_H)
        cuda_lib.LAUNCHES.update(chip_smoke.CONFIG_KERNELS["worklist"])  # as a frame would

    monkeypatch.setattr(chip_smoke, "check_small_frame", small_frame)
    scene = flagship_scene(W, H, 24, 4, device="cpu")
    default = tr.TILE_H
    rows, launches = chip_smoke.run_raster_tile_heights(scene, W, H, rehearsal)
    assert tr.TILE_H == default and small == [16]
    assert set(rows) == set(chip_smoke.TILE_HEIGHT_KERNELS)
    for name, by_height in rows.items():
        assert list(by_height) == [str(default), "16", "128"], name
        for h, r in by_height.items():
            assert r["bound_ms"] > 0 and r["max_abs_err"] == 0.0, name
            assert r["launches"] > 0 or (h == str(default) and "worklist" not in name), name
    # the default height's frame, 1 warm-up and TILE_HEIGHT_FRAMES frames at
    # each other, then the small frame
    assert launches["raster_worklist"] == 1 + 2 * (1 + chip_smoke.TILE_HEIGHT_FRAMES) + 1
    assert launches["raster_dense"] == 2 * 5  # the dense frame's five passes
    out = capsys.readouterr().out
    assert out.count("bit_equal=True") == 3 * len(rows), out
    assert "raster-tile-heights[128] 256x128: tiles=1x2 " in out, out
