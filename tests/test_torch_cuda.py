"""Card tests: each CUDA kernel against its plain PyTorch version on the
card, and a frame on the card against the same frame on the CPU path.

Marked ``cuda``; every test skips at run time when torch sees no CUDA
device (the decision is made inside a fixture, so every worker collects the
same tests). On a machine with the card and nvcc:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which these tests do
not use; ``-o addopts=""``: no xdist workers.)

Inputs: the flagship scene at 640x384 (64 point lights, 24 objects) and
the kernel inputs its own nodes make. Tolerances, from the arithmetic:
- raster (B1, and B7 in both plane forms on the same kernel): depth and
  ids exact (the plain version's fma emulation rounds like the kernel's
  fmaf), also on a crafted tile of several runs with tied rows and under
  the sync debug mode "error" (no host sync);
- resolve: exact on >= 99.999% of values (the same operations in the same
  order; the float64 fma emulation can double-round in ~2^-29 of cases),
  and every value within 1e-4 * (1 + |plain|), so a wrong row fails;
- shade: 1e-5 relative (same order; rsqrt may differ by an ulp), also on
  lights of all three types with a shadow factor and tiles of 0 and K slots;
- slab entry with the feature rows and visit tables (B4): rows and all
  four tables bit-equal (the same float32 operations and selects; the
  order by rank is the stable argsort), one launch, no host sync, also on
  the sparse passes;
- cluster sweep (B5), closest and any hit: ids and t bit-equal (the same
  walk and the same left-to-right sums, -fmad=false);
- dense-grid sweep (B6), closest and any hit: ids and t bit-equal to its
  twin and to B5 (the same pairs in the same order), its work equal to
  B5's; both also on the bounce-1 passes with 0, 1, 33 and all 256 rays of
  each sub-block live (the packing's edges), and on clusters with exact
  ties (the merge order);
- the raster variants B7 (both plane forms), B8 and B9 (with and without
  the AABB clamp), all on B1's kernel: depth and ids bit-equal to the twin
  and to the plain model of the kernel's mapping, with and without z
  bounds, B8 also on the crafted tile of several runs; B9 also with a
  poisoned table row before the table (a dead slot reads none);
- grid-k resolve (B10): held as the resolve above;
- the shadowed, HiZ-culled frame: B1 on each sun cascade's inputs (the
  frame's 1024x1024 cascades, ``cull="none"``, ``clip=False``) bit-equal;
  B3 with the frame's EVSM shadow factor at the shade bar; a 256x128
  shadowed, culled frame on the card against the CPU path (ShadowMaps,
  Depth, TriId equal on >= 99.9%, Main within 1e-4 relative on >= 99.5%,
  Final within 2/255 on >= 99.9%); the HiZ cull on the card at a nonzero
  count (the occlusion scene, two frames: HiZCulledCount > 0, Depth and
  TriId exactly the CPU path's); a 256x128 DefaultRenderer frame, two
  frames (the second turned, its sun moved), against the CPU path (Depth,
  TriId, ShadowMaps, HiZCulledCount exact, Sky within 5e-5 * (1 + |cpu|),
  Main within 1e-4 relative on >= 99.5%, Final within 2/255).
- the queue frame (``flagship_queue_scene`` at 640x384): B1 on
  RenderTransparent's two-sided setup, z-bounded over two peel layers,
  bit-equal; B2's 29 planes from the 49-column rows of the opaque and
  the masked bin sets and its 5-plane alpha emit, and B10's 29 planes
  from 49-column grid-k bins, held as the resolve above; a 256x128 queue
  frame on the card against the CPU path (Depth, TriId, ShadowMaps exact,
  Main within 1e-4 relative on >= 99.5%, Final within 2/255).
The tracer's kernels run on its own rays: every intersector pass of one
128x128 sample of the bench tracer scene (camera, bounce-1 and shadow rays),
and 64x64 renders on the card are held to the CPU path: the tracer scene
through B5 and through B6, the material balls with the procedural sky and
maps. The sweep at other cluster sizes (``sweep.build(cluster=)``): B4's
tables, B5 and B6 bit-equal to their twins at clusters 37 and 1024 on the
bounce-1 passes (also on tied clusters), B4 at 1,153 clusters (the dense
scene: shared tables past the old 1,024 limit) and at 4,609 and 18,434
(clusters of 4 and 1: the global-scratch tables), and 64x64 renders on the
card against the CPU path at cluster 37 and of the dense scene's
``tracer="sweep"`` (1 spp). The sweep at other ray block and sub-block
sizes (``sweep.RAY_BLOCK``/``SUB`` set to (1024, 128) and (8192, 2048),
the passes recorded anew at each pair): the same tests of B4-B6, the
sparse passes, the cluster sizes and the global-scratch tables again at
each pair. The raster at other tile heights (``tile_raster.TILE_H`` set to
8, 24, 72, 128 and 2048, the frame's inputs made anew at each height by
its own nodes; 2048 on a 640x1088 frame, one padded tile row): the B1,
B2, B7 (both forms), B8, B9 and B10 tests above again at each height. The BVH8 traversal (``csrc/bvh8.cu``) is held to its twin bit for bit
(t, u, v bits and ids: the same float32 operations, -fmad=false), closest
and any hit, with and without a finite t_max and an active mask, on the
soups of ``tests/torch_bvh8_soups.py`` (the deep one drops pushes at
MAX_STACK) and with every ray inactive, and on the passes of one 128x128
render of the bench tracer scene with 4 pooled samples (BVH8 route); also
on the edges of its persistent schedule (0, 1 and 33 rays, none or 12%
active, more rays than the grid's lanes, two launches in a row, the deep
soup, the one-row table), and a table off a 16-byte boundary is refused; a
64x64 render of the dense scene (BVH8 route) on the card is held to the
CPU path.
The content paths (chip_smoke's small versions): the flagship scene as a
GLB through DefaultRenderer.renderer, the node graph with Clear, Particles,
Blit and CopyTextureToRam, process_views' two views, the engine world with
a MaterialLibrary before and after a hot reload (each frame held by
``full_frame_agreement``), the GLB tracer scene's 64x64 render, the
particle splat at 640x384 (within 1e-4 relative + 1e-6 on >= 99.9%, zero
where the CPU's is) and a MaterialLibrary's table (equal).
The examples, the editor and the host runtime: render_frame's scene at
256x128 (B3 shading on both devices) and the trace example's scene at
64x64 against the CPU path, the editor's live material edit at 256x128 on
the card, and the five benchmark suites on the card (bvh through the
BVH8 kernel) inside synchronised profiler zones.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (bits_equal, cascade_inputs, check_culled_frame, check_small_frame,
                        cluster_scene, ray_block, record_passes,
                        check_small_full_frame, check_small_queue_frame,
                        check_small_shadow_frame, check_small_trace, dense_runs, dma_runs,
                        evsm_shadow_factor, frame_inputs, heavy_tile_cases, heavy_tile_rows,
                        queue_inputs,
                        sparse_pass, stream_runs, tables_equal, textured_sky_balls,
                        tied_clusters, tile_height, tracer_passes, worklist_runs)
from sailor_tpu_torch.framegraph import nodes
from sailor_tpu_torch.kernels import cuda_lib, pbr_kernel
from sailor_tpu_torch.raster import setup as rsetup
from sailor_tpu_torch.raster import tile_raster as tr
from sailor_tpu_torch.raytracing import bvh8, sweep
from sailor_tpu_torch.scenes import (dense_tracer_scene, flagship_queue_scene, flagship_scene,
                                     tracer_scene, tracer_soup)
from torch_bvh8_soups import SOUPS, rays, soup

pytestmark = pytest.mark.cuda
W, H = 640, 384


@pytest.fixture(scope="module")
def card_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cuda_lib.load()
    scene = flagship_scene(W, H, 64, 24)
    return scene, frame_inputs(scene, W, H)


# the raster tile heights the raster and resolve tests also run at (None:
# the default): one strip, two heights no power of two, a taller tile, and
# one taller than its frame (TALL_H rows: one tile row, padded)
HEIGHTS = [None, 8, 24, 72, 128, 2048]
TALL_H = 1088


def over_setting(name, settings, label):
    """A ``parametrize`` of a test's ``argnames`` and the setting ``name``:
    every value at the default setting (None) under its own id, then at each
    other setting (its id followed by ``label(setting)``)."""
    def over(argnames, argvalues, ids):
        values, all_ids = [], []
        for setting in settings:
            for v, i in zip(argvalues, ids):
                values.append((*(v if isinstance(v, tuple) else (v,)), setting))
                all_ids.append(i if setting is None else f"{i}-{label(setting)}")
        return pytest.mark.parametrize(f"{argnames},{name}", values, ids=all_ids)
    return over


over_heights = over_setting("tile_h", HEIGHTS, lambda th: f"h{th}")


def _size(tile_h):
    return (W, TALL_H) if tile_h == 2048 else (W, H)


@pytest.fixture(scope="module")
def height_frames(card_frame):
    """``card_frame`` at a tile height: the scene and the inputs its own nodes
    make at that height, each height once."""
    made = {None: card_frame}

    def get(tile_h):
        if tile_h not in made:
            w, h = _size(tile_h)
            with tile_height(tile_h):
                scene = flagship_scene(w, h, 64, 24)
                made[tile_h] = scene, frame_inputs(scene, w, h)
        return made[tile_h]

    return get


@pytest.fixture
def frame_at(tile_h, height_frames):
    """The raster at the test's tile height for the length of the test; the
    frame's (scene, inputs) there."""
    frame = height_frames(tile_h)
    with tile_height(tile_h):
        yield frame


@over_heights("bounded", [False, True], ids=["no_bounds", "z_bounds"])
def test_raster_kernel_matches_plain(frame_at, bounded):
    _, (sb, targets, *_rest, tiles_y, tiles_x) = frame_at
    args = (sb["rows"], sb["big_rows"], sb["starts"], sb["counts"], sb["n_big"])
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, chunk=128)
    if bounded:
        d0, t0 = tr.rasterize_worklist_cuda(*args, **kw)
        kw["z_bounds"] = (torch.zeros_like(d0), torch.where(t0 >= 0, d0, 2.0))
    before = cuda_lib.LAUNCHES["raster_worklist"]
    d_k, t_k = tr.rasterize_worklist_cuda(*args, **kw)
    assert cuda_lib.LAUNCHES["raster_worklist"] == before + 1
    d_p, t_p = tr.rasterize_worklist_plain(*args, **kw)
    torch.cuda.synchronize()
    assert int((t_p >= 0).sum()) > 100
    assert torch.equal(t_k, t_p)
    assert torch.equal(d_k, d_p)


@over_heights("na,mode", [(37, "full"), (49, "full"), (49, "alpha")],
              ["37-full", "49-full", "49-alpha"])
def test_resolve_kernel_matches_plain(frame_at, na, mode, tile_h):
    scene, (sb, targets, inv_vp, _gb, tiles_y, tiles_x) = frame_at
    rows, big = sb["rows"], sb["big_rows"]
    if na == 49:
        gen = torch.Generator(device=rows.device).manual_seed(5)
        rows, big = (torch.cat([r, torch.rand(len(r), 12, device=r.device, generator=gen)], 1)
                     for r in (rows, big))
    tid = tr.rasterize_worklist_cuda(rows.contiguous(), big.contiguous(), sb["starts"],
                                     sb["counts"], sb["n_big"], tiles_y=tiles_y,
                                     tiles_x=tiles_x)[1]
    par = tr._resolve_params(inv_vp, scene.frame.camera_position, *_size(tile_h), 0,
                             rows.device)
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, na=na, chunk=int(sb["chunk"]), mode=mode)
    args = (rows.contiguous(), big.contiguous(), tid, sb["starts"], sb["counts"], par)
    got = torch.stack(tr.resolve_worklist_cuda(*args, **kw))
    ref = torch.stack(tr.resolve_worklist_plain(*args, **kw))
    assert got.shape[0] == {"full": 13 if na == 37 else 29, "alpha": 5}[mode]
    assert (got == ref).float().mean().item() >= 1 - 1e-5
    assert bool(((got - ref).abs() <= 1e-4 * (1 + ref.abs())).all())
    assert not got[:, tid < 0].any()


def _bounds(depth, tid):
    return (torch.zeros_like(depth), torch.where(tid >= 0, depth, 2.0))


def _equal_launch(name, kernel, plain, args, kw, bounded, model=None):
    """One launch of the kernel, bit-equal to its twin and, given, to the
    plain model of its mapping."""
    if bounded:
        d0, t0 = kernel(*args, **kw)
        kw = dict(kw, z_bounds=_bounds(d0, t0))
    before = cuda_lib.LAUNCHES[name]
    d_k, t_k = kernel(*args, **kw)
    assert cuda_lib.LAUNCHES[name] == before + 1
    d_p, t_p = plain(*args, **kw)
    torch.cuda.synchronize()
    assert int((t_p >= 0).sum()) > 100
    assert torch.equal(t_k, t_p)
    assert torch.equal(d_k, d_p)
    if model is not None:
        d_m, t_m = model(*args, **kw)
        assert torch.equal(t_m, t_p) and torch.equal(d_m, d_p)


@pytest.mark.parametrize("bounded", [False, True], ids=["no_bounds", "z_bounds"])
@over_heights("mxu", [False, True], ids=["vpu", "mxu"])
def test_raster_stream_kernel_matches_plain(frame_at, mxu, bounded):
    _, (sb, *_rest, tiles_y, tiles_x) = frame_at
    c0, spt, _ = tr.stream_windows(sb["starts"], sb["counts"], 256, 16)
    args = (sb["rows"], sb["big_rows"], c0, spt, sb["n_big"])
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, chunk=256, mxu=mxu)
    _equal_launch("raster_stream_mxu" if mxu else "raster_stream", tr.rasterize_stream_cuda,
                  tr.rasterize_stream_plain, args, kw, bounded)


@pytest.mark.parametrize("bounded", [False, True], ids=["no_bounds", "z_bounds"])
@pytest.mark.parametrize("mxu", [False, True], ids=["vpu", "mxu"])
def test_raster_stream_kernel_matches_plain_on_heavy_tile(card_frame, mxu, bounded):
    """B7 on a tile split into several runs whose repeated rows tie in z
    within a group, across groups and across runs
    (chip_smoke.heavy_tile_rows in windows of 128 rows)."""
    name = "raster_stream_mxu" if mxu else "raster_stream"
    kernel, plain, args, kw, model = heavy_tile_cases()[name]
    if bounded:
        kw = dict(kw, z_bounds=_bounds(*kernel(*args, **kw)))
    stats = {}
    d_m, t_m = model(*args, **kw, stats=stats)
    assert stats["runs"] > kw["tiles_y"] * kw["tiles_x"]
    before = cuda_lib.LAUNCHES[name]
    d_k, t_k = kernel(*args, **kw)
    assert cuda_lib.LAUNCHES[name] == before + 1
    d_p, t_p = plain(*args, **kw)
    torch.cuda.synchronize()
    assert int((t_p >= 0).sum()) > 100
    for d, t in ((d_k, t_k), (d_m, t_m)):
        assert torch.equal(t, t_p)
        assert torch.equal(d, d_p)


@pytest.mark.parametrize("mxu", [False, True], ids=["vpu", "mxu"])
def test_raster_stream_makes_no_host_sync(card_frame, mxu):
    """B7's wrapper and rasterize_stream run under the sync debug mode
    "error", and the kernel's mapping (chip_smoke.stream_runs) equals it on
    the frame."""
    _, (sb, *_rest, tiles_y, tiles_x) = card_frame
    c0, spt, _ = tr.stream_windows(sb["starts"], sb["counts"], 256, 16)
    args = (sb["rows"], sb["big_rows"], c0, spt, sb["n_big"])
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, chunk=256, mxu=mxu)
    d0, t0 = tr.rasterize_stream_cuda(*args, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d1, t1 = tr.rasterize_stream_cuda(*args, **kw, z_bounds=_bounds(d0, t0))
        d2, t2, _ = tr.rasterize_stream(None, None, None, sb["starts"], sb["counts"], None,
                                        sb["n_big"], prebuilt=(sb["rows"], sb["big_rows"]),
                                        **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(d2, d0) and torch.equal(t2, t0)
    assert torch.equal(t1, tr.rasterize_stream_plain(*args, **kw, z_bounds=_bounds(d0, t0))[1])
    d_m, t_m = stream_runs(*args, **kw)
    assert torch.equal(d_m, d0) and torch.equal(t_m, t0)


@over_heights("bounded", [False, True], ids=["no_bounds", "z_bounds"])
def test_raster_dma_kernel_matches_plain(frame_at, bounded):
    _, (sb, *_rest, tiles_y, tiles_x) = frame_at
    w0, nw = tr.dma_windows(sb["starts"], sb["counts"], 128)
    args = (sb["rows"], sb["big_rows"], w0, nw, sb["n_big"])
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, dchunk=128)
    _equal_launch("raster_dma", tr.rasterize_dma_cuda, tr.rasterize_dma_plain, args, kw,
                  bounded, dma_runs)


@pytest.mark.parametrize("bounded", [False, True], ids=["no_bounds", "z_bounds"])
def test_raster_dma_kernel_matches_plain_on_heavy_tile(card_frame, bounded):
    """B8 on chip_smoke.heavy_tile_rows in windows of 128 rows: a tile of
    several runs whose repeated rows tie in z within a group, across groups
    and across runs."""
    kernel, plain, args, kw, model = heavy_tile_cases()["raster_dma"]
    stats = {}
    model(*args, **kw, stats=stats)
    assert stats["runs"] > kw["tiles_y"] * kw["tiles_x"]
    _equal_launch("raster_dma", kernel, plain, args, kw, bounded, model)


@pytest.mark.parametrize("bounded", [False, True], ids=["no_bounds", "z_bounds"])
@pytest.mark.parametrize("clamp", [False, True], ids=["no_aabb", "aabb"])
@over_heights("npass", [0, -1], ids=["first_pass", "big_pass"])
def test_raster_dense_kernel_matches_plain(frame_at, npass, clamp, bounded):
    """B9 on bin_all's first pass and on its big-triangle pass (64 slots,
    the ground plane over every pixel)."""
    _, (sb, targets, *_rest, tiles_y, tiles_x) = frame_at
    tri, aabb = targets["TriSetup"], targets["TriAABB"]
    passes, _ = rsetup.bin_all(tri.valid, aabb, tiles_x=tiles_x, tiles_y=tiles_y,
                               tile_w=tr.TILE_W, tile_h=tr.TILE_H, capacity=256, rounds=2)
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x)

    table = tr.dense_table(tri, aabb if clamp else None)

    def dense_args(p):
        bins, counts = passes[p]
        assert int(counts.max()) > 0
        return (table, bins.reshape(-1).to(torch.int32).contiguous(),
                counts.reshape(-1).to(torch.int32).contiguous())

    if bounded and npass:
        # behind its own winners the big pass covers a few dozen pixels at
        # this size: peel it behind the first pass's winners instead
        kw["z_bounds"] = _bounds(*tr.rasterize_tiles_cuda(*dense_args(0), **kw))
        bounded = False
    _equal_launch("raster_dense", tr.rasterize_tiles_cuda, tr.rasterize_tiles_plain,
                  dense_args(npass), kw, bounded, dense_runs)


def test_raster_dense_dead_slot_reads_no_table_row(card_frame):
    """B9 on a table that starts 16 rows into its storage, whose row -1
    would cover every pixel nearest: the output equals the twin's, and
    B9 makes no host sync."""
    _, (sb, targets, *_rest, tiles_y, tiles_x) = card_frame
    tri, aabb = targets["TriSetup"], targets["TriAABB"]
    passes, _ = rsetup.bin_all(tri.valid, aabb, tiles_x=tiles_x, tiles_y=tiles_y,
                               tile_w=tr.TILE_W, tile_h=tr.TILE_H, capacity=256, rounds=2)
    bins, counts = passes[0]
    ids = bins.reshape(-1).to(torch.int32).contiguous()
    counts = counts.reshape(-1).to(torch.int32).contiguous()
    table = tr.dense_table(tri, aabb)
    store = torch.zeros(table.shape[0] + 16, 16, device=table.device)
    store[:16] = torch.tensor([0.0, 0.0, 1.0] * 3 + [0.0, 0.0, 0.99, -1e4, 1e4, -1e4, 1e4],
                              device=table.device)
    store[16:] = table
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x)
    want = tr.rasterize_tiles_plain(table, ids, counts, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tr.rasterize_tiles_cuda(store[16:], ids, counts, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool((ids < 0).any())
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_resolve_stream_kernel_matches_plain(card_frame):
    _resolve_stream_matches_plain(card_frame, None)


@pytest.mark.parametrize("tile_h", HEIGHTS[1:], ids=[f"h{h}" for h in HEIGHTS[1:]])
def test_resolve_stream_kernel_matches_plain_at_tile_height(frame_at, tile_h):
    _resolve_stream_matches_plain(frame_at, tile_h)


def _resolve_stream_matches_plain(frame, tile_h):
    scene, (sb, targets, inv_vp, _gb, tiles_y, tiles_x) = frame
    rows, big = sb["rows"], sb["big_rows"]
    c0, spt, _ = tr.stream_windows(sb["starts"], sb["counts"], 256, 16)
    tid = tr.rasterize_stream_cuda(rows, big, c0, spt, sb["n_big"], tiles_y=tiles_y,
                                   tiles_x=tiles_x)[1]
    par = tr._resolve_params(inv_vp, scene.frame.camera_position, *_size(tile_h), 0,
                             rows.device)
    args = (rows, big, tid, sb["starts"], sb["counts"], c0, spt, par)
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, na=37, chunk=256)
    before = cuda_lib.LAUNCHES["resolve_stream"]
    got = torch.stack(tr.resolve_stream_cuda(*args, **kw))
    assert cuda_lib.LAUNCHES["resolve_stream"] == before + 1
    ref = torch.stack(tr.resolve_stream_plain(*args, **kw))
    assert got.shape[0] == 13
    assert (got == ref).float().mean().item() >= 1 - 1e-5
    assert bool(((got - ref).abs() <= 1e-4 * (1 + ref.abs())).all())
    assert not got[:, tid < 0].any()


def test_shade_kernel_matches_plain(card_frame):
    scene, (sb, targets, inv_vp, gb, tiles_y, tiles_x) = card_frame
    args = (pbr_kernel.pack_lights(scene.lights),
            targets["LightIndices"].to(torch.int32).contiguous(),
            targets["LightCounts"].to(torch.int32).contiguous(), gb.albedo.contiguous(),
            gb.metallic.contiguous(), gb.roughness.contiguous(), gb.normal.contiguous(),
            gb.world_position.contiguous(), None,
            scene.frame.camera_position.to(torch.float32).contiguous())
    got = pbr_kernel.shade_tiles_cuda(*args)
    ref = pbr_kernel.shade_tiles_plain(*args)
    assert ref.abs().max().item() > 0.1
    rel = ((got - ref).abs() / ref.abs().clamp(min=1e-3)).max().item()
    assert rel <= 1e-5, rel


def _shade_case(seed=3, th=4, tw=8, n=60, K=128):
    """B3's inputs at 64x128: n lights of all three types (the first
    directional), a G-buffer of mixed surfaces, a shadow factor, and per
    tile up to K slots: tile 0 has none, tile 1 all K, the others a seeded
    count; unused slots hold -1."""
    g = torch.Generator().manual_seed(seed)
    H, W = 16 * th, 16 * tw
    types = torch.randint(1, 3, (n,), generator=g).float()
    types[0] = 0.0
    dirs = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    pos = torch.rand(n, 3, generator=g) * torch.tensor([12.0, 3.0, 12.0]) - torch.tensor(
        [6.0, 0.0, 6.0])
    table = torch.cat([pos, dirs, torch.rand(n, 3, generator=g) * 6 + 0.3,
                       torch.tensor([[1.0, 0.0, 0.8]]).expand(n, 3),
                       torch.tensor([[0.95, 0.7]]).expand(n, 2),
                       torch.rand(n, 1, generator=g) * 6 + 2.0, types[:, None]], 1)
    table = torch.cat([table, torch.tensor([[0.0] * 15 + [-1.0]])])
    counts = torch.randint(0, K + 1, (th, tw), generator=g, dtype=torch.int32)
    counts[0, 0], counts[0, 1] = 0, K
    slot = torch.arange(K)[None, None]
    idx = torch.randint(0, n, (th, tw, K), generator=g, dtype=torch.int32)
    idx = torch.where(slot < counts[..., None], idx, torch.full_like(idx, -1))
    nrm = torch.randn(H, W, 3, generator=g)
    nrm[..., 1] = nrm[..., 1].abs() + 0.5
    nrm = torch.nn.functional.normalize(nrm, dim=-1)
    albedo = torch.cat([torch.rand(H, W, 3, generator=g) * 0.8 + 0.1, torch.ones(H, W, 1)], -1)
    wpos = torch.rand(H, W, 3, generator=g) * torch.tensor([12.0, 2.0, 12.0]) - torch.tensor(
        [6.0, 0.0, 6.0])
    metallic = torch.tensor([0.0, 0.6, 1.0])[torch.randint(0, 3, (H, W), generator=g)]
    rough = torch.rand(H, W, generator=g) * 0.8 + 0.2
    shadow = torch.rand(H, W, generator=g)
    cam = torch.tensor([4.0, 5.0, 9.0])
    return (table, idx, counts, albedo, metallic, rough, nrm, wpos, shadow, cam)


def test_shade_kernel_matches_plain_on_all_light_types(card_frame):
    """Directional, point and spot lights with a shadow factor, tiles of 0
    and of K slots: the paths the flagship frame (point lights, one
    directional, no shadow input) does not take."""
    args = [a.cuda().contiguous() for a in _shade_case()]
    assert {0.0, 1.0, 2.0} <= set(args[0][:, 15].tolist())
    before = cuda_lib.LAUNCHES["shade_forward_plus"]
    got = pbr_kernel.shade_tiles_cuda(*args)
    assert cuda_lib.LAUNCHES["shade_forward_plus"] == before + 1
    ref = pbr_kernel.shade_tiles_plain(*args)
    assert ref.abs().max().item() > 0.1
    assert not got[:16, :16].any()  # the tile with no light slots
    rel = ((got - ref).abs() / ref.abs().clamp(min=1e-3)).max().item()
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("bounded", [False, True], ids=["no_bounds", "z_bounds"])
def test_raster_kernel_matches_plain_on_heavy_tile(card_frame, bounded):
    """B1 on a tile split into 4 runs whose repeated rows tie in z within
    a group, across groups and across runs (chip_smoke.heavy_tile_rows)."""
    rows, big, starts, counts, n_big, ty, tx = (
        x.cuda() if torch.is_tensor(x) else x for x in heavy_tile_rows())
    args = (rows, big, starts, counts, n_big)
    kw = dict(tiles_y=ty, tiles_x=tx)
    if bounded:
        kw["z_bounds"] = _bounds(*tr.rasterize_worklist_cuda(*args, **kw))
    stats = {}
    worklist_runs(*args, **kw, stats=stats)
    assert stats["runs"] > ty * tx
    d_k, t_k = tr.rasterize_worklist_cuda(*args, **kw)
    d_p, t_p = tr.rasterize_worklist_plain(*args, **kw)
    torch.cuda.synchronize()
    assert int((t_p >= 0).sum()) > 100
    assert torch.equal(t_k, t_p)
    assert torch.equal(d_k, d_p)


def test_raster_kernel_matches_plain_with_doubled_runs(card_frame, monkeypatch):
    """Scratch for 2 runs: the plan doubles R to 8, so a run's groups wrap
    the 4-slot staging ring and the crafted tile still splits in two."""
    monkeypatch.setattr(tr, "worklist_slots", lambda ntiles: 2)
    rows, big, starts, counts, n_big, ty, tx = (
        x.cuda() if torch.is_tensor(x) else x for x in heavy_tile_rows())
    args, kw = (rows, big, starts, counts, n_big), dict(tiles_y=ty, tiles_x=tx)
    stats = {}
    worklist_runs(*args, **kw, stats=stats)
    assert stats["run_groups"] == 8 and stats["runs"] > ty * tx
    d_k, t_k = tr.rasterize_worklist_cuda(*args, **kw)
    d_p, t_p = tr.rasterize_worklist_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(t_k, t_p)
    assert torch.equal(d_k, d_p)


def test_raster_worklist_makes_no_host_sync(card_frame):
    """B1's wrapper and rasterize_worklist run under the sync debug mode
    "error": no .item(), .tolist() or nonzero on the path."""
    _, (sb, *_rest, tiles_y, tiles_x) = card_frame
    args = (sb["rows"], sb["big_rows"], sb["starts"], sb["counts"], sb["n_big"])
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, chunk=128)
    d0, t0 = tr.rasterize_worklist_cuda(*args, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d1, t1 = tr.rasterize_worklist_cuda(*args, **kw, z_bounds=_bounds(d0, t0))
        d2, t2, _ = tr.rasterize_worklist(None, None, None, sb["starts"], sb["counts"], None,
                                          sb["n_big"], prebuilt=(sb["rows"], sb["big_rows"]),
                                          **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(d2, d0) and torch.equal(t2, t0)
    assert torch.equal(t1, tr.rasterize_worklist_plain(*args, **kw, z_bounds=_bounds(d0, t0))[1])


def test_frame_on_card_matches_cpu(card_frame):
    check_small_frame()


@pytest.mark.parametrize("cascade", [0, 1, 2, 3])
def test_raster_kernel_matches_plain_on_cascade(card_frame, cascade):
    scene, _ = card_frame
    rows, big, starts, counts, n_big, tiles_y, tiles_x = cascade_inputs(scene, cascade)
    args = (rows, big, starts, counts, n_big)
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, chunk=128)
    d_k, t_k = tr.rasterize_worklist_cuda(*args, **kw)
    d_p, t_p = tr.rasterize_worklist_plain(*args, **kw)
    assert (t_p >= 0).any()
    assert torch.equal(d_k, d_p) and torch.equal(t_k, t_p)


def test_shade_kernel_matches_plain_with_evsm_shadow(card_frame):
    scene, (_, targets, _, gb, *_) = card_frame
    shadow = evsm_shadow_factor(scene, W, H, gb)
    assert bool((shadow[gb.coverage > 0] < 0.9).any())
    args = (pbr_kernel.pack_lights(scene.lights),
            targets["LightIndices"].to(torch.int32).contiguous(),
            targets["LightCounts"].to(torch.int32).contiguous(), gb.albedo.contiguous(),
            gb.metallic.contiguous(), gb.roughness.contiguous(), gb.normal.contiguous(),
            gb.world_position.contiguous(), shadow.contiguous(),
            scene.frame.camera_position.to(torch.float32).contiguous())
    got = pbr_kernel.shade_tiles_cuda(*args)
    ref = pbr_kernel.shade_tiles_plain(*args)
    assert ((got - ref).abs() / ref.abs().clamp(min=1e-3)).max().item() <= 1e-5


def test_shadow_frame_on_card_matches_cpu(card_frame):
    check_small_shadow_frame()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cuda_lib.load()


def test_culled_frame_on_card_matches_cpu(card):
    check_culled_frame()


def test_full_frame_on_card_matches_cpu(card):
    check_small_full_frame()


@pytest.fixture(scope="module")
def queue_frame(card):
    scene = flagship_queue_scene(W, H, 64, 24)[0]
    return scene, queue_inputs(scene, W, H)


def test_raster_kernel_matches_plain_on_two_sided_peel(queue_frame):
    """B1 on RenderTransparent's two-sided setup, z-bounded as the peel
    runs it (in front of Depth, then behind the first layer)."""
    _, (_, targets, (_, _, sb)) = queue_frame
    args = (sb["rows"], sb["big_rows"], sb["starts"], sb["counts"], sb["n_big"])
    tiles_y, tiles_x = -(-H // tr.TILE_H), -(-W // tr.TILE_W)
    zhi = torch.full_like(targets["Depth"], 2.0)
    covered = 0
    for _ in range(2):
        kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, z_bounds=(targets["Depth"], zhi))
        d_k, t_k = tr.rasterize_worklist_cuda(*args, **kw)
        d_p, t_p = tr.rasterize_worklist_plain(*args, **kw)
        assert torch.equal(t_k, t_p) and torch.equal(d_k, d_p)
        covered += int((t_k >= 0).sum())
        zhi = torch.where(t_k[:H, :W] >= 0, d_k[:H, :W], 0.0)
    assert covered > 100


@pytest.mark.parametrize("bins,mode", [(0, "full"), (1, "full"), (1, "alpha")],
                         ids=["opaque_29", "masked_29", "masked_alpha"])
def test_resolve_kernel_matches_plain_on_material_rows(queue_frame, bins, mode):
    """B2 from the queue frame's own 49-column rows: 29 planes of the
    opaque and the masked bin sets on the frame's winners, and the 5-plane
    alpha emit on the masked queue's nearest layer."""
    scene, (_, targets, _) = queue_frame
    sb = targets["StreamBins"][bins]
    tiles_y, tiles_x = -(-H // tr.TILE_H), -(-W // tr.TILE_W)
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x)
    if mode == "alpha":
        tid = tr.rasterize_worklist_cuda(sb["rows"], sb["big_rows"], sb["starts"], sb["counts"],
                                         sb["n_big"], **kw)[1]
    else:
        tid = torch.nn.functional.pad(targets["TriId"], (0, tiles_x * tr.TILE_W - W,
                                                         0, tiles_y * tr.TILE_H - H), value=-1)
    inv_vp = nodes.inverse_view_projection(scene.frame)
    par = tr._resolve_params(inv_vp, scene.frame.camera_position, W, H, 0, tid.device)
    kw = dict(kw, na=int(sb["na"]), chunk=int(sb["chunk"]), mode=mode)
    args = (sb["rows"], sb["big_rows"], tid.contiguous(), sb["starts"], sb["counts"], par)
    before = cuda_lib.LAUNCHES["resolve_worklist_alpha"]
    got = torch.stack(tr.resolve_worklist_cuda(*args, **kw))
    assert cuda_lib.LAUNCHES["resolve_worklist_alpha"] == before + (mode == "alpha")
    ref = torch.stack(tr.resolve_worklist_plain(*args, **kw))
    assert sb["na"] == 49 and got.shape[0] == (5 if mode == "alpha" else 29)
    assert int((got[-1] != 0).sum()) > 100  # cutoff (alpha) or opacity planes
    assert (got == ref).float().mean().item() >= 1 - 1e-5
    assert bool(((got - ref).abs() <= 1e-4 * (1 + ref.abs())).all())


def test_resolve_stream_kernel_matches_plain_on_material_rows(queue_frame):
    """B10 from 49-column grid-k bins of the queue frame's opaque queue."""
    scene, (ctx, targets, _) = queue_frame
    tri, aabb = targets["TriSetup"], targets["TriAABB"]
    tiles_y, tiles_x = -(-H // tr.TILE_H), -(-W // tr.TILE_W)
    cfg = dict(ctx.config, raster_worklist=False)
    queue = nodes._queue_of_raster_tris(scene, tri)
    raster, _, sb = nodes._make_raster(tri, tri.valid & (queue == 0), aabb, tiles_y, tiles_x,
                                       cfg, capacity=1024, rounds=4,
                                       attrs=nodes._packed_attrs(scene, tri, cfg))
    tid = raster()[1].contiguous()
    c0, spt, _ = tr.stream_windows(sb["starts"], sb["counts"], sb["chunk"], sb["kmax"])
    par = tr._resolve_params(nodes.inverse_view_projection(scene.frame),
                             scene.frame.camera_position, W, H, 0, tid.device)
    args = (sb["rows"], sb["big_rows"], tid, sb["starts"], sb["counts"], c0, spt, par)
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, na=int(sb["na"]), chunk=int(sb["chunk"]))
    got = torch.stack(tr.resolve_stream_cuda(*args, **kw))
    ref = torch.stack(tr.resolve_stream_plain(*args, **kw))
    assert sb["na"] == 49 and got.shape[0] == 29
    assert (got == ref).float().mean().item() >= 1 - 1e-5
    assert bool(((got - ref).abs() <= 1e-4 * (1 + ref.abs())).all())


def test_queue_frame_on_card_matches_cpu(card):
    check_small_queue_frame()


@pytest.fixture(scope="module")
def tracer_rays():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cuda_lib.load()
    scene, cam, view, proj = tracer_scene()
    return scene, tracer_passes(scene, cam, view, proj, 128, 128)


# the sweep's (RAY_BLOCK, SUB) pairs the B4-B6 tests run at: the default
# and two more (a smaller sub-block; one larger than a CUDA block)
PAIRS = [None, (1024, 128), (8192, 2048)]


over_pairs = over_setting("pair", PAIRS, lambda pair: f"{pair[0]}-{pair[1]}")


@pytest.fixture(scope="module")
def pair_rays(tracer_rays):
    """``tracer_rays`` at a (RAY_BLOCK, SUB) pair (None: the default):
    the passes recorded with the sweep at that pair, each pair once."""
    recorded = {None: tracer_rays}

    def get(pair):
        if pair not in recorded:
            scene, cam, view, proj = tracer_scene()
            with ray_block(*pair):
                recorded[pair] = scene, tracer_passes(scene, cam, view, proj, 128, 128)
        return recorded[pair]

    return get


@pytest.fixture
def at_pair(pair, pair_rays):
    """The sweep at the test's pair for the length of the test; its
    (scene, passes)."""
    if pair is None:
        yield pair_rays(None)
        return
    rays = pair_rays(pair)
    with ray_block(*pair):
        yield rays


@over_pairs("npass", [0, 1, 2, 3], ids=["bounce0", "bounce0_shadow", "bounce1", "bounce1_shadow"])
def test_slab_entry_kernel_matches_plain(at_pair, npass):
    """B4's feature rows and four tables, one launch, under the sync debug
    mode "error"."""
    scene, passes = at_pair
    p = passes[npass]
    args = (p["feats"][:, 8:11].contiguous(), p["feats"][:, 0:3].contiguous(), p["tmax"],
            scene.sweep.cl_min, scene.sweep.cl_max)
    before = cuda_lib.LAUNCHES["slab_entry"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sweep.visit_tables_cuda(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cuda_lib.LAUNCHES["slab_entry"] == before + 1
    ref = sweep.visit_tables_plain(*args)
    assert int(ref["nlive"].sum()) > 0
    assert tables_equal(got, ref) and bits_equal(got["feats"], p["feats"])


@over_pairs("live", [0, 1, 33, 256], ids=["none", "one", "33", "all"])
@pytest.mark.parametrize("npass", [2, 3], ids=["bounce1", "bounce1_shadow"])
def test_slab_entry_kernel_matches_plain_on_sparse_passes(at_pair, npass, live):
    scene, passes = at_pair
    p = sparse_pass(scene.sweep, passes[npass], live)  # tables from the kernel
    ref = sweep.visit_tables_plain(p["feats"][:, 8:11].contiguous(),
                                   p["feats"][:, 0:3].contiguous(), p["tmax"],
                                   scene.sweep.cl_min, scene.sweep.cl_max)
    assert tables_equal(p, ref)


@over_pairs("npass", [0, 1, 2, 3], ids=["bounce0", "bounce0_shadow", "bounce1", "bounce1_shadow"])
def test_sweep_kernel_matches_plain(at_pair, npass):
    scene, passes = at_pair
    p = passes[npass]
    args = (p["e_bits"], p["order"], p["blk_bits"], p["nlive"], p["feats"], p["tmax"],
            scene.sweep.g_cluster)
    before = cuda_lib.LAUNCHES["sweep"]
    t_k, i_k = sweep.sweep_cuda(*args, any_hit=p["any_hit"])
    assert cuda_lib.LAUNCHES["sweep"] == before + 1
    t_p, i_p = sweep.sweep_plain(*args, any_hit=p["any_hit"])
    assert int((i_p >= 0).sum()) > 10
    assert torch.equal(i_k, i_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))


def test_trace_on_card_matches_cpu(tracer_rays):
    check_small_trace()


@over_pairs("npass", [0, 1, 2, 3], ids=["bounce0", "bounce0_shadow", "bounce1", "bounce1_shadow"])
def test_sweep_grid_kernel_matches_plain_and_b5(at_pair, npass):
    scene, passes = at_pair
    p = passes[npass]
    g = scene.sweep.g_cluster
    args = (p["e_bits"], p["order"], p["feats"], p["tmax"], g)
    before = cuda_lib.LAUNCHES["sweep_grid"]
    t_k, i_k = sweep.sweep_grid_cuda(*args, any_hit=p["any_hit"])
    assert cuda_lib.LAUNCHES["sweep_grid"] == before + 1
    w6, w5 = {}, {}
    t_p, i_p = sweep.sweep_grid_plain(*args, any_hit=p["any_hit"], work=w6)
    t_5, i_5 = sweep.sweep_cuda(p["e_bits"], p["order"], p["blk_bits"], p["nlive"], p["feats"],
                                p["tmax"], g, any_hit=p["any_hit"])
    sweep.sweep_plain(p["e_bits"], p["order"], p["blk_bits"], p["nlive"], p["feats"], p["tmax"],
                      g, any_hit=p["any_hit"], work=w5)
    assert int((i_p >= 0).sum()) > 10
    for t, i in ((t_p, i_p), (t_5, i_5)):
        assert torch.equal(i_k, i)
        assert torch.equal(t_k.view(torch.int32), t.view(torch.int32))
    assert w6 == w5


def test_grid_trace_on_card_matches_cpu(tracer_rays):
    check_small_trace(label="tracer_grid", grid=True)


def test_textured_sky_trace_on_card_matches_cpu(tracer_rays):
    check_small_trace(textured_sky_balls, "balls_textured_sky")


@over_pairs("live,tied", [(0, False), (1, False), (33, False), (256, False), (256, True)],
            ids=["none", "one", "33", "all", "all_tied"])
@pytest.mark.parametrize("npass", [2, 3], ids=["bounce1", "bounce1_shadow"])
def test_sweep_kernels_match_plain_on_sparse_passes(at_pair, npass, live, tied):
    scene, passes = at_pair
    p = sparse_pass(scene.sweep, passes[npass], live)
    g = tied_clusters(scene.sweep.g_cluster) if tied else scene.sweep.g_cluster
    args = (p["e_bits"], p["order"], p["blk_bits"], p["nlive"], p["feats"], p["tmax"], g)
    t_p, i_p = sweep.sweep_plain(*args, any_hit=p["any_hit"])
    t_5, i_5 = sweep.sweep_cuda(*args, any_hit=p["any_hit"])
    t_6, i_6 = sweep.sweep_grid_cuda(p["e_bits"], p["order"], p["feats"], p["tmax"], g,
                                     any_hit=p["any_hit"])
    hits = int((i_p >= 0).sum())
    assert hits == 0 if live == 0 else (hits > 0 or live == 1)
    for t, i in ((t_5, i_5), (t_6, i_6)):
        assert torch.equal(i, i_p)
        assert torch.equal(t.view(torch.int32), t_p.view(torch.int32))


@pytest.fixture(scope="module")
def cluster_sweeps(tracer_rays):
    """The tracer scene's sweep built at other cluster sizes, on the card,
    each built once: a function of the cluster size."""
    soup = tracer_soup()
    tris = tuple(soup["position"][soup["indices"][:, k]] for k in range(3))
    built = {}

    def get(cluster):
        if cluster not in built:
            built[cluster] = sweep.build(*tris, cluster=cluster)
        return built[cluster]

    return get


def _tables_at(sw, p, rays=None):
    """B4's tables (the kernel) for the pass p's rays (the first ``rays``)
    over the sweep ``sw``, and the twin's on the same inputs."""
    rays = rays or p["tmax"].shape[0]
    args = (p["feats"][:rays, 8:11].contiguous(), p["feats"][:rays, 0:3].contiguous(),
            p["tmax"][:rays].contiguous(), sw.cl_min, sw.cl_max)
    return sweep.visit_tables_cuda(*args), sweep.visit_tables_plain(*args)


@over_pairs("cluster", [37, 1024], ids=["37", "1024"])
@pytest.mark.parametrize("npass", [2, 3], ids=["bounce1", "bounce1_shadow"])
def test_sweep_kernels_match_plain_at_cluster(at_pair, cluster_sweeps, npass, cluster):
    _, passes = at_pair
    sw = cluster_sweeps(cluster)
    assert sw.cluster == cluster and sw.g_cluster.shape[2] == cluster
    got, ref = _tables_at(sw, passes[npass])
    assert int(ref["nlive"].sum()) > 0 and tables_equal(got, ref)
    p = dict(ref, tmax=passes[npass]["tmax"])
    any_hit = passes[npass]["any_hit"]
    for g in (sw.g_cluster, tied_clusters(sw.g_cluster)):
        args = (p["e_bits"], p["order"], p["blk_bits"], p["nlive"], p["feats"], p["tmax"], g)
        t_p, i_p = sweep.sweep_plain(*args, any_hit=any_hit)
        t_5, i_5 = sweep.sweep_cuda(*args, any_hit=any_hit)
        t_6, i_6 = sweep.sweep_grid_cuda(p["e_bits"], p["order"], p["feats"], p["tmax"], g,
                                         any_hit=any_hit)
        assert int((i_p >= 0).sum()) > 10
        for t, i in ((t_5, i_5), (t_6, i_6)):
            assert torch.equal(i, i_p)
            assert torch.equal(t.view(torch.int32), t_p.view(torch.int32))


@over_pairs("cluster,blocks", [(4, 2), (1, 1)], ids=["4609_clusters", "18434_clusters"])
def test_slab_entry_kernel_matches_plain_past_shared_tables(at_pair, cluster_sweeps,
                                                            cluster, blocks):
    _, passes = at_pair
    sw = cluster_sweeps(cluster)
    assert sw.n_clusters > sweep.slab_smem_clusters()
    got, ref = _tables_at(sw, passes[2], blocks * sweep.RAY_BLOCK)
    assert int(ref["nlive"].sum()) > 0 and tables_equal(got, ref)


@pytest.fixture(scope="module")
def dense_sweep_scene(tracer_rays):
    """``scene_fn`` of the dense scene with its sweep (1,153 clusters of
    256), the host arrays built once."""
    return cluster_scene(sweep.CLUSTER, rings=96, sectors=192)


def test_slab_entry_kernel_matches_plain_on_dense_scene(tracer_rays, dense_sweep_scene):
    _, passes = tracer_rays
    sw = dense_sweep_scene("cuda")[0].sweep
    assert sw.n_clusters == 1153
    got, ref = _tables_at(sw, passes[2])
    assert int(ref["nlive"].sum()) > 0 and tables_equal(got, ref)


def test_dense_sweep_trace_on_card_matches_cpu(dense_sweep_scene):
    check_small_trace(dense_sweep_scene, "tracer_dense_sweep", spp=1)


def test_cluster_37_trace_on_card_matches_cpu(tracer_rays):
    check_small_trace(cluster_scene(37), "tracer_cluster_37")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cuda_lib.load()


def _bvh8_equal(got, want):
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("name", SOUPS)
def test_bvh8_kernel_matches_plain(card, name, any_hit):
    table = torch.from_numpy(bvh8.build_table(*soup(name))).cuda()
    o, d, act = (torch.from_numpy(x).cuda() for x in rays())
    work = {}
    for t_max, active in ((None, None), (4.0, act), (None, torch.zeros_like(act))):
        args = bvh8.ray_inputs(o, d, t_max, active)
        before = cuda_lib.LAUNCHES["bvh8_intersect"]
        got = bvh8.intersect_cuda(table, *args, any_hit=any_hit)
        assert cuda_lib.LAUNCHES["bvh8_intersect"] == before + 1
        want = bvh8.intersect_plain(table, *args, any_hit=any_hit, work=work)
        assert _bvh8_equal(got, want)
        assert int((want[1] >= 0).sum()) > (0 if active is None or bool(active.any()) else -1)
    if name == "deep" and not any_hit:
        assert work["dropped_pushes"] > 0


@pytest.mark.parametrize("npass", [0, 1, 2, 3],
                         ids=["bounce0", "bounce0_shadow", "bounce1", "bounce1_shadow"])
def test_bvh8_kernel_matches_plain_on_tracer_passes(card, npass):
    scene, cam, view, proj = tracer_scene(tracer="bvh8")
    p = record_passes(scene, cam, view, proj, 128, 128, sample_batch=4)[npass]
    args = bvh8.ray_inputs(p["origin"], p["direction"], None, p["active"])
    got = bvh8.intersect_cuda(scene.bvh.table, *args, any_hit=p["any_hit"])
    want = bvh8.intersect_plain(scene.bvh.table, *args, any_hit=p["any_hit"])
    assert int((want[1] >= 0).sum()) > 10
    assert _bvh8_equal(got, want)


def _bvh8_case(case):
    """(table, origin, direction, t_max, active) of a schedule edge case."""
    rng = np.random.default_rng(6)
    name = {"deep": "deep", "leaf_root": "leaf_root"}.get(case, "tracer")
    table = torch.from_numpy(bvh8.build_table(*soup(name))).cuda()
    n = {"n0": 0, "n1": 1, "n33": 33}.get(case, 3000)
    if case == "refill":  # more rays than the persistent grid has lanes
        info = bvh8.kernel_info()
        n = 3 * info["resident_blocks"] * info["threads"]
    o, d, _ = (torch.from_numpy(x).cuda() for x in rays(max(n, 1), seed=7))
    o, d = o[:n], d[:n]
    active = None
    if case == "inactive":
        active = torch.zeros(n, dtype=torch.bool, device="cuda")
    elif case == "active12":
        active = torch.from_numpy(rng.random(n) < 0.12).cuda()
    return table, o, d, (4.0 if case == "active12" else None), active


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("case", ["n0", "n1", "n33", "inactive", "active12", "refill",
                                  "twice", "deep", "leaf_root"])
def test_bvh8_kernel_schedule_edges(card, case, any_hit):
    """The persistent schedule's edges, each bit-equal to the twin with one
    launch: 0, 1 and 33 rays; every ray inactive; 12% active; three times
    the rays the grid's lanes hold (lanes refill); two launches in a row on
    the same inputs (the ray counter is cleared each launch); the deep
    soup's dropped pushes; the one-row leaf-root table."""
    table, o, d, t_max, active = _bvh8_case(case)
    args = bvh8.ray_inputs(o, d, t_max, active)
    work = {}
    want = bvh8.intersect_plain(table, *args, any_hit=any_hit, work=work)
    for _ in range(2 if case == "twice" else 1):
        before = cuda_lib.LAUNCHES["bvh8_intersect"]
        got = bvh8.intersect_cuda(table, *args, any_hit=any_hit)
        assert cuda_lib.LAUNCHES["bvh8_intersect"] == before + 1
        assert _bvh8_equal(got, want)
    if case == "deep" and not any_hit:
        assert work["dropped_pushes"] > 0
    if case in ("inactive", "n0"):
        assert work["lane_steps"] == 0
    else:
        assert int((want[1] >= 0).sum()) > 0 or case == "n1"


def test_bvh8_kernel_refuses_misaligned_table(card):
    """The kernel reads rows as float4s: a table that starts off a 16-byte
    boundary raises."""
    rows = torch.from_numpy(bvh8.build_table(*soup("tracer"))).cuda()
    store = torch.empty(rows.numel() + 1, device="cuda")
    table = store[1:].view(rows.shape)
    table.copy_(rows)
    args = bvh8.ray_inputs(*(torch.from_numpy(x).cuda() for x in rays(64)[:2]))
    with pytest.raises(ValueError, match="16-byte"):
        bvh8.intersect_cuda(table, *args, any_hit=False)


def test_dense_bvh8_trace_on_card_matches_cpu(card):
    check_small_trace(dense_tracer_scene, "tracer_dense_bvh8")


# --- the importers, the last nodes and process_views (content paths) ------------


def test_content_paths_on_card_match_cpu(card):
    """content-glb-full's small version: the GLB frame, the node graph
    (Clear, Particles, Blit, CopyTextureToRam) and process_views."""
    from chip_smoke import check_small_content

    check_small_content()


def test_engine_material_world_on_card_matches_cpu(card):
    from chip_smoke import check_small_engine_materials

    check_small_engine_materials()


def test_glb_trace_on_card_matches_cpu(card):
    from chip_smoke import small_glb_trace

    check_small_trace(small_glb_trace, "content_glb_trace")


def test_splat_on_card_matches_cpu(card):
    """The particle splat (plain PyTorch) of a fountain at 640x384 over a
    depth buffer: within 1e-4 relative + 1e-6 on >= 99.9% of the pixels,
    zero where the CPU's is zero; the same valid count and overflow."""
    from sailor_tpu_torch.assets.particles import bake_fountain, sample_baked
    from sailor_tpu_torch.kernels.particles import splat_particles

    scene = flagship_scene(W, H, 4, 4, device="cpu")
    baked = torch.from_numpy(bake_fountain(frames=30, n=2048, fps=30).data)
    depth = torch.rand(H, W, generator=torch.Generator().manual_seed(3)) * 0.01
    out = {}
    for dev in ("cuda", "cpu"):
        f = scene.frame
        pos, radii, colors = sample_baked(baked.to(dev), 0.37, 30, 30)
        stats = {}
        img = splat_particles(pos, radii, colors, f.view_projection.to(dev),
                              f.projection.to(dev), depth.to(dev), width=W, height=H,
                              stats=stats)
        out[dev] = (img.cpu(), {k: int(v) for k, v in stats.items()})
    (g, gs), (r, rs) = out["cuda"], out["cpu"]
    assert gs == rs and rs["valid"] > 1000
    close = ((g - r).abs() <= 1e-4 * r.abs() + 1e-6).all(-1)
    assert close.float().mean().item() >= 0.999
    assert bool((g[r == 0] == 0).all())


def test_material_library_on_card_equals_cpu(card, tmp_path):
    """A MaterialLibrary's table built on the card equals the CPU's."""
    from chip_smoke import material_folder
    from sailor_tpu_torch.assets.materials import TENSOR_FIELDS, MaterialLibrary
    from sailor_tpu_torch.assets.registry import AssetRegistry

    paths = material_folder(str(tmp_path), 64)
    reg = AssetRegistry(str(tmp_path))
    libs = [MaterialLibrary(reg, paths, texture_size=64, mips=True, device=d)
            for d in ("cuda", "cpu")]
    for f in TENSOR_FIELDS:
        a, b = (getattr(lib.table, f) for lib in libs)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b), f


# --- the examples, the editor and the host runtime ----------------------------------


def test_example_frame_on_card_matches_cpu(card):
    """render_frame's scene at 256x128 with 16 lights, two frames, B3
    shading on both devices (full_frame_agreement)."""
    from chip_smoke import check_small_example_frame

    check_small_example_frame()


def test_example_trace_on_card_matches_cpu(card):
    from chip_smoke import example_trace_scene

    check_small_trace(example_trace_scene, "example_trace")


def test_editor_material_edit_on_card(card, monkeypatch):
    """editor-material-edit at 256x128 over material_world_doc(24, 16):
    every endpoint answers, the .mat edit reaches a later frame, no tick
    fails, the loop and server stop."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "FLAGSHIP", (256, 128, 24, 16))
    launches = chip_smoke.run_editor_material_edit(chip_smoke._card(), 256, 128, "cuda")
    assert launches["raster_worklist"] > 0 and launches["resolve_worklist"] > 0


def test_benchmarks_and_profiler_on_card(card):
    """The five suites on the card (the default device): PASSED, and bvh
    launches the BVH8 kernel; a synchronised profile_scope around it."""
    from sailor_tpu_torch.utils import benchmarks, profiler

    profiler.end_frame()
    before = cuda_lib.LAUNCHES["bvh8_intersect"]
    for name in benchmarks.ALL:
        with profiler.profile_scope(name, sync=True):
            assert f"{name}.benchmark PASSED" in benchmarks.run(name)
    assert cuda_lib.LAUNCHES["bvh8_intersect"] == before + 2
    assert set(profiler.end_frame()) == set(benchmarks.ALL)
