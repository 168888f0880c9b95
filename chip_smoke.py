#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sailor_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and the CUDA toolkit (nvcc); it imports nothing of JAX.

Phases, each printed as it ends:
  1. card: nvidia-smi's name and power limit, torch's device name;
  2. build: compile the CUDA kernels (sailor_tpu_torch/csrc) and load them;
  3. kernels: each kernel of the frame's paths against its plain PyTorch
     version on the flagship frame's own inputs (1920x1088, 1001 lights,
     96 objects), with the tolerance stated, timed with CUDA events, with
     the bound of each: B1-B3 of the work-list frame (B1 bit-equal, also
     with z bounds and on a crafted tile of several runs, and its mapping's
     plain model ``worklist_runs`` with the tiles' imbalance and pixel
     tests; B3 also with spot lights and a shadow factor), then the raster
     variants B7 (both plane forms, on B1's kernel: also on the crafted
     tile, and its mapping's plain model over the windows), B8 (B1's
     kernel over each tile's window span: also on the crafted tile) and B9
     (B1's kernel over each tile's bin slots, rows read by id: every pass
     of a dense frame, with and without the AABB clamp), each also with z
     bounds, bit-equal, and each held to the plain model of its mapping
     (``dma_runs``, ``dense_runs``), and the grid-k resolve B10 on B7's
     winners;
  4. raster configurations: the flagship frame in each raster
     configuration the reference's frame graph accepts (work list, dense,
     dma, grid-k stream, its MXU form, the gather resolve), 1 warm-up + 5
     frames each: frame ms, BinOverflow, launches per frame; Depth and
     TriId held to the work-list frame's (the dense frame to B1 and the
     MXU frame to its plain twin, each over its own setup), Final to the
     work-list frame's on all but 16 pixels;
  5. frame: the flagship scene through FrameGraph with the minimal graph
     (DepthPrepass -> LinearizeDepth -> LightCulling -> RenderScene ->
     EyeAdaptation): 1 warm-up + 5 frames with the state threaded through;
     launch counts of that run, frame and per-node times, peak memory, one
     profiled frame, the per-node cost of the float64 fused multiply-add
     emulation (core.math3d.fma); the output is checked (finite, in [0, 1],
     coverage > 0) and a 256x128 frame on the card is held against the same
     frame on the CPU path, in every raster configuration;
  6. rasterize: raster.rasterize on the flagship geometry at 1920x1088
     (capacity 1024, 4 rounds), timed, with its stats;
  6b. shadow kernels: B1 on each of the four sun cascades' inputs
     (1024x1024, ``cull="none"``, ``clip=False``) bit-equal to its twin,
     cascade 0 timed with its bound; B3 with the frame's EVSM shadow factor
     against its twin (relative 1e-5);
  6c. frame[shadow_hiz]: the flagship scene through the shadowed,
     HiZ-culled graph (DepthPrepass with the HiZ cull -> LinearizeDepth ->
     LightCulling -> ShadowPrepass -> DepthHighZ -> RenderScene with the
     EVSM factor -> EyeAdaptation; ``SHADOW_HIZ_CONFIG``): 1 warm-up (dirty:
     B1 5 times) + 5 cached frames (B1 once), launches checked per frame,
     HiZCulledCount of each, frame 2 against frame 1 (maps bit-equal; Depth
     and TriId equal but where frame 1's winner was culled, which the
     reference's cull does too; Main equal outside those pixels' light
     tiles), 3 frames made dirty again, per-node ms of a cached and a
     dirty frame, peak memory and a profiled cached frame; later a 256x128
     shadowed frame on the card is held against the CPU path;
  6d. frame[full]: the flagship scene through all of
     content/DefaultRenderer.renderer (``FULL_CONFIG``: bench.py's config
     with the reference's defaults): 1 warm-up (dirty cascades) + 5 cached
     frames, ``prepare`` before each, launches checked per frame (B1 5 / 1,
     B2 and B3 once), HiZCulledCount of each, per-node ms of a cached
     frame and of a frame whose sky the turned camera made dirty, the
     environment's full bake and one incremental face (``prepare`` timed),
     peak memory, the output checked, a profiled cached frame; later the
     card's HiZ cull is held to the CPU path at a nonzero count (the
     occlusion scene, two frames: HiZCulledCount, Depth and TriId exact)
     and a 256x128 DefaultRenderer frame, two frames (the second turned,
     its sun moved), is held to the CPU path;
  6e. queues: flagship_queue_scene (the flagship geometry, lights and
     camera; a third of the objects Opaque, a third Masked with striped
     alpha, a third Transparent, procedural albedo and normal maps) at
     1920x1088: the material forms of the path's kernels against their
     plain versions on its own rows (B1 z-bounded on RenderTransparent's
     two-sided setup, bit-equal; B2's 29 planes from the 49-column rows of
     the opaque and masked bin sets and its 5-plane alpha emit; B10's 29
     planes from 49-column grid-k bins; B2's bar); then frame[queues]: all
     of content/DefaultRenderer.renderer (``QUEUE_CONFIG``: FULL_CONFIG
     with 3 masked and 3 transparent layers), 1 warm-up + 5 frames with
     ``prepare`` before each, launches checked per frame (B1, B2 full and
     alpha, B3), the masked peel's layers, the synchronising calls of a
     cached frame, per-node ms, peak memory, a profiled cached frame, and
     one frame on the grid-k path (B7 and B10); later a 256x128 queue
     frame on the card is held to the CPU path;
  6f. engine: the engine loop through the whole DefaultRenderer frame.
     engine-editor-world: ``python -m sailor_tpu_torch`` run in process
     over a temporary copy of content/ (Editor.world, 1920x1088, 8
     frames, the console's stats.memory and profile): frame ms and
     synchronising calls of each frame, peak memory, the PNG checked, B1
     and B2 launched and B3 not (the CLI's config shades plainly), a
     profiled frame. engine-flagship-world: EngineLoop over
     ``flagship_world_doc(1000, 96)`` (1,099 game objects, 1,001 lights,
     an orbiting camera) with FULL_CONFIG, 1 warm-up + 5 frames: host ms
     of world.tick, scene_view and push_frame, frame ms, synchronising
     calls by step, B1-B3 launches checked per frame, peak memory,
     per-node ms, a profiled frame. Then flagship_world_doc(24, 6) at 256x128, 2
     frames, on the card against the CPU path, and a frame graph that
     raises torch.AcceleratorError once: the frame retries on the card;
  6g. night: engine-night-hud, the flagship world through EngineLoop at
     night (the sun below the horizon, stars.procedural(4096), the stats
     HUD built every frame, a debug box on each object, the uncharted2
     tonemap), 1 warm-up + 5 frames: host ms of the HUD, tick, scene_view
     and push_frame, frame ms, syncs by step, B1-B3 launches checked per
     frame, peak memory, per-node ms of a moving and a sky-dirty frame,
     the Sky node with and without the stars (the star term lighting
     > 1000 pixels), the star term alone, three frames whose every B1-B3
     launch is held to its twin, a profiled frame; then a 256x128 night
     frame pair on the card against the CPU path (night_frame_agreement;
     the debug pixels and the HUD composite exact);
  6h. content: content-glb-full, the flagship scene's geometry written as a
     GLB at run time (``flagship_glb``: one node a mesh, 8 materials,
     procedural_test_maps(0, 256) as embedded PNG albedo and normal maps)
     and read back through the asset registry (gltf.load_merged, the
     port's PNG decoder) as tests/test_golden.py's render_content does,
     through all of DefaultRenderer.renderer at 1920x1088: 1 warm-up + 5
     frames beside the untextured flagship-full frame in turns, the
     importer's host ms, syncs, launches (B1-B3 checked), peak memory,
     per-node ms; then the node graph (Clear, Particles with a baked
     4096-particle fountain, Blit into a 480x272 thumbnail,
     CopyTextureToRam) for 1 + 5 frames (Particles ms, particles valid,
     bins' overflow, the thumbnail's shape) and ``process_views`` with two
     cameras over two steps (each view's ms). engine-material-world:
     EngineLoop over the flagship world with a MaterialLibrary of 8 .mat
     files written at run time (PNG maps, a Masked and a Transparent
     material), 1 + 5 frames, then a .mat edit, the hot reload (rebuild
     ms) and frame 7: the edited material's pixels change, the others
     hold. Then 256x128 versions of each on the card against the CPU path;
  6i. content-jpeg-full: the content GLB with its albedo and normal maps as
     2048 x 2048 baseline JPEGs (``map_jpeg``, this script's own writer:
     4:2:0, the Annex K tables at quality 90, a restart interval), loaded
     through the registry (the port's JPEG decoder) and rendered through
     all of DefaultRenderer.renderer at 1920x1088, 1 warm-up + 5 frames in
     turns with content-glb-full's PNG frame: each texture's decode ms and
     MP/s, the importer's ms, frame ms, syncs, B1-B3 launches, peak
     memory, per-node ms, one frame whose every B1-B3 launch is held to
     its twin; a 256x128 frame on the card against the CPU path. Then
     hiz-heavy: tools/time_hiz.py's scene (a wall before 2,000 cubes, 1,000
     lights) at 1920x1088 with the tool's config, hiz_culling on and off, 1
     warm-up + 5 frames each in turns: frame ms, the culled count of each
     frame (> 0 after frame 1), syncs, B1-B3 launches, per-node ms of
     DepthPrepass, DepthHighZ and RenderScene; frame 2 held to frame 1
     (``compare_culled_frame``); content-jpeg-full's two maps are written
     once a run (``content_jpegs``) and reused here;
  6j. content-jpeg-codings: content-jpeg-full's 2048 x 2048 albedo
     coefficients arithmetic-coded (SOF9) and its normal map as a
     progressive arithmetic-coded file cut after the DC scan and the first
     luma AC scan (SOF10; the decoder smooths its blocks as libjpeg-turbo
     does), each decode's ms and MP/s, the arithmetic map held bit for bit
     to its Huffman source; at 256 px every new coding (SOF9, SOF10 whole
     and cut, CMYK and YCCK Adobe files, lossless SOF3 with three
     predictors, a DNL segment) decoded by the C++ and held bit for bit to
     the plain decode; then the content GLB with the arithmetic albedo
     and the cut normal map through all of DefaultRenderer.renderer at
     1920x1088, its frame (Depth, TriId, maps, Sky, Main, Final) equal bit
     for bit to the frame whose albedo is the Huffman map, B1-B3 launched,
     and one frame whose every B1-B3 launch is held to its twin;
  7. tracer kernels: the sweep intersector's kernels (B4 slab entry with
     the visit tables, B5 cluster sweep and B6 dense-grid sweep, closest
     and any hit) against their plain versions on the path tracer's own
     rays (bench tracer scene, 512x512: the swizzled camera rays and the
     incoherent bounce-1 rays of one sample and their shadow rays): B4's
     feature rows and four visit tables bit-equal, one launch with no host
     sync, its visit order equal to the plain model of the rank rule
     (``visit_order``); t bits
     and ids equal, B6 also to B5, timed with CUDA events, with the bound of
     each, the lane use and the live rays a walked pair (``packed_walk``);
     then all three on the bounce-1 passes with 0, 1, 33 and all rays of a
     sub-block live;
  8. trace: the bench tracer scene rendered by ``render_cached`` at
     512x512, 4 bounces, 16 spp (the bench's 64 spp cut to 16): 1 warm-up +
     3 timed renders, Mrays/s, peak memory, launches per render (B4 = B5 =
     2 * bounces * spp), the device idle share and the kernels of one
     profiled sample (with each port kernel's launches and mean device
     time); the image is checked (finite, >= 0) and a 64x64 render on the card is held
     against the same render on the CPU path with the same uniforms;
  8b. content-glb-trace: the material-ball scene written as a GLB (9
     materials, the procedural albedo embedded as PNG) and traced as
     examples/trace.py --gltf does (render_cached, the default sky baked)
     at 512x512, 4 bounces, 4 spp: 1 warm-up + 3 renders beside renders of
     the material-ball scene built in code, in turns (Mrays/s, peak; B4
     and B5 launches checked), and a 64x64 render on the card against the
     CPU path;
  8c. content-jpeg-trace: the same GLB with the ground's albedo as a
     256-px JPEG, 1 warm-up + 3 renders in turns with content-glb-trace's
     PNG GLB (Mrays/s, peak; B4 and B5 launches checked);
  9. grid trace: the same scene with DMA_SWEEP off (B6 in place of B5) at
     4 spp: 1 warm-up + 2 renders, Mrays/s, peak memory, launches, a
     profiled sample; the image equals the B5 render's at the same seed;
 10. material balls: the tracer demo scene (examples/trace.py's: ground and
     eight spheres) at 512x512, 4 bounces, 4 spp, with the default
     procedural sky baked for miss rays and procedural albedo, normal, ORM
     and emissive maps on the ground: 1 warm-up + 2 renders with
     ``render_cached``'s defaults (and a profiled sample), and again with
     sample_batch=2 and SAILOR_SWEEP_SORT=1; ms, Mrays/s, peak memory,
     finite and >= 0;
 11. small renders: 64x64 renders of the textured material balls with the
     sky, and of the tracer scene on B6, on the card against the CPU path;
 12. bvh8 kernel: the BVH8 traversal (csrc/bvh8.cu, no TPU counterpart;
     its registers, shared and local bytes and resident blocks printed)
     against its plain twin on the bounce-1 rays and their shadow rays of
     both BVH8 cells (512x512; 4 pooled samples of the bench tracer scene,
     one sample of the dense scene): t, tri, u, v bit-equal, timed with
     CUDA events in turns with the one-thread-a-ray kernel it replaced
     (tests/torch_bvh8_thread_per_ray.cu, built beside the port's kernels;
     ``parent_ms``), its bound from the rows the twin counts, dropped
     pushes, the lane use of both warp schedules (the old one from the
     twin's counts, the kernel's from its plain model ``bvh8_schedule``);
 13. BVH8 cells, each 1 warm-up + 2 renders through ``render_cached`` at
     512x512, 4 bounces, every pass on the BVH8 traversal (launches
     checked: 2 * bounces * passes, no sweep, no slab entry; then the
     same renders on the one-thread-a-ray kernel, the same image): tracer-512-
     batch4 (the bench tracer scene with sample_batch 4, whose sweep table
     the reference's rule sends away, 16 spp) and tracer-512-dense
     (``scenes.dense_tracer_scene``, 294,914 triangles, "auto" builds no
     sweep, 4 spp: the host table build timed, a profiled 1-spp sample);
     render ms, Mrays/s, peak bytes against tracer-512's;
 14. a 64x64 render of the dense scene (BVH8 route) on the card against
     the CPU path;
 14b. sweep-clusters: the tracer scene's sweep at clusters 64-1024, B4-B6
     held to their twins on each size's own passes (``run_sweep_clusters``);
 14c. sweep-rayblocks: the sweep at ten (RAY_BLOCK, SUB) pairs, each with
     its own tracer-512 sample and route, B4-B6 held to their twins and
     timed on its passes, time_sweep at (4096, 512) in a subprocess and a
     64x64 render at (1536, 192) against the CPU path
     (``run_sweep_rayblocks``);
 15. example-frame (after the content phase): ``python -m
     sailor_tpu_torch.examples.render_frame`` in process at 1920x1088 with
     1000 lights and 5 timed frames (B3 shades on the card): each frame's
     ms, overflow, B1-B3 launches and syncs (``profile_scope(sync=True)``
     around each, ``end_frame()`` printed), peak memory, the PNG checked,
     a frame under ``profiler.device_trace`` whose trace names B1-B3, a
     profiled frame; then the example's scene at 256x128 with 16 lights on the card against the
     CPU path;
 16. editor-material-edit: EditorWebApp over an EditorServer (the material
     world, 8 .mat files, the camera still) at 1920x1088 with editor_web's
     config, served on 127.0.0.1:0 with its render loop: every GET
     endpoint, an object moved, a .mat's albedo edited over
     /api/asset/update and /api/frame.png polled until a frame after the
     edit, whose edited material's pixels changed; ticks, ms a tick, ms
     from the edit to the frame, no failed tick, a profiled tick;
 17. example-trace (after the BVH8 cells): ``python -m
     sailor_tpu_torch.examples.trace`` in process at 512x512, 16 spp, 4
     bounces, then ``--gltf`` on a GLB written at run time and ``--sky`` at
     4 spp: render ms, Mrays/s, launches by route; a 64x64 render of the
     example's scene on the card against the CPU path;
 18. host-runtime: the five ``<suite>.benchmark`` console commands on the
     card (bvh launches the BVH8 kernel), ``stats.memory`` with the native
     multipool line, and a GLB, its PNG maps and 8 .mat files through
     ``load_async`` beside the synchronous loads (equal, host ms).
 19. sharded (``sailor_tpu_torch.parallel``; the shards share the one
     card, each in its own thread and stream): the mesh's placement;
     ``FrameGraph.process_sharded`` of the flagship scene through
     DefaultRenderer.renderer at 1920x1088 over 2 shards, 1 warm-up + 3
     frames (ms, launches a frame), one frame with every B1, B2 and B3
     launch of both shards held to its twin, Main and Final against the
     unsharded frame (differences printed), peak memory;
     ``sharded_forward_frame`` at 1920x1088 over 2 shards (B9 a pass a
     shard, bit-equal to its twin, BinOverflow a shard, against 1 shard);
     ``sharded_path_trace`` at 512x512 over 4 shards, 4 spp (B4 and B5),
     bit-equal to ``trace_rays`` with the same uniforms; a 128x256 frame
     over 8 shards on the card against the CPU path; the shards of one
     card take host turns (``parallel.mesh._Turn``);
 20. tools and decoders: ``python -m sailor_tpu_torch.tools.time_sweep``
     (256x256), ``profile_trace --small``, ``time_hiz`` (200 cubes, 100
     lights, 1 frame) and ``profile_frame --small --frames 2`` on the
     card; BMP, TGA, Radiance HDR, GIF and Adam7 PNG files written by the
     script read back exactly, and a JPEG's C++ decode equal to the plain
     Python decoder's.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failure ends the run with
a non-zero exit code and no result line.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

FLAGSHIP = (1920, 1088, 1000, 96)  # width, height, point lights, objects
SLICE_CONFIG = {
    "z_far": 150.0, "bin_capacity": 1024, "bin_rounds": 4,
    "max_lights_per_tile": 128, "pallas_shading": True, "fused_resolve": True,
    "raster_mode": "stream", "raster_worklist": True,
    "light_coarse_capacity": 256, "hiz_culling": False, "tonemap": "aces",
    "ldr_dither": True,
}
MINIMAL_GRAPH = ["DepthPrepass", "LinearizeDepth", "LightCulling",
                 "RenderScene", "EyeAdaptation"]
# the shadowed, HiZ-culled frame: bench.py's flagship config with the
# reference's defaults for HiZ culling, the CSM cache and the cascades, and
# DefaultRenderer.renderer's node order without the nodes not yet ported
SHADOW_HIZ_CONFIG = dict(
    SLICE_CONFIG, hiz_culling=True, csm_cache=True, shadow_resolution=1024,
    shadow_bin_capacity=512, shadow_stride=4)
SHADOW_HIZ_GRAPH = ["DepthPrepass", "LinearizeDepth", "LightCulling", "ShadowPrepass",
                    "DepthHighZ", "RenderScene", "EyeAdaptation"]
SHADOW_HIZ_VALUES = {"Shadow.EvsmBlurRadius": 4}
# the whole DefaultRenderer frame: bench.py's flagship config (bench.py:338-350)
# with the reference's defaults for the rest
RENDERER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "content",
                        "DefaultRenderer.renderer")
FULL_CONFIG = dict(
    SHADOW_HIZ_CONFIG, env_resolution=32, raster_mxu=False, sky_cache=True,
    sky_downsample=2, sky_clouds=True, cloud_stride=2, sky_cache_hz=4.0,
    env_incremental=True, ao_stride=2, ibl_stride=4)
TRACER = (512, 512, 4, 16)  # width, height, bounces, spp
TRACER_SPP_CUT = 4  # spp of the grid-sweep, material-ball and dense renders
BATCH4 = 4  # tracer-512-batch4's sample_batch: every pass leaves the sweep
# H100 SXM published peaks (NVIDIA data sheet), used for the bound
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def check(ok: bool, what: str) -> None:
    """Fail the run (an exception, so the exit code is not 0) unless ok."""
    if not ok:
        raise RuntimeError(what)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps launches, after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _wall_ms(fn) -> tuple[float, object]:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _span(lo, hi, first, last):
    """Per row, the count of pixel indices i in [first, last] whose centre
    i + 0.5 passes the raster's AABB test lo - 0.05 <= i + 0.5 <= hi + 0.05."""
    import torch

    a = torch.maximum(torch.ceil(lo.double() - 0.55), first)
    b = torch.minimum(torch.floor(hi.double() - 0.45), last)
    return torch.clamp(b - a + 1, min=0)


def raster_work(rows, big_rows, starts, counts, n_big, tiles_y, tiles_x,
                clamp=True):
    """What a tile raster must do on this data: (candidate rows, (pixel,
    candidate) pairs). Tile t walks rows[starts[t]:starts[t] + counts[t]]
    (columns as build_stream_rows lays them out: AABB at 12:16, id at 16);
    with the AABB clamp a live row is tested only at the tile's pixels
    inside its screen AABB (every other pixel fails the clamp), without it
    at all of them; the big list is tested at the screen's pixels inside
    its AABB."""
    import torch

    from sailor_tpu_torch.raster import tile_raster as tr

    dev = rows.device
    c = counts.long()
    tile = torch.repeat_interleave(torch.arange(c.numel(), device=dev), c)
    first = torch.cumsum(c, 0) - c
    idx = starts.long()[tile] + torch.arange(tile.numel(), device=dev) - first[tile]
    r = rows[idx]
    x0 = (tile % tiles_x).double() * tr.TILE_W
    y0 = (tile // tiles_x).double() * tr.TILE_H
    live = r[:, 16] >= 0
    if clamp:
        pairs = (_span(r[:, 12], r[:, 13], x0, x0 + tr.TILE_W - 1)
                 * _span(r[:, 14], r[:, 15], y0, y0 + tr.TILE_H - 1))[live].sum()
    else:
        pairs = live.sum().double() * (tr.TILE_W * tr.TILE_H)
    b = big_rows[:int(n_big)]
    zero = torch.zeros(b.shape[0], dtype=torch.float64, device=dev)
    big_live = b[:, 16] >= 0
    pairs += (_span(b[:, 12], b[:, 13], zero, zero + tiles_x * tr.TILE_W - 1)
              * _span(b[:, 14], b[:, 15], zero, zero + tiles_y * tr.TILE_H - 1))[big_live].sum()
    return int(live.sum()) + int(big_live.sum()), int(pairs)


def worklist_plan(starts, counts, n_big, nbig_rows, ntiles, group=32, run_groups=None):
    """B1's and B7's plan (csrc/raster.cu ``plan_kernel``) on the host: the
    big list's groups, each tile's walk (rows starts .. starts + counts) in
    groups of ``group`` rows, and R, the groups a run, doubled from
    ``run_groups`` (RUN_GROUPS if None) until the runs of the tiles with
    more than one fit ``worklist_slots``. Returns (R, nb, groups per
    tile)."""
    from sailor_tpu_torch.raster import tile_raster as tr

    nb = -(-min(max(int(n_big), 0), nbig_rows) // group)
    s, c = starts.long().cpu(), counts.long().cpu()
    groups = nb + (s + c + group - 1) // group - s // group
    R, slots = run_groups or tr.RUN_GROUPS, tr.worklist_slots(ntiles)
    while True:
        n = (groups + R - 1) // R
        if int(n[n > 1].sum()) <= slots:
            return R, nb, groups.tolist()
        R *= 2


def worklist_runs(rows, big_rows, starts, counts, n_big, *, tiles_y, tiles_x,
                  z_bounds=None, stats=None, group=32, mxu=False, run_groups=None):
    """B1's and B7's mapping on the card (csrc/raster.cu) in plain
    PyTorch: each tile's walk (the big list's groups, then its rows starts
    .. starts + counts widened to whole groups of ``group`` rows: B1's
    ``worklist_span``, or B7's windows: ``stream_runs``) cut into runs of
    R groups (``worklist_plan``); in each run the rows of a group are
    tested only in the 16x8-pixel warp rectangles whose ballot takes them
    (live, AABB touching the strip and the rectangle), merged group by
    group (the kernel may split a group's (rectangle, row) pairs over its
    warps: the in-group rule does not depend on the order), and the runs'
    partials are merged in run order, a later run taking a pixel only with
    strictly greater z. ``mxu``: B7's MXU plane form (with groups of 128).
    Returns (depth, tid) as the twin does; ``stats`` (a dict) gets R, the
    runs launched, the pixel tests (128 for each (row, rectangle) the
    ballots take), for comparison those of the earlier mapping that tested
    a strip's 1024 pixels for each live row touching the strip, and the
    most rows one rectangle takes in a run."""
    import torch

    from sailor_tpu_torch.raster import tile_raster as tr

    dev = rows.device
    ntiles = tiles_y * tiles_x
    R, nb, groups = worklist_plan(starts, counts, n_big, big_rows.shape[0], ntiles, group,
                                  run_groups)
    big = tr._rows_or_dead(big_rows, nb * group)
    lo = (starts.long().cpu() // group * group).tolist()
    th = tr.check_tile_h()
    iy = torch.arange(th, device=dev)[:, None].expand(th, tr.TILE_W)
    ix = torch.arange(tr.TILE_W, device=dev)[None, :].expand(th, tr.TILE_W)
    rect = ((iy // 8) * 8 + ix // 16).reshape(-1)  # the warp rectangle of each pixel
    corner = torch.arange(tr.strips() * 8, device=dev)  # 8 rectangles a strip
    rx = (corner % 8 * 16).float() + 0.5  # each rectangle's outermost centres, tile-local
    ry = (corner // 8 * 8).float() + 0.5
    tests, strip_tests, runs, longest = 0, 0, 0, 0

    def tile_rows(t, px, py, zl, zh):
        nonlocal tests, strip_tests, runs, longest
        ti, tj = divmod(t, tiles_x)
        ox, oy = float(tj * tr.TILE_W), float(ti * th)
        x_lo, x_hi, y_lo, y_hi = rx + ox, rx + ox + 15.0, ry + oy, ry + oy + 7.0
        sx_lo, sx_hi = ox + 0.5, ox + tr.TILE_W - 0.5
        test = tr._test_chunk_mxu(ox, oy) if mxu else tr._test_chunk
        walk = torch.cat([big, rows[lo[t]:lo[t] + (groups[t] - nb) * group]])
        best = tr._empty_best(dev)
        nruns = max(1, -(-groups[t] // R))
        runs += nruns
        for r in range(nruns):
            part = tr._empty_best(dev)
            sel = walk[r * R * group:(r + 1) * R * group]
            if sel.shape[0]:
                zm, ids = test(sel, px, py, zl, zh)
                a = [sel[:, i:i + 1] for i in range(12, 16)]
                strip_out = ((sx_hi < a[0] + tr.EPS) | (sx_lo > a[1] - tr.EPS)
                             | (y_hi < a[2] + tr.EPS) | (y_lo > a[3] - tr.EPS))
                rect_out = (x_hi < a[0] + tr.EPS) | (x_lo > a[1] - tr.EPS)
                take = (ids >= 0)[:, None] & ~strip_out & ~rect_out  # (rows, rectangles)
                tests += int(take.sum()) * 128
                strip_tests += int(((ids >= 0)[:, None] & ~strip_out)[:, ::8].sum()) * 1024
                longest = max(longest, int(take.sum(0).max()))
                zm = torch.where(take[:, rect], zm, torch.full_like(zm, -1.0))
                g = sel.shape[0] // group
                part = tr._merge_groups(*part, zm.reshape(g, group, -1), ids.reshape(g, group))
            later = part[0] > best[0]
            best = (torch.where(later, part[0], best[0]), torch.where(later, part[1], best[1]))
        return best

    out = tr._raster_tiles_plain(tiles_y, tiles_x, z_bounds, dev, tile_rows)
    if stats is not None:
        stats.update(run_groups=R, runs=runs, pixel_tests=tests, strip_tests=strip_tests,
                     longest_rectangle_walk=longest)
    return out


def stream_span(c0, spt, chunk):
    """B7's walk as a row span per tile (starts, counts): the windows c0 ..
    c0 + max(spt, 1) - 1 of ``chunk`` rows."""
    import torch

    return c0 * chunk, torch.clamp(spt, min=1) * chunk


def stream_runs(rows, big_rows, c0, spt, n_big, *, chunk, mxu, run_rows=None, **kw):
    """B7's mapping on the card (``worklist_runs`` over the windows, in
    groups of 32, or of 128 with the MXU plane form), its runs starting at
    ``run_rows`` rows (the wrapper's STREAM_RUN_ROWS by default)."""
    from sailor_tpu_torch.raster import tile_raster as tr

    group = tr.CHUNK_MXU if mxu else tr.CHUNK
    return worklist_runs(rows, big_rows, *stream_span(c0, spt, chunk), n_big, group=group,
                         mxu=mxu, run_groups=(run_rows or tr.STREAM_RUN_ROWS) // group, **kw)


def dma_runs(rows, big_rows, w0, nw, n_big, *, dchunk, run_rows=None, **kw):
    """B8's mapping on the card (``worklist_runs`` over the rows w0 * dchunk
    .. (w0 + nw) * dchunk, in groups of 32), its runs starting at
    ``run_rows`` rows (the wrapper's DMA_RUN_ROWS by default)."""
    from sailor_tpu_torch.raster import tile_raster as tr

    return worklist_runs(rows, big_rows, w0 * dchunk, nw * dchunk, n_big,
                         run_groups=(run_rows or tr.DMA_RUN_ROWS) // tr.CHUNK, **kw)


def dense_slot_rows(table, ids):
    """B9's staged rows, one a slot of the bins (slots, 17): a live slot's
    table row (12 or 16 columns; with 12 the AABB open, (-inf, +inf, -inf,
    +inf)) and its id; a dead slot zeros and id -1, no table row read."""
    import torch

    live = ids >= 0
    rows = torch.zeros(ids.shape[0], 17, dtype=torch.float32, device=ids.device)
    rows[live, :table.shape[1]] = table[ids[live].long()]
    if table.shape[1] == 12:
        rows[live, 12:16] = torch.tensor([-float("inf"), float("inf"), -float("inf"),
                                          float("inf")], device=ids.device)
    rows[:, 16] = ids.to(torch.float32)
    return rows


def dense_starts(ids, ntiles):
    """The first slot t * C of each tile's bin: B9's walk of tile t is the
    row span t * C .. t * C + count of ``dense_slot_rows``."""
    import torch

    cap = ids.shape[0] // ntiles
    return torch.arange(0, ids.shape[0], cap, dtype=torch.int32, device=ids.device)


def dense_runs(table, ids, counts, *, run_rows=None, **kw):
    """B9's mapping on the card (``worklist_runs`` over each tile's slots,
    rows read by id: ``dense_slot_rows``; no big list), its runs starting at
    ``run_rows`` rows (the wrapper's DENSE_RUN_ROWS by default)."""
    import torch

    from sailor_tpu_torch.raster import tile_raster as tr

    rows = dense_slot_rows(table, ids)
    none = torch.zeros((), dtype=torch.int32, device=ids.device)
    return worklist_runs(rows, rows[:0], dense_starts(ids, counts.numel()), counts, none,
                         run_groups=(run_rows or tr.DENSE_RUN_ROWS) // tr.CHUNK, **kw)


def sub_entries(tables):
    """B4's own function from its tables: the sub-block entries (Rp // SUB,
    C) as int32 float bits in cluster order, e_sub[s, order[b, c]] =
    e_bits[s, c] for the sub-blocks s of ray block b."""
    e_bits, order = tables["e_bits"], tables["order"].long()
    order = order.repeat_interleave(e_bits.shape[0] // order.shape[0], 0)
    return e_bits.new_empty(e_bits.shape).scatter_(1, order, e_bits)


def visit_order(e_blk):
    """The visit order as csrc/slab_entry.cu computes it, by rank over the
    block entries' int32 bits (B, C): rank(c) = #{c': e[c'] < e[c]} +
    #{c' < c: e[c'] = e[c]}, order[rank(c)] = c."""
    import torch

    nc = e_blk.shape[1]
    col = torch.arange(nc, device=e_blk.device)
    e, v = e_blk[:, None, :], e_blk[:, :, None]  # e[b, ., c'] against v[b, c, .]
    rank = ((e < v) | ((e == v) & (col[None, None, :] < col[None, :, None]))).sum(2)
    return torch.empty_like(rank).scatter_(1, rank, col.expand_as(rank))


def heavy_tile_rows(seed=0):
    """A crafted work list for B1 (CPU tensors): two 64x128 tiles, rows of
    24 columns (the raster's 17 and padding). Tile 0 walks the 2 groups of
    a 40-row big list and 14 window groups (its segment starts at row 13,
    so it shares its first group with rows before it and its last with tile
    1): 16 groups, 4 runs of RUN_GROUPS. Near rows are repeated with larger
    ids, so equal z meets a larger id in the same group (the larger id
    wins), in the next group of the same run and four groups later, in the
    next run (the earlier copy wins). Returns (rows, big_rows, starts,
    counts, n_big, tiles_y, tiles_x)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    next_id = iter(range(10**6))

    def tri(cx, cy, size, z):
        ang = np.sort(rng.uniform(0.0, 2 * np.pi, 3))
        vx, vy = cx + size * np.cos(ang), cy + size * np.sin(ang)
        row = []
        for k in range(3):  # edge k opposite vertex k, positive inside, unit normal
            i, j = (k + 1) % 3, (k + 2) % 3
            a, b = vy[i] - vy[j], vx[j] - vx[i]
            c = -(a * vx[i] + b * vy[i])
            if a * vx[k] + b * vy[k] + c < 0:
                a, b, c = -a, -b, -c
            n = np.hypot(a, b)
            row += [a / n, b / n, c / n]
        gx, gy = rng.uniform(-5e-4, 5e-4, 2)
        row += [gx, gy, z - gx * cx - gy * cy, vx.min(), vx.max(), vy.min(), vy.max(),
                next(next_id)]
        return row + [0.0] * 7

    def rows_in(tile, n, zlo, zhi, smin, smax):
        return [tri(rng.uniform(0, 128) + 128 * tile, rng.uniform(0, 64),
                    rng.uniform(smin, smax), rng.uniform(zlo, zhi)) for _ in range(n)]

    walk = rows_in(0, 447, 0.1, 0.7, 6.0, 40.0) + rows_in(1, 17, 0.1, 0.7, 6.0, 40.0)
    for p in (40, 100, 170, 233, 300):  # a near row and its copies
        walk[p] = tri(rng.uniform(10, 118), rng.uniform(8, 56), rng.uniform(15, 30), 0.9)
        for q in (p + 1, p + 32, p + 128):
            walk[q] = walk[p][:16] + [next(next_id)] + walk[p][17:]
    dead = [0.0] * 16 + [-1.0] + [0.0] * 7
    rows = torch.tensor(walk + [dead] * (640 - len(walk)), dtype=torch.float32)
    big = torch.tensor([tri(rng.uniform(0, 256), rng.uniform(0, 64), rng.uniform(60, 200),
                            rng.uniform(0.02, 0.3)) for _ in range(40)] + [dead] * 24,
                       dtype=torch.float32)
    starts = torch.tensor([13, 434], dtype=torch.int32)
    counts = torch.tensor([421, 30], dtype=torch.int32)
    return rows, big, starts, counts, torch.tensor(40, dtype=torch.int32), 1, 2


def frame_inputs(scene, width, height):
    """The flagship frame's own kernel inputs, made by the graph's nodes."""
    from sailor_tpu_torch.framegraph import nodes as nodes_mod
    from sailor_tpu_torch.framegraph.graph import RenderContext, node_types
    from sailor_tpu_torch.raster import interpolate, tile_raster

    nodes = node_types()
    ctx = RenderContext(width=width, height=height, scene=scene, state={},
                        values={}, config=dict(SLICE_CONFIG))
    targets = {}
    for name in ("DepthPrepass", "LinearizeDepth", "LightCulling"):
        targets = nodes[name]().process(ctx, targets)
    sb = targets["StreamBins"][0]
    tw, th = tile_raster.TILE_W, tile_raster.TILE_H
    tiles_y, tiles_x = -(-height // th), -(-width // tw)
    inv_vp = nodes_mod.inverse_view_projection(scene.frame)
    gbuffer, _, _ = interpolate.resolve_gbuffer_stream(
        sb, targets["TriId"], inv_vp, scene.frame.camera_position,
        width=width, height=height, tiles_y=tiles_y, tiles_x=tiles_x)
    return sb, targets, inv_vp, gbuffer, tiles_y, tiles_x


def check_kernels(scene, width, height, card):
    import torch

    from sailor_tpu_torch.kernels import pbr_kernel
    from sailor_tpu_torch.raster import tile_raster as tr

    sb, targets, inv_vp, gb, tiles_y, tiles_x = frame_inputs(scene, width, height)
    rows, big, starts, counts, n_big = (sb["rows"], sb["big_rows"], sb["starts"],
                                        sb["counts"], sb["n_big"])
    results = []
    npix = tiles_y * tr.TILE_H * tiles_x * tr.TILE_W

    # ---- B1 raster: bit-equal to its twin, with and without z bounds, and
    # on a crafted tile split into several runs; the plain model of its
    # mapping (worklist_runs) too
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, chunk=128)
    d_k, t_k = tr.rasterize_worklist_cuda(rows, big, starts, counts, n_big, **kw)
    plain_ms, (d_p, t_p) = _wall_ms(
        lambda: tr.rasterize_worklist_plain(rows, big, starts, counts, n_big, **kw))
    ms = _time_ms(lambda: tr.rasterize_worklist_cuda(rows, big, starts, counts, n_big, **kw), 20)
    same = bool(torch.equal(d_k, d_p)) and bool(torch.equal(t_k, t_p))
    err = (d_k - d_p).abs().max().item()
    cand, pairs = raster_work(rows, big, starts, counts, n_big, tiles_y, tiles_x)
    # candidate rows' 17 raster columns read once, starts and counts, depth
    # and tid written; 16 flops per (pixel, candidate) pair: 4 planes of
    # fma + mul + add (an fma counts as two)
    bound, by = _bound(cand * 17 * 4 + counts.numel() * 8 + npix * 8, pairs * 16)
    print(f"kernel raster_worklist: bit_equal={same} max_abs_err(depth)={err:.3g} "
          f"tid_mismatch={int((t_k != t_p).sum())} ms={ms:.4f} plain_ms={plain_ms:.1f} "
          f"bound_ms={bound:.5f} ({by}) candidates={cand} pairs={pairs} "
          f"at {width}x{height} on {card}")
    check(same, "raster kernel disagrees with its plain version")
    stats = {}
    d_m, t_m = worklist_runs(rows, big, starts, counts, n_big, tiles_y=tiles_y,
                             tiles_x=tiles_x, stats=stats)
    check(bool(torch.equal(d_m, d_p)) and bool(torch.equal(t_m, t_p)),
          "the raster kernel's mapping disagrees with the twin")
    lo, hi = tr.worklist_span(starts, counts)
    walked = (hi - lo).float()
    print(f"raster_worklist mapping: rows_per_tile max={int(counts.max())} "
          f"mean={counts.float().mean().item():.2f} walked_rows_per_tile max={int(walked.max())} "
          f"mean={walked.mean().item():.2f} big_rows={int(n_big)} tiles={counts.numel()} "
          f"run_groups={stats['run_groups']} runs={stats['runs']} "
          f"blocks={stats['runs'] * tr.strips()} pixel_tests={stats['pixel_tests']} "
          f"bound_pairs={pairs} strip_mapping_tests={stats['strip_tests']} "
          f"longest_rectangle_walk={stats['longest_rectangle_walk']} of "
          f"{stats['run_groups'] * tr.CHUNK} rows a run")
    zb = (torch.zeros_like(d_k), torch.where(t_k >= 0, d_k, 2.0))
    d_k, t_k = tr.rasterize_worklist_cuda(rows, big, starts, counts, n_big, **kw, z_bounds=zb)
    d_p, t_p = tr.rasterize_worklist_plain(rows, big, starts, counts, n_big, **kw, z_bounds=zb)
    same = bool(torch.equal(d_k, d_p)) and bool(torch.equal(t_k, t_p))
    print(f"kernel raster_worklist[z_bounds]: bit_equal={same} covered={int((t_k >= 0).sum())}")
    check(same, "raster kernel disagrees with its plain version (z bounds)")
    check_heavy_tile()
    results.append(dict(name="raster_worklist", source="sailor_tpu_torch/csrc/raster.cu",
                        replaces="sailor_tpu/raster/tile_raster.py:442",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by))

    # ---- B2 resolve (full mode, 37 attribute columns): ray, barycentrics,
    # 12 lerps per covered pixel
    tid = t_k.contiguous()
    par = tr._resolve_params(inv_vp, scene.frame.camera_position, width, height, 0, rows.device)
    kw2 = dict(tiles_y=tiles_y, tiles_x=tiles_x, na=int(sb["na"]), chunk=int(sb["chunk"]))
    res = _resolve_check("resolve_worklist", tr.resolve_worklist_cuda, tr.resolve_worklist_plain,
                         (rows, big, tid, starts, counts, par), kw2, card, tid,
                         int(sb["na"]), 115)
    results.append(dict(name="resolve_worklist", source="sailor_tpu_torch/csrc/resolve.cu",
                        replaces="sailor_tpu/raster/tile_raster.py:1310", **res))

    # ---- B3 shade: relative 1e-5 (same operation order; rsqrt may differ by
    # an ulp), the light rows gathered in the kernel
    table = pbr_kernel.pack_lights(scene.lights)
    idx = targets["LightIndices"].to(torch.int32).contiguous()
    lc = targets["LightCounts"].to(torch.int32).contiguous()
    cam = scene.frame.camera_position.to(torch.float32).contiguous()
    args = (table, idx, lc, gb.albedo.contiguous(), gb.metallic.contiguous(),
            gb.roughness.contiguous(), gb.normal.contiguous(),
            gb.world_position.contiguous(), None, cam)
    c_k = pbr_kernel.shade_tiles_cuda(*args)
    plain_ms, c_p = _wall_ms(lambda: pbr_kernel.shade_tiles_plain(*args))
    ms = _time_ms(lambda: pbr_kernel.shade_tiles_cuda(*args), 20)
    err = (c_k - c_p).abs().max().item()
    rel = ((c_k - c_p).abs() / c_p.abs().clamp(min=1e-3)).max().item()
    live = int(lc.sum())
    pairs = live * 256  # (pixel, live light) pairs
    # G-buffer read (48 B) and radiance written (12 B) per pixel, each live
    # slot's index and light row once, the counts; 108 operations per
    # (pixel, point light), counted from the twin's _light_step without the
    # terms of the light or the pixel alone (130 before that count)
    bound, by = _bound(gb.metallic.numel() * 60 + live * 68 + lc.numel() * 4, pairs * 108)
    print(f"kernel shade_forward_plus: max_abs_err={err:.3g} max_rel_err={rel:.3g} "
          f"ms={ms:.4f} plain_ms={plain_ms:.1f} bound_ms={bound:.4f} ({by}) "
          f"mean_lights_per_tile={lc.float().mean().item():.2f} live_slots={live} "
          f"pack_bytes_not_gathered={idx.numel() * pbr_kernel.NP * 4} on {card}")
    check(rel <= 1e-5, "shade kernel disagrees with its plain version")
    check_spot_shadow(table, idx, lc, args[3:8], cam, card)
    results.append(dict(name="shade_forward_plus", source="sailor_tpu_torch/csrc/shade.cu",
                        replaces="sailor_tpu/kernels/pbr_pallas.py:48",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by))
    for r in results:
        r.update(route="cuda", library_ms=None)  # no single PyTorch call computes these
    return results


HEAVY_CHUNK = 128  # B7's and B8's windows on heavy_tile_rows (its 640 rows: 5 windows)


def heavy_tile_cases():
    """B1, B7 (both forms) and B8 on ``heavy_tile_rows``, on the card: per
    kernel name (kernel, twin, args, keywords, the plain model of the
    kernel's mapping, which takes the same)."""
    import torch

    from sailor_tpu_torch.raster import tile_raster as tr

    rows, big, starts, counts, n_big, ty, tx = (
        x.cuda() if torch.is_tensor(x) else x for x in heavy_tile_rows())
    kw = dict(tiles_y=ty, tiles_x=tx)
    cases = {"raster_worklist": (tr.rasterize_worklist_cuda, tr.rasterize_worklist_plain,
                                 (rows, big, starts, counts, n_big), kw, worklist_runs)}
    c0, spt, _ = tr.stream_windows(starts, counts, HEAVY_CHUNK, 16)
    for mxu in (False, True):
        cases["raster_stream_mxu" if mxu else "raster_stream"] = (
            tr.rasterize_stream_cuda, tr.rasterize_stream_plain, (rows, big, c0, spt, n_big),
            dict(kw, chunk=HEAVY_CHUNK, mxu=mxu), stream_runs)
    w0, nw = tr.dma_windows(starts, counts, HEAVY_CHUNK)
    cases["raster_dma"] = (tr.rasterize_dma_cuda, tr.rasterize_dma_plain,
                           (rows, big, w0, nw, n_big), dict(kw, dchunk=HEAVY_CHUNK), dma_runs)
    return cases


def check_heavy_tile():
    """B1, B7 (both forms) and B8 on ``heavy_tile_rows`` (a tile of several
    runs whose repeated rows tie in z in one group, across groups and
    across runs), with and without z bounds: bit-equal to the twin and to
    the model of the mapping."""
    import torch

    for name, (kernel, plain, args, kw, model) in heavy_tile_cases().items():
        zb = None
        for label in ("", ",z_bounds"):
            d_k, t_k = kernel(*args, **kw, z_bounds=zb)
            d_p, t_p = plain(*args, **kw, z_bounds=zb)
            stats = {}
            d_m, t_m = model(*args, **kw, z_bounds=zb, stats=stats)
            same = all(bool(torch.equal(a, b)) for a, b in ((d_k, d_p), (t_k, t_p),
                                                            (d_m, d_p), (t_m, t_p)))
            print(f"kernel {name}[heavy_tile{label}]: bit_equal={same} runs={stats['runs']} "
                  f"run_groups={stats['run_groups']} covered={int((t_k >= 0).sum())}")
            check(same and stats["runs"] > kw["tiles_y"] * kw["tiles_x"],
                  f"{name} kernel disagrees with its plain version on the heavy tile{label}")
            zb = (torch.zeros_like(d_k), torch.where(t_k >= 0, d_k, 2.0))


def spot_shadow_lights(table, seed=5):
    """The light table with a third of its point lights turned into spot
    lights (cone cutoffs cos 20 and 35 degrees, aimed down at the scene)."""
    import torch

    from sailor_tpu_torch.kernels.lights import SPOT

    gen = torch.Generator(device=table.device).manual_seed(seed)
    t = table.clone()
    spot = (torch.rand(t.shape[0], generator=gen, device=t.device) < 1 / 3) & (t[:, 15] == 1.0)
    d = torch.randn(t.shape[0], 3, generator=gen, device=t.device)
    d[:, 1] = -d[:, 1].abs() - 1.0
    d = d / d.norm(dim=1, keepdim=True)
    t[spot, 3:6] = d[spot]
    t[spot, 12] = 0.9397
    t[spot, 13] = 0.8192
    t[spot, 15] = float(SPOT)
    return t


def check_spot_shadow(table, idx, counts, gbuffer, cam, card):
    """B3 against its twin on the frame's G-buffer (albedo, metallic,
    roughness, normal, position) and light lists, with a third of the point
    lights made spot lights and a shadow factor."""
    import torch

    from sailor_tpu_torch.kernels import pbr_kernel

    t = spot_shadow_lights(table)
    gen = torch.Generator(device=t.device).manual_seed(6)
    shadow = torch.rand(gbuffer[1].shape, generator=gen, device=t.device)
    args = (t, idx, counts, *gbuffer, shadow, cam)
    got = pbr_kernel.shade_tiles_cuda(*args)
    ref = pbr_kernel.shade_tiles_plain(*args)
    rel = ((got - ref).abs() / ref.abs().clamp(min=1e-3)).max().item()
    print(f"kernel shade_forward_plus[spot,shadow]: max_rel_err={rel:.3g} "
          f"spot_lights={int((t[:, 15] == 2.0).sum())} on {card}")
    check(rel <= 1e-5, "shade kernel disagrees with its plain version (spot lights, shadow)")


RASTER_CONFIGS = {  # the frame's raster configurations beside the work-list one
    "dense": {"raster_mode": "dense"},
    "dma": {"raster_mode": "dma"},
    "stream": {"raster_worklist": False},
    "stream_mxu": {"raster_worklist": False, "raster_mxu": True},
    "gather_resolve": {"fused_resolve": False},
}
# the kernels each configuration's frame must launch
CONFIG_KERNELS = {
    "worklist": ("raster_worklist", "resolve_worklist", "shade_forward_plus"),
    "dense": ("raster_dense", "shade_forward_plus"),
    "dma": ("raster_dma", "shade_forward_plus"),
    "stream": ("raster_stream", "resolve_stream", "shade_forward_plus"),
    "stream_mxu": ("raster_stream_mxu", "resolve_stream", "shade_forward_plus"),
    "gather_resolve": ("raster_worklist", "shade_forward_plus"),
}


def _resolve_check(name, kernel, plain, args, kw, card, tid, na, flops_px):
    """One resolve form against its plain twin: <= 1e-5 on all but 1e-5 of
    values and every value within 1e-4 * (1 + |plain|) (B2's bar);
    CUDA-event ms, the twin's ms and the bound (tid read, the winners'
    rows read once, the planes written; ``flops_px`` a covered pixel)."""
    import torch

    p_k = torch.stack(kernel(*args, **kw))
    plain_ms, p_p = _wall_ms(lambda: torch.stack(plain(*args, **kw)))
    ms = _time_ms(lambda: kernel(*args, **kw), 20)
    diff = (p_k - p_p).abs()
    err = diff.max().item()
    frac = (diff > 1e-5).float().mean().item()
    npix = tid.numel()
    winners = int(torch.unique(tid[tid >= 0]).numel())
    bound, by = _bound(npix * 4 + winners * (1 + na) * 4 + npix * p_k.shape[0] * 4,
                       int((tid >= 0).sum()) * flops_px)
    print(f"kernel {name}: planes={p_k.shape[0]} columns={na} max_abs_err={err:.3g} "
          f"frac_err>1e-5={frac:.3g} ms={ms:.4f} plain_ms={plain_ms:.1f} "
          f"bound_ms={bound:.4f} ({by}) covered={int((tid >= 0).sum())} on {card}")
    check(frac <= 1e-5 and bool((diff <= 1e-4 * (1 + p_p.abs())).all()),
          f"{name} kernel disagrees with its plain version")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)


def _raster_check(name, kernel, plain, args, kw, card, work, extra_bytes=0, reps=10):
    """One raster variant against its plain twin on the card: depth and
    tid bit-equal; CUDA-event ms, the twin's ms and the bound from
    ``work`` = (candidate rows, pairs, bytes a candidate row)."""
    import torch

    d_k, t_k = kernel(*args, **kw)
    plain_ms, (d_p, t_p) = _wall_ms(lambda: plain(*args, **kw))
    ms = _time_ms(lambda: kernel(*args, **kw), reps)
    same = bool(torch.equal(d_k, d_p)) and bool(torch.equal(t_k, t_p))
    err = (d_k - d_p).abs().max().item()
    cand, pairs, row_bytes = work
    npix = d_k.numel()
    # candidate rows read once, depth and tid written (8 bytes a pixel);
    # 16 flops per (pixel, candidate) pair: 4 planes of fma + mul + add
    bound, by = _bound(cand * row_bytes + npix * 8 + extra_bytes, pairs * 16)
    print(f"kernel {name}: bit_equal={same} max_abs_err(depth)={err:.3g} "
          f"tid_mismatch={int((t_k != t_p).sum())} ms={ms:.4f} plain_ms={plain_ms:.1f} "
          f"bound_ms={bound:.5f} ({by}) candidates={cand} pairs={pairs} "
          f"covered={int((t_k >= 0).sum())} on {card}")
    check(same, f"{name} kernel disagrees with its plain version")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by), d_k, t_k


def _mapping_check(name, model, args, kw, kernel_out, walked, pairs):
    """The plain model of a kernel's mapping (runs, rectangles) on the
    kernel's inputs: depth and tid bit-equal to the kernel's; prints its
    runs, walked rows and pixel tests."""
    import torch

    from sailor_tpu_torch.raster import tile_raster as tr

    stats = {}
    d_m, t_m = model(*args, **kw, stats=stats)
    check(bool(torch.equal(d_m, kernel_out[0])) and bool(torch.equal(t_m, kernel_out[1])),
          f"the {name} kernel's mapping disagrees with the kernel")
    print(f"{name} mapping: walked_rows={walked} tiles={kw['tiles_y'] * kw['tiles_x']} "
          f"run_groups={stats['run_groups']} runs={stats['runs']} "
          f"blocks={stats['runs'] * tr.strips()} pixel_tests={stats['pixel_tests']} "
          f"bound_pairs={pairs} strip_mapping_tests={stats['strip_tests']} "
          f"longest_rectangle_walk={stats['longest_rectangle_walk']}")


def check_variant_kernels(scene, width, height, card):
    """B7 (both plane forms), B8, B9 and B10 against their plain versions on
    the flagship frame's own inputs, as each configuration's DepthPrepass
    makes them (SLICE_CONFIG's capacity 1024 x 4 rounds: kmax 16 windows of
    256 rows for B7, windows of 128 rows for B8, bin_all's passes for B9)."""
    import torch

    from sailor_tpu_torch.raster import setup as rsetup
    from sailor_tpu_torch.raster import tile_raster as tr

    sb, targets, inv_vp, _gb, tiles_y, tiles_x = frame_inputs(scene, width, height)
    tri, aabb = targets["TriSetup"], targets["TriAABB"]
    order, starts, counts, big_ids, n_big, _ = rsetup.bin_sorted(
        tri.valid, aabb, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tr.TILE_W, tile_h=tr.TILE_H)
    cap, rounds = SLICE_CONFIG["bin_capacity"], SLICE_CONFIG["bin_rounds"]
    chunk, kmax = 256, cap * rounds // 256
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x)
    npix = tiles_y * tr.TILE_H * tiles_x * tr.TILE_W
    out = {}

    # ---- B7: the fused stream path's shared rows (17 raster + 37 attribute
    # columns), each tile's first max(spt, 1) whole windows
    attrs = scene.attrs_packed[tri.src_id.long()]
    rows, big, na = tr.build_stream_rows(tri, aabb, order, big_ids, attrs=attrs, chunk=chunk)
    c0, spt, ovf = tr.stream_windows(starts, counts, chunk, kmax)
    check(int(ovf) == 0, f"B7 drops {int(ovf)} candidates past kmax on the flagship frame")
    walk = stream_span(c0, spt, chunk)
    cand, pairs = raster_work(rows, big, *walk, n_big, tiles_y, tiles_x)
    for mxu in (False, True):
        name = "raster_stream_mxu" if mxu else "raster_stream"
        args = (rows, big, c0, spt, n_big)
        kw7 = dict(kw, chunk=chunk, mxu=mxu)
        out[name], d7, t7 = _raster_check(
            name, tr.rasterize_stream_cuda, tr.rasterize_stream_plain, args, kw7, card,
            (cand, pairs, 17 * 4), ntiles_bytes(c0))
        _mapping_check(name, stream_runs, args, kw7, (d7, t7), int(walk[1].sum()), pairs)
        zb = (torch.zeros_like(d7), torch.where(t7 >= 0, d7, 2.0))
        _raster_check(name + "[z_bounds]", tr.rasterize_stream_cuda, tr.rasterize_stream_plain,
                      args, dict(kw7, z_bounds=zb), card,
                      (cand, pairs, 17 * 4), ntiles_bytes(c0) + npix * 8, reps=3)
        if not mxu:
            tid7 = t7

    # ---- B10: the grid-k resolve on B7's winners (full mode, 37 columns)
    par = tr._resolve_params(inv_vp, scene.frame.camera_position, width, height, 0, rows.device)
    args = (rows, big, tid7, starts, counts, c0, spt, par)
    kw10 = dict(kw, na=na, chunk=chunk)
    p_k = torch.stack(tr.resolve_stream_cuda(*args, **kw10))
    plain_ms, p_p = _wall_ms(lambda: torch.stack(tr.resolve_stream_plain(*args, **kw10)))
    ms = _time_ms(lambda: tr.resolve_stream_cuda(*args, **kw10), 20)
    diff = (p_k - p_p).abs()
    err = diff.max().item()
    frac = (diff > 1e-5).float().mean().item()
    winners = int(torch.unique(tid7[tid7 >= 0]).numel())
    bound, by = _bound(npix * 4 + winners * (1 + na) * 4 + npix * p_k.shape[0] * 4,
                       int((tid7 >= 0).sum()) * 115)
    print(f"kernel resolve_stream: max_abs_err={err:.3g} frac_err>1e-5={frac:.3g} ms={ms:.4f} "
          f"plain_ms={plain_ms:.1f} bound_ms={bound:.4f} ({by}) on {card}")
    check(frac <= 1e-5 and bool((diff <= 1e-4 * (1 + p_p.abs())).all()),
          "resolve_stream kernel disagrees with its plain version")
    out["resolve_stream"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                 bound_by=by)

    # ---- B8: its own 17-column rows in windows of 128, each tile's exact
    # span, on B1's kernel; with and without z bounds, held to its twin and
    # to the plain model of its mapping (dma_runs)
    rows8, big8, _ = tr.build_stream_rows(tri, aabb, order, big_ids, attrs=None, chunk=128)
    w0, nw = tr.dma_windows(starts, counts, 128)
    work = raster_work(rows8, big8, w0 * 128, nw * 128, n_big, tiles_y, tiles_x)
    args, kw8 = (rows8, big8, w0, nw, n_big), dict(kw, dchunk=128)
    zb = None
    for label in ("", "[z_bounds]"):
        res, d8, t8 = _raster_check("raster_dma" + label, tr.rasterize_dma_cuda,
                                    tr.rasterize_dma_plain, args, dict(kw8, z_bounds=zb), card,
                                    work + (17 * 4,),
                                    ntiles_bytes(w0) + (npix * 8 if zb else 0), 10 if not zb else 3)
        _mapping_check("raster_dma" + label, dma_runs, args, dict(kw8, z_bounds=zb), (d8, t8),
                       int(nw.sum()) * 128, work[1])
        out.setdefault("raster_dma", res)
        zb = (torch.zeros_like(d8), torch.where(t8 >= 0, d8, 2.0))

    # ---- B9: bin_all's five passes, the first (the fullest), rounds 2-4 (a
    # few heavy tiles) and the big-triangle pass (64 slots; the ground plane
    # covers every pixel), each with and without the AABB clamp (the frame's
    # dense path clamps, raster.rasterize does not) and with z bounds; each
    # held to its twin and to the plain model of its mapping (dense_runs),
    # whose plan walks exactly ceil(count / 32) groups a tile. The first
    # pass's numbers are reported, and the five passes of a dense frame
    # summed (clamped)
    dtri, daabb = rsetup.triangle_setup(scene.geometry, scene.frame.view_projection,
                                        width=width, height=height,
                                        zplane_rounding="standalone")
    passes, _ = rsetup.bin_all(dtri.valid, daabb, tiles_x=tiles_x, tiles_y=tiles_y,
                               tile_w=tr.TILE_W, tile_h=tr.TILE_H, capacity=cap, rounds=rounds)
    tables = {clamp: tr.dense_table(dtri, daabb if clamp else None) for clamp in (True, False)}
    names = [""] + [f"[round{i + 1}]" for i in range(1, len(passes) - 1)] + ["[big_pass]"]
    frame_ms = frame_bound = 0.0
    for pname, (bins, pcounts) in zip(names, passes):
        pcounts = pcounts.reshape(-1).to(torch.int32).contiguous()
        ids = bins.reshape(-1).to(torch.int32).contiguous()
        walked = (pcounts + tr.CHUNK - 1) // tr.CHUNK * tr.CHUNK
        starts9 = dense_starts(ids, pcounts.numel())
        _, nb9, groups = worklist_plan(starts9, pcounts, 0, 0, ids.numel() // bins.shape[-1])
        check(nb9 == 0 and groups == (walked // tr.CHUNK).tolist(),
              f"B9's plan does not walk ceil(count / 32) groups a tile on pass {pname}")
        for clamp in (True, False):
            table = tables[clamp]
            staged = dense_slot_rows(table, ids)  # a slot's row as the kernel stages it
            cand, pairs = raster_work(staged, staged[:0], starts9, walked, 0, tiles_y, tiles_x,
                                      clamp=clamp)
            work = (cand, pairs, (table.shape[1] + 1) * 4)
            args = (table, ids, pcounts)
            name = "raster_dense" + pname + ("" if clamp else "[no_aabb]")
            zb = None
            for label in ("", "[z_bounds]"):
                res, d9, t9 = _raster_check(
                    name + label, tr.rasterize_tiles_cuda, tr.rasterize_tiles_plain, args,
                    dict(kw, z_bounds=zb), card, work,
                    ntiles_bytes(pcounts) + (npix * 8 if zb else 0), 10 if not zb else 3)
                _mapping_check(name + label, dense_runs, args, dict(kw, z_bounds=zb), (d9, t9),
                               int(walked.sum()), pairs)
                if name == "raster_dense" and not zb:
                    out["raster_dense"] = res
                if clamp and not zb:
                    frame_ms += res["ms"]
                    frame_bound += res["bound_ms"]
                zb = (torch.zeros_like(d9), torch.where(t9 >= 0, d9, 2.0))

    print(f"raster_dense per dense frame ({len(passes)} passes, clamped): ms={frame_ms:.4f} "
          f"bound_ms={frame_bound:.5f} gap_ms={frame_ms - frame_bound:.4f} on {card}")

    replaces = {"raster_stream": ("raster.cu", 194),
                "raster_stream_mxu": ("raster.cu", 657),
                "raster_dma": ("raster.cu", 751), "raster_dense": ("raster.cu", 43),
                "resolve_stream": ("resolve_stream.cu", 1159)}
    return [dict(name=name, route="cuda", source=f"sailor_tpu_torch/csrc/{src}",
                 replaces=f"sailor_tpu/raster/tile_raster.py:{line}", library_ms=None,
                 **out[name]) for name, (src, line) in replaces.items()]


def ntiles_bytes(per_tile):
    """Bytes of the per-tile int32 window or count arrays a kernel reads."""
    return per_tile.numel() * 8


def worklist_raster(targets, width, height):
    """Depth and TriId of the work-list raster (B1) over a frame's own
    setup ("TriSetup", "TriAABB")."""
    from sailor_tpu_torch.raster import setup as rsetup
    from sailor_tpu_torch.raster import tile_raster as tr

    tri, aabb = targets["TriSetup"], targets["TriAABB"]
    tiles_y, tiles_x = -(-height // tr.TILE_H), -(-width // tr.TILE_W)
    rb = rsetup.bin_sorted(tri.valid, aabb, tiles_x=tiles_x, tiles_y=tiles_y,
                           tile_w=tr.TILE_W, tile_h=tr.TILE_H)
    d, t, _ = tr.rasterize_worklist(tri, aabb, *rb[:5], tiles_y=tiles_y, tiles_x=tiles_x)
    return {"Depth": d[:height, :width], "TriId": t[:height, :width]}


def stream_mxu_raster(targets, width, height):
    """Depth and TriId of B7's MXU form's plain twin over a frame's own
    setup and raster rows, in the frame's windows (SLICE_CONFIG's capacity
    x rounds: kmax 16 windows of 256 rows)."""
    import torch

    from sailor_tpu_torch.raster import setup as rsetup
    from sailor_tpu_torch.raster import tile_raster as tr

    tri, aabb = targets["TriSetup"], targets["TriAABB"]
    tiles_y, tiles_x = -(-height // tr.TILE_H), -(-width // tr.TILE_W)
    order, starts, counts, big_ids, n_big, _ = rsetup.bin_sorted(
        tri.valid, aabb, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tr.TILE_W, tile_h=tr.TILE_H)
    chunk = 256
    kmax = -(-SLICE_CONFIG["bin_capacity"] * SLICE_CONFIG["bin_rounds"] // chunk)
    rows, big, _ = tr.build_stream_rows(tri, aabb, order, big_ids, attrs=None, chunk=chunk)
    c0, spt, _ = tr.stream_windows(starts, counts, chunk, kmax)
    d, t = tr.rasterize_stream_plain(rows, big, c0, spt, n_big.to(torch.int32).reshape(()),
                                     tiles_y=tiles_y, tiles_x=tiles_x, chunk=chunk, mxu=True)
    return {"Depth": d[:height, :width], "TriId": t[:height, :width]}


def run_raster_configs(scene, width, height, card):
    """The flagship frame in the work-list configuration and in each other
    raster configuration, 1 warm-up + 5 frames each, with the launch counts
    of that run (zeroed just before it). Each frame's Depth is bit-equal to
    the work-list frame's and its TriId differs only where candidates tie
    in depth, except two held to their own raster over their own setup:
    the dense path (its setup rounds the depth plane as the reference's
    standalone setup does) to B1, and the MXU form (its re-centred planes
    round otherwise) to its plain twin, both bit-equal. Final is within
    2/255 of the work-list frame's on all but 16 pixels (winners whose
    depth or resolve rounds otherwise may shade otherwise). Returns
    {config: launches}."""
    import torch

    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
    from sailor_tpu_torch.kernels import cuda_lib

    out, base = {}, None
    for name, change in {"worklist": {}, **RASTER_CONFIGS}.items():
        fg = FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), width, height,
                        dict(SLICE_CONFIG, **change))
        state = fg.initial_state()
        fg.prepare(scene, state)
        torch.cuda.synchronize()
        cuda_lib.LAUNCHES.clear()
        warm_ms, (targets, state) = _wall_ms(lambda: fg.process(scene, state))
        frame_ms = []
        for _ in range(5):
            ms, (targets, state) = _wall_ms(lambda: fg.process(scene, state))
            frame_ms.append(ms)
        launches = dict(cuda_lib.LAUNCHES)
        out[name] = launches
        for k in CONFIG_KERNELS[name]:
            check(launches.get(k, 0) > 0, f"{k} was not launched in the {name} frame")
        ovf = int(targets["BinOverflow"])
        depth, tid, final = targets["Depth"], targets["TriId"], targets["Final"]
        if base is None:
            base = {k: targets[k] for k in ("Depth", "TriId", "Final")}
        ref = base
        if name == "dense":
            ref = worklist_raster(targets, width, height)
        elif name == "stream_mxu":
            ref = stream_mxu_raster(targets, width, height)
        derr = (depth - base["Depth"]).abs().max().item()
        dsame = bool(torch.equal(depth, ref["Depth"]))
        tid_mism = tid != ref["TriId"]
        untied = int((tid_mism & (depth != ref["Depth"])).sum())
        base_untied = int(((tid != base["TriId"]) & (depth != base["Depth"])).sum())
        far = int(((final - base["Final"]).abs().amax(-1) > 2 / 255).sum())
        print(f"frame[{name}] {width}x{height}: warmup_ms={warm_ms:.2f} "
              f"frame_ms={[round(m, 3) for m in frame_ms]} "
              f"mean_ms={sum(frame_ms) / len(frame_ms):.3f} bin_overflow={ovf} "
              f"launches_per_frame={json.dumps({k: v / 6 for k, v in launches.items()})} "
              f"depth_bit_equal={dsame} tid_mismatch={int(tid_mism.sum())} "
              f"tid_mismatch_untied={untied} max_depth_diff_vs_worklist={derr:.3g} "
              f"tid_mismatch_untied_vs_worklist={base_untied} "
              f"final_px_outside_2/255_vs_worklist={far} on {card}")
        check(ovf == 0, f"{name}: the flagship frame overflows its bins")
        check(bool(torch.isfinite(final).all()), f"{name}: Final has non-finite values")
        check(dsame and untied == 0, f"{name}: Depth or TriId differs from its reference raster")
        check(far <= 16, f"{name}: Final leaves 2/255 of the work-list frame's on {far} px")
    return out


def run_rasterize(scene, width, height, card):
    """raster.rasterize (setup -> bin_all -> B9 per pass -> resolve) on the
    flagship geometry, with the slice's bin capacity: 1 warm-up + 3 timed
    calls, its stats, and the launches of that run."""
    import torch

    from sailor_tpu_torch import raster
    from sailor_tpu_torch.kernels import cuda_lib

    kw = dict(width=width, height=height, capacity=SLICE_CONFIG["bin_capacity"],
              rounds=SLICE_CONFIG["bin_rounds"])
    geo, vp = scene.geometry, scene.frame.view_projection
    torch.cuda.synchronize()
    cuda_lib.LAUNCHES.clear()
    warm_ms, _ = _wall_ms(lambda: raster.rasterize(geo, vp, **kw))
    times = []
    for _ in range(3):
        ms, (gb, depth, tid, stats) = _wall_ms(lambda: raster.rasterize(geo, vp, **kw))
        times.append(ms)
    launches = dict(cuda_lib.LAUNCHES)
    cov = (tid >= 0).float().mean().item()
    print(f"rasterize {width}x{height}: warmup_ms={warm_ms:.2f} "
          f"call_ms={[round(m, 3) for m in times]} bin_overflow={int(stats['bin_overflow'])} "
          f"tile_tri_counts_max={int(stats['tile_tri_counts'].max())} coverage={cov:.4f} "
          f"launches_per_call={json.dumps({k: v / 4 for k, v in launches.items()})} on {card}")
    check(launches.get("raster_dense", 0) == 4 * (SLICE_CONFIG["bin_rounds"] + 1),
          "raster.rasterize did not launch B9 once a pass")
    check(tuple(depth.shape) == (height, width) and cov > 0.0, "rasterize rendered nothing")
    check(bool(torch.isfinite(gb.world_position).all()), "rasterize's G-buffer is not finite")
    return launches


TILE_HEIGHTS = (16, 32, 128)  # raster-tile-heights' heights (the other phases run at 64)
TILE_HEIGHT_FRAMES = 3  # its timed work-list frames at each height, after one warm-up
SMALL_TILE_HEIGHT = 16  # its 256x128 card-vs-CPU frame
# the kernels the phase holds and times at each height: {name: the raster
# configuration whose frame launches it}
TILE_HEIGHT_KERNELS = {
    "raster_worklist": "worklist", "resolve_worklist": "worklist", "raster_stream": "stream",
    "raster_stream_mxu": "stream_mxu", "raster_dma": "dma", "raster_dense": "dense",
    "resolve_stream": "stream",
}


def tile_height_kernels(scene, width, height, card):
    """B1, B2, B7 (both plane forms), B8, B9 and B10 at the current tile
    height on the flagship frame's own inputs (B1/B2: the work-list frame's
    bins; B7/B10: windows of 256, kmax 16; B8: windows of 128; B9: the dense
    frame's first pass, clamped): each held to its twin once (rasters bit
    for bit; resolves at B2's bar, with the count of values that differ at
    all) and timed by the profiler (device ms a call, a raster's plan and
    raster kernels summed, 10 calls) beside its bound, the work
    (``raster_work``) counted at this height. Returns {name: row}."""
    import torch

    from sailor_tpu_torch.raster import setup as rsetup
    from sailor_tpu_torch.raster import tile_raster as tr

    th = tr.check_tile_h()
    sb, targets, inv_vp, _gb, tiles_y, tiles_x = frame_inputs(scene, width, height)
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x)
    npix = tiles_y * th * tiles_x * tr.TILE_W
    par = tr._resolve_params(inv_vp, scene.frame.camera_position, width, height, 0,
                             sb["rows"].device)
    calls = {}  # name: (kernel, twin, args, keywords, bound (ms, by))

    def raster(name, kernel, plain, args, kwargs, walk, row_bytes, extra):
        cand, pairs = raster_work(*walk, tiles_y, tiles_x)
        calls[name] = (kernel, plain, args, kwargs,
                       _bound(cand * row_bytes + npix * 8 + extra, pairs * 16))

    rows, big, starts, counts, n_big = (sb["rows"], sb["big_rows"], sb["starts"],
                                        sb["counts"], sb["n_big"])
    raster("raster_worklist", tr.rasterize_worklist_cuda, tr.rasterize_worklist_plain,
           (rows, big, starts, counts, n_big), dict(kw, chunk=128),
           (rows, big, starts, counts, n_big), 17 * 4, counts.numel() * 8)
    tri, aabb = targets["TriSetup"], targets["TriAABB"]
    order, starts, counts, big_ids, n_big, _ = rsetup.bin_sorted(
        tri.valid, aabb, tile_w=tr.TILE_W, tile_h=th, **kw)
    n_big = n_big.to(torch.int32).reshape(())
    rows7, big7, na = tr.build_stream_rows(tri, aabb, order, big_ids,
                                           attrs=scene.attrs_packed[tri.src_id.long()],
                                           chunk=256)
    c0, spt, _ = tr.stream_windows(starts, counts, 256, 16)
    for mxu in (False, True):
        raster("raster_stream_mxu" if mxu else "raster_stream", tr.rasterize_stream_cuda,
               tr.rasterize_stream_plain, (rows7, big7, c0, spt, n_big),
               dict(kw, chunk=256, mxu=mxu),
               (rows7, big7, *stream_span(c0, spt, 256), n_big), 17 * 4, ntiles_bytes(c0))
    rows8, big8, _ = tr.build_stream_rows(tri, aabb, order, big_ids, attrs=None, chunk=128)
    w0, nw = tr.dma_windows(starts, counts, 128)
    raster("raster_dma", tr.rasterize_dma_cuda, tr.rasterize_dma_plain,
           (rows8, big8, w0, nw, n_big), dict(kw, dchunk=128),
           (rows8, big8, w0 * 128, nw * 128, n_big), 17 * 4, ntiles_bytes(w0))
    dtri, daabb = rsetup.triangle_setup(scene.geometry, scene.frame.view_projection,
                                        width=width, height=height,
                                        zplane_rounding="standalone")
    passes, dense_ovf = rsetup.bin_all(dtri.valid, daabb, tile_w=tr.TILE_W, tile_h=th,
                                       capacity=SLICE_CONFIG["bin_capacity"],
                                       rounds=SLICE_CONFIG["bin_rounds"], **kw)
    bins, pcounts = passes[0]
    table = tr.dense_table(dtri, daabb)
    ids = bins.reshape(-1).to(torch.int32).contiguous()
    pcounts = pcounts.reshape(-1).to(torch.int32).contiguous()
    starts9 = dense_starts(ids, pcounts.numel())
    staged = dense_slot_rows(table, ids)
    raster("raster_dense", tr.rasterize_tiles_cuda, tr.rasterize_tiles_plain,
           (table, ids, pcounts), dict(kw),
           (staged, staged[:0], starts9, (pcounts + tr.CHUNK - 1) // tr.CHUNK * tr.CHUNK, 0),
           (table.shape[1] + 1) * 4, ntiles_bytes(pcounts))
    out, tids = {}, {}
    for name, (kernel, plain, args, kwargs, (bound, by)) in calls.items():
        d_k, t_k = kernel(*args, **kwargs)
        plain_ms, (d_p, t_p) = _wall_ms(lambda: plain(*args, **kwargs))
        same = bool(torch.equal(d_k, d_p)) and bool(torch.equal(t_k, t_p))
        check(same, f"{name} kernel disagrees with its plain version at tile height {th}")
        tids[name] = t_k.contiguous()
        out[name] = dict(max_abs_err=(d_k - d_p).abs().max().item(), plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, bit_equal=same,
                         covered=int((t_k >= 0).sum()))
    for name, args, kwargs in (
            ("resolve_worklist", (rows, big, tids["raster_worklist"], sb["starts"],
                                  sb["counts"], par),
             dict(kw, na=int(sb["na"]), chunk=int(sb["chunk"]))),
            ("resolve_stream", (rows7, big7, tids["raster_stream"], starts, counts, c0, spt,
                                par), dict(kw, na=na, chunk=256))):
        kernel, plain = ((tr.resolve_worklist_cuda, tr.resolve_worklist_plain)
                         if name == "resolve_worklist" else
                         (tr.resolve_stream_cuda, tr.resolve_stream_plain))
        p_k = torch.stack(kernel(*args, **kwargs))
        plain_ms, p_p = _wall_ms(lambda: torch.stack(plain(*args, **kwargs)))
        diff = (p_k - p_p).abs()
        check((diff > 1e-5).float().mean().item() <= 1e-5
              and bool((diff <= 1e-4 * (1 + p_p.abs())).all()),
              f"{name} kernel disagrees with its plain version at tile height {th}")
        tid = args[2]
        winners = int(torch.unique(tid[tid >= 0]).numel())
        bound, by = _bound(npix * 4 + winners * (1 + kwargs["na"]) * 4
                           + npix * p_k.shape[0] * 4, int((tid >= 0).sum()) * 115)
        calls[name] = (kernel, plain, args, kwargs, (bound, by))
        out[name] = dict(max_abs_err=diff.max().item(), plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, bit_equal=bool(torch.equal(p_k, p_p)),
                         values_differing=int((diff > 0).sum()))
    timed = profiled_us({name: (lambda c=c: c[0](*c[2], **c[3])) for name, c in calls.items()},
                        reps=10, per_call=True)
    for name, row in out.items():
        row["ms"], row["timed_by"] = timed[name][0] / 1e3, timed[name][1]
    return out, int(dense_ovf)


def run_raster_tile_heights(scene, width, height, card):
    """raster-tile-heights: the flagship frame at each tile height of
    TILE_HEIGHTS, set on tile_raster (``tile_height``). At each height:
    the work-list frame through FrameGraph (1 warm-up + TILE_HEIGHT_FRAMES
    timed frames, the launches of that run counted), its Depth bit-equal to
    the default height's frame wherever the big list drops nothing (no
    candidate is left out, and the max depth does not depend on the
    grouping); one frame in each other raster configuration (stream,
    stream_mxu, dma, dense), counted; the big-list and dense-bin overflow;
    B1, B2, B7 (both forms), B8, B9 and B10 held to their twins and timed
    (``tile_height_kernels``), as they are first at the default height.
    Then a 256x128 frame at SMALL_TILE_HEIGHT against the CPU path
    (``check_small_frame``). Returns ({kernel: {height: row}}, the
    frames' launches)."""
    import collections

    import torch

    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.raster import setup as rsetup
    from sailor_tpu_torch.raster import tile_raster as tr

    def graph(change=None):
        fg = FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), width, height,
                        dict(SLICE_CONFIG, **(change or {})))
        state = fg.initial_state()
        fg.prepare(scene, state)
        return fg, state

    # the default height's frame, and its kernels held and timed alike so
    # that every height's times come from this run
    fg, state = graph()
    torch.cuda.synchronize()
    cuda_lib.LAUNCHES.clear()
    base = fg.process(scene, state)[0]["Depth"]
    launches = collections.Counter({k: v for k, v in cuda_lib.LAUNCHES.items()
                                    if k in TILE_HEIGHT_KERNELS})
    def report(th, held):
        for name, row in held.items():
            print(f"kernel {name}[tile_h={th}]: " + " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items())
                + f" on {card}")

    held, _ = tile_height_kernels(scene, width, height, card)
    report(tr.TILE_H, held)
    rows = {name: {str(tr.TILE_H): dict(launches=launches[name], **held[name])}
            for name in TILE_HEIGHT_KERNELS}
    for th in TILE_HEIGHTS:
        t_height = time.perf_counter()
        with tile_height(th):
            fg, state = graph()
            torch.cuda.synchronize()
            cuda_lib.LAUNCHES.clear()
            warm_ms, (targets, state) = _wall_ms(lambda: fg.process(scene, state))
            frame_ms = []
            for _ in range(TILE_HEIGHT_FRAMES):
                ms, (targets, state) = _wall_ms(lambda: fg.process(scene, state))
                frame_ms.append(ms)
            counts = {"worklist": dict(cuda_lib.LAUNCHES)}
            for k in CONFIG_KERNELS["worklist"]:
                check(counts["worklist"].get(k, 0) > 0,
                      f"{k} was not launched in the frame at tile height {th}")
            final, depth = targets["Final"], targets["Depth"]
            dropped = int(targets["BinOverflow"])
            cov = (targets["TriId"] >= 0).float().mean().item()
            check(tuple(final.shape) == (height, width, 3) and bool(torch.isfinite(final).all())
                  and cov > 0.0, f"the frame at tile height {th} is empty or not finite")
            same_depth = bool(torch.equal(depth, base))
            check(dropped > 0 or same_depth,
                  f"the frame's Depth at tile height {th} differs from the default height's "
                  "with no triangle dropped")
            for config in ("stream", "stream_mxu", "dma", "dense"):
                cfg_fg, cfg_state = graph(RASTER_CONFIGS[config])
                torch.cuda.synchronize()
                cuda_lib.LAUNCHES.clear()
                t = cfg_fg.process(scene, cfg_state)[0]
                counts[config] = dict(cuda_lib.LAUNCHES)
                for k in CONFIG_KERNELS[config]:
                    check(counts[config].get(k, 0) > 0,
                          f"{k} was not launched in the {config} frame at tile height {th}")
                check(bool(torch.isfinite(t["Final"]).all()),
                      f"the {config} frame at tile height {th} is not finite")
            tri, aabb = targets["TriSetup"], targets["TriAABB"]
            ty, tx = -(-height // th), -(-width // tr.TILE_W)
            ovf_512 = int(rsetup.bin_all(tri.valid, aabb, tiles_x=tx, tiles_y=ty,
                                         tile_w=tr.TILE_W, tile_h=th, capacity=512,
                                         rounds=2)[1])
            held, dense_ovf = tile_height_kernels(scene, width, height, card)
        for name, config in TILE_HEIGHT_KERNELS.items():
            n = counts[config].get(name, 0)
            rows[name][str(th)] = dict(launches=n, **held[name])
            launches[name] += n
        print(f"raster-tile-heights[{th}] {width}x{height}: tiles={ty}x{tx} "
              f"warmup_ms={warm_ms:.2f} frame_ms={[round(m, 3) for m in frame_ms]} "
              f"mean_ms={sum(frame_ms) / len(frame_ms):.3f} big_list_dropped={dropped} "
              f"dense_overflow(1024x4)={dense_ovf} dense_overflow(512x2)={ovf_512} "
              f"coverage={cov:.4f} depth_equal_to_default={same_depth} "
              f"launches={json.dumps(counts)} on {card}")
        report(th, held)
        print(f"raster-tile-heights[{th}]: {time.perf_counter() - t_height:.1f} s")
    cuda_lib.LAUNCHES.clear()
    with tile_height(SMALL_TILE_HEIGHT):
        check_small_frame()
    small = {k: cuda_lib.LAUNCHES.get(k, 0) for k in CONFIG_KERNELS["worklist"]}
    check(all(small.values()), f"the small frame at tile height {SMALL_TILE_HEIGHT} "
                               f"skipped a kernel: {small}")
    launches.update({k: v for k, v in small.items() if k in rows})
    return rows, dict(launches)


def run_frames(scene, width, height, card):
    import torch

    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset, nodes
    from sailor_tpu_torch.kernels import cuda_lib

    fg = FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), width, height,
                    dict(SLICE_CONFIG))
    state = fg.initial_state()
    fg.prepare(scene, state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.LAUNCHES.clear()
    warm_ms, (targets, state) = _wall_ms(lambda: fg.process(scene, state))
    frame_ms = []
    for _ in range(5):
        ms, (targets, state) = _wall_ms(lambda: fg.process(scene, state))
        frame_ms.append(ms)
    launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _, _, per_node = fg.process_debug(scene, state)
    # RenderScene's inverse view-projection: the matrix lives on the card,
    # so each frame copies its 64 bytes back (a synchronise) for the LU
    inv_ms, _ = _wall_ms(lambda: [nodes.inverse_view_projection(scene.frame) for _ in range(20)])
    print(f"inverse_view_projection: {inv_ms / 20:.4f} ms a call (copy back, LU on the host, "
          f"copy to the card) on {card}")
    fma_cost(fg, scene, state, card)
    profile(lambda: fg.process(scene, state), card, "profile")  # last: frames after it run slower
    print(f"frame {width}x{height}: warmup_ms={warm_ms:.2f} "
          f"frame_ms={[round(m, 3) for m in frame_ms]} "
          f"mean_ms={sum(frame_ms) / len(frame_ms):.3f} peak_mem_bytes={peak} on {card}")
    print("per_node_ms " + json.dumps({k: round(v, 3) for k, v in per_node.items()}))
    print("launches " + json.dumps(launches))
    for name in ("raster_worklist", "resolve_worklist", "shade_forward_plus"):
        check(launches.get(name, 0) > 0, f"{name} was not launched on the main path")
    final = targets["Final"]
    cov = (targets["TriId"] >= 0).float().mean().item()
    check(tuple(final.shape) == (height, width, 3), f"Final has shape {tuple(final.shape)}")
    check(bool(torch.isfinite(final).all()), "Final has non-finite values")
    check(final.min().item() >= 0.0 and final.max().item() <= 1.0, "Final leaves [0, 1]")
    check(cov > 0.0, "nothing was rasterized")
    print(f"output: Final in [{final.min().item():.4f}, {final.max().item():.4f}] "
          f"coverage={cov:.4f} avg_luminance={state['avg_luminance'].item():.5f}")
    return launches


def profile(fn, card, label):
    """fn() under torch.profiler: device busy share of its wall time (union
    of kernel intervals) and device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms, _ = _wall_ms(fn)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        print(f"{label}: the profiler recorded no device events")
        return
    busy, end = 0, spans[0][0]
    for a, b in spans:
        busy += max(0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label}: wall_ms={wall_ms:.3f} device_busy_ms={busy / 1e3:.3f} "
          f"device_idle_share={1 - busy / 1e3 / wall_ms:.3f} kernels={len(spans)} on {card}")
    print(f"{label}_top_device_us " + json.dumps({k[:60]: v for k, v in top}))
    # the port's own kernels (csrc/): launches and mean device us a launch
    ours = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "(anonymous namespace)::" in e.name \
                and "at::native" not in e.name:
            name = e.name.split("::")[-1].split("(")[0]
            n, us = ours.get(name, (0, 0.0))
            ours[name] = (n + 1, us + e.time_range.elapsed_us())
    print(f"{label}_port_kernels " + json.dumps(
        {k: {"launches": n, "mean_us": round(us / n, 3)} for k, (n, us) in ours.items()}))


def fma_cost(fg, scene, state, card, reps: int = 4):
    """What the float64 fused multiply-add (core.math3d.fma) costs the
    frame: per-node ms, the least of `reps` synchronised frames, with it and
    with an unfused float32 a * b + c in its place (runs interleaved). The
    unfused frames round otherwise and are discarded."""
    from sailor_tpu_torch.core import math3d
    from sailor_tpu_torch.raster import setup

    fused = math3d.fma
    variants = {"float64_fma": fused, "float32_unfused": lambda a, b, c: a * b + c}
    best = {k: {} for k in variants}
    try:
        for i in range(2 * reps):
            name = list(variants)[(i + i // 2) % 2]  # A B B A ...
            math3d.fma = setup.fma = variants[name]
            _, _, per_node = fg.process_debug(scene, state)
            for node, ms in per_node.items():
                best[name][node] = min(ms, best[name].get(node, float("inf")))
    finally:
        math3d.fma = setup.fma = fused
    for name, nodes in best.items():
        print(f"fma_cost {name}: " + json.dumps({k: round(v, 3) for k, v in nodes.items()})
              + f" on {card}")


def check_small_frame(change=None):
    """A 256x128 frame on the card against the same frame on the CPU path
    (which the CPU tests hold to the JAX package), in the slice's
    configuration with ``change`` applied: TriId equal on >= 99.9% of
    pixels, Final within 2/255 on >= 99.9%."""
    import torch

    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
    from sailor_tpu_torch.scenes import flagship_scene

    out = {}
    for dev in ("cuda", "cpu"):
        scene = flagship_scene(256, 128, 24, 10, device=dev)
        fg = FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), 256, 128,
                        dict(SLICE_CONFIG, **(change or {})), device=dev)
        t, _ = fg.process(scene, fg.initial_state())
        out[dev] = {k: t[k].cpu() for k in ("TriId", "Final")}
    same = (out["cuda"]["TriId"] == out["cpu"]["TriId"]).float().mean().item()
    close = ((out["cuda"]["Final"] - out["cpu"]["Final"]).abs().amax(-1)
             <= 2 / 255).float().mean().item()
    print(f"small frame {change or 'worklist'} card vs cpu: tid_equal={same:.5f} "
          f"final_within_2/255={close:.5f}")
    check(same >= 0.999 and close >= 0.999, "card frame disagrees with the CPU path")


def cascade_inputs(scene, cascade: int, config=SHADOW_HIZ_CONFIG):
    """B1's inputs for one sun cascade, made as ShadowPrepass makes them
    (``triangle_setup(cull="none", clip=False)`` at ``shadow_resolution``,
    the ragged bins, the row table): (rows, big_rows, starts, counts, n_big,
    tiles_y, tiles_x)."""
    from sailor_tpu_torch.framegraph import nodes
    from sailor_tpu_torch.raster import setup as rsetup
    from sailor_tpu_torch.raster import tile_raster as tr

    s = int(config["shadow_resolution"])
    tiles_y, tiles_x = -(-s // tr.TILE_H), -(-s // tr.TILE_W)
    mat = nodes.light_matrices(scene, config)[cascade]
    tri, aabb = rsetup.triangle_setup(scene.geometry, mat, width=s, height=s, cull="none",
                                      clip=False)
    order, starts, counts, big_ids, n_big, _ = rsetup.bin_sorted(
        tri.valid, aabb, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tr.TILE_W, tile_h=tr.TILE_H)
    rows, big, _ = tr.build_stream_rows(tri, aabb, order, big_ids, chunk=128)
    return rows, big, starts, counts, n_big, tiles_y, tiles_x


def evsm_shadow_factor(scene, width, height, gbuffer):
    """The sun's EVSM shadow factor of the shadowed frame on ``gbuffer``,
    as its ShadowPrepass and RenderScene compute it (no CSM cache)."""
    from sailor_tpu_torch.framegraph import nodes
    from sailor_tpu_torch.framegraph.graph import RenderContext

    ctx = RenderContext(width=width, height=height, scene=scene, state={},
                        values=dict(SHADOW_HIZ_VALUES), config=dict(SHADOW_HIZ_CONFIG))
    targets = nodes.ShadowPrepassNode().process(ctx, {})
    return nodes.RenderSceneNode._shadow(ctx, targets, gbuffer)


def check_shadow_kernels(scene, width, height, card):
    """B1 on each sun cascade's inputs against its twin (bit-equal; cascade
    0 timed, with its bound by the frame's rule), and B3 with the frame's
    EVSM shadow factor against its twin (relative 1e-5, check_spot_shadow's
    bar)."""
    import torch

    from sailor_tpu_torch.kernels import pbr_kernel
    from sailor_tpu_torch.raster import tile_raster as tr

    s = SHADOW_HIZ_CONFIG["shadow_resolution"]
    for c in range(4):
        rows, big, starts, counts, n_big, tiles_y, tiles_x = cascade_inputs(scene, c)
        args = (rows, big, starts, counts, n_big)
        kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, chunk=128)
        d_k, t_k = tr.rasterize_worklist_cuda(*args, **kw)
        plain_ms, (d_p, t_p) = _wall_ms(lambda: tr.rasterize_worklist_plain(*args, **kw))
        same = bool(torch.equal(d_k, d_p)) and bool(torch.equal(t_k, t_p))
        line = (f"kernel raster_worklist[cascade {c}]: bit_equal={same} "
                f"covered={int((t_k >= 0).sum())} of {s * s} plain_ms={plain_ms:.1f}")
        if c == 0:
            ms = _time_ms(lambda: tr.rasterize_worklist_cuda(*args, **kw), 20)
            cand, pairs = raster_work(rows, big, starts, counts, n_big, tiles_y, tiles_x)
            npix = tiles_y * tr.TILE_H * tiles_x * tr.TILE_W
            bound, by = _bound(cand * 17 * 4 + counts.numel() * 8 + npix * 8, pairs * 16)
            line += (f" ms={ms:.4f} bound_ms={bound:.5f} ({by}) candidates={cand} "
                     f"pairs={pairs} rows={rows.shape[0]} big={int(n_big)}")
        print(line + f" at {s}x{s} on {card}")
        check(same, f"raster kernel disagrees with its plain version on cascade {c}")

    sb, targets, _, gb, *_ = frame_inputs(scene, width, height)
    shadow = evsm_shadow_factor(scene, width, height, gb)
    table = pbr_kernel.pack_lights(scene.lights)
    args = (table, targets["LightIndices"].to(torch.int32).contiguous(),
            targets["LightCounts"].to(torch.int32).contiguous(), gb.albedo.contiguous(),
            gb.metallic.contiguous(), gb.roughness.contiguous(), gb.normal.contiguous(),
            gb.world_position.contiguous(), shadow.contiguous(),
            scene.frame.camera_position.to(torch.float32).contiguous())
    got = pbr_kernel.shade_tiles_cuda(*args)
    ref = pbr_kernel.shade_tiles_plain(*args)
    rel = ((got - ref).abs() / ref.abs().clamp(min=1e-3)).max().item()
    cov = gb.coverage > 0
    print(f"kernel shade_forward_plus[evsm_shadow]: max_rel_err={rel:.3g} "
          f"below_0.9_share={(shadow[cov] < 0.9).float().mean().item():.4f} "
          f"below_0.5_share={(shadow[cov] < 0.5).float().mean().item():.4f} "
          f"factor_mean={shadow[cov].mean().item():.4f} on {card}")
    check(rel <= 1e-5, "shade kernel disagrees with its plain version (EVSM shadow)")
    check(bool((shadow[cov] < 0.9).any()), "the EVSM factor shadows no pixel")


def _shadow_hiz_graph(width, height, device="cuda", config=None):
    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset

    return FrameGraph(FrameGraphAsset.from_nodes(SHADOW_HIZ_GRAPH, SHADOW_HIZ_VALUES),
                      width, height, dict(config or SHADOW_HIZ_CONFIG), device=device)


def hiz_culled_ids(targets, prev_state, width, height):
    """The raster triangles a frame's DepthPrepass culled: its setup
    ("TriSetup", "TriAABB") tested against the pyramid of ``prev_state``,
    as the node tests it."""
    from sailor_tpu_torch.raster import hiz_cull

    tri, aabb = targets["TriSetup"], targets["TriAABB"]
    mips = [prev_state[k] for k in sorted(prev_state) if k.startswith("hiz/mip")]
    flat, offsets, shapes = hiz_cull.build_flat_pyramid(mips)
    kept = hiz_cull.occlusion_cull(tri.valid, aabb, tri.zmax, flat, offsets=offsets,
                                   shapes=shapes, base_w=width, base_h=height)
    return tri.valid & ~kept


def compare_culled_frame(first, second, culled, card, label="frame[shadow_hiz]"):
    """Frame 2 (culled against frame 1's pyramid, maps from the CSM cache)
    against frame 1 with the static camera: ShadowMaps and EvsmMaps equal
    bit for bit (the cache), and Depth and TriId equal except at pixels
    whose frame-1 winner frame 2 culled. The reference's cull drops such
    visible triangles too: the raster accepts pixel centres up to 0.05 px
    outside a triangle's edges, where its depth plane passes the vertex
    maximum ``zmax`` the cull compares, so the pyramid can hold a
    triangle's own depth above its zmax. Main may differ only in the light
    tiles (16x16) that hold such a pixel and their neighbours (the shadow
    factor is pooled over 4x4 blocks and upsampled bilinearly across
    them)."""
    import torch

    for k in ("ShadowMaps", "EvsmMaps"):
        check(bool(torch.equal(second[k], first[k])), f"the CSM cache changed {k}")
    moved = (second["Depth"] != first["Depth"]) | (second["TriId"] != first["TriId"])
    winners = first["TriId"][moved]
    explained = bool(culled[winners.clamp(min=0).long()].all()) and bool((winners >= 0).all())
    t = 16
    hp, wp = -(-moved.shape[0] // t) * t, -(-moved.shape[1] // t) * t
    tiles = torch.nn.functional.pad(moved, (0, wp - moved.shape[1], 0, hp - moved.shape[0]))
    tiles = tiles.reshape(hp // t, t, wp // t, t).any(3).any(1)
    tiles = torch.nn.functional.max_pool2d(tiles[None].float(), 3, 1, 1)[0] > 0
    near = tiles.repeat_interleave(t, 0).repeat_interleave(t, 1)[:moved.shape[0], :moved.shape[1]]
    main_moved = (second["Main"] != first["Main"]).any(-1)
    print(f"{label} frame 2 vs frame 1: maps_bit_equal=True depth_or_tid_moved_px="
          f"{int(moved.sum())} all_at_culled_winners={explained} "
          f"culled_visible_triangles={int(torch.unique(winners).numel())} "
          f"main_moved_px={int(main_moved.sum())} main_moved_outside_their_tile_blocks="
          f"{int((main_moved & ~near).sum())} on {card}")
    check(explained, "frame 2's Depth or TriId moved at a pixel whose winner was not culled")
    check(not bool((main_moved & ~near).any()),
          "frame 2's Main moved away from the light tiles of the culled winners")


def run_shadow_hiz_frames(scene, width, height, card):
    """frame[shadow_hiz]: the shadowed, HiZ-culled flagship frame, 1 warm-up
    + 5 frames with the state threaded through, launches counted per frame.
    Frame 1 (the warm-up) renders the cascades (dirty: B1 5 times); frames
    2-6 take them from the CSM cache (B1 once) and cull against the
    previous frame's pyramid; with the static camera frame 2 is held to
    frame 1 (``compare_culled_frame``). Then 3 frames made dirty by
    resetting the cache key, per-node ms of a cached and a dirty frame, and
    one profiled cached frame. Returns the launches of frames 1-6."""
    import torch

    from sailor_tpu_torch.kernels import cuda_lib

    fg = _shadow_hiz_graph(width, height)
    state = fg.initial_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, per_frame, culled, keep = [], [], [], []
    total = {}
    for i in range(6):
        prev = state
        cuda_lib.LAUNCHES.clear()
        ms, (targets, state) = _wall_ms(lambda: fg.process(scene, state))
        launches = dict(cuda_lib.LAUNCHES)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        times.append(ms)
        per_frame.append(launches)
        culled.append(int(targets["HiZCulledCount"]))
        if i < 2:
            keep.append({k: targets[k].clone() for k in
                         ("Depth", "TriId", "Main", "ShadowMaps", "EvsmMaps")})
        if i == 1:
            culled_ids = hiz_culled_ids(targets, prev, width, height)
            check(int(culled_ids.sum()) == culled[1], "the recomputed cull differs from the node's")
    peak = torch.cuda.max_memory_allocated()
    for i, launches in enumerate(per_frame):
        for name in ("raster_worklist", "resolve_worklist", "shade_forward_plus"):
            want = 5 if (i == 0 and name == "raster_worklist") else 1
            check(launches.get(name, 0) == want,
                  f"frame {i + 1} launched {name} {launches.get(name, 0)} times, not {want}")
    check(culled[0] == 0, "the zero pyramid culled triangles")
    compare_culled_frame(keep[0], keep[1], culled_ids, card)

    dirty_ms = []
    for _ in range(3):
        dirty = dict(state, **{"csm/key": torch.full_like(state["csm/key"], -1e30)})
        cuda_lib.LAUNCHES.clear()
        ms, (targets, _) = _wall_ms(lambda: fg.process(scene, dirty))
        dirty_ms.append(ms)
        check(cuda_lib.LAUNCHES.get("raster_worklist", 0) == 5, "a dirty frame skipped a cascade")
    _, _, per_node = fg.process_debug(scene, state)
    dirty = dict(state, **{"csm/key": torch.full_like(state["csm/key"], -1e30)})
    _, _, per_node_dirty = fg.process_debug(scene, dirty)
    profile(lambda: fg.process(scene, state), card, "profile_shadow_hiz")
    mean = sum(times[1:]) / 5
    print(f"frame[shadow_hiz] {width}x{height}: dirty_frame1_ms={times[0]:.3f} "
          f"cached_frame_ms={[round(m, 3) for m in times[1:]]} cached_mean_ms={mean:.3f} "
          f"dirty_again_ms={[round(m, 3) for m in dirty_ms]} peak_mem_bytes={peak} "
          f"hiz_culled={culled} on {card}")
    print("frame[shadow_hiz] per_node_ms_cached "
          + json.dumps({k: round(v, 3) for k, v in per_node.items()}))
    print("frame[shadow_hiz] per_node_ms_dirty "
          + json.dumps({k: round(v, 3) for k, v in per_node_dirty.items()}))
    print("frame[shadow_hiz] launches_per_frame " + json.dumps(per_frame))
    final = targets["Final"]
    cov = (targets["TriId"] >= 0).float().mean().item()
    check(bool(torch.isfinite(final).all()) and final.min().item() >= 0.0
          and final.max().item() <= 1.0, "frame[shadow_hiz]: Final is not finite in [0, 1]")
    check(cov > 0.0, "frame[shadow_hiz]: nothing was rasterized")
    print(f"frame[shadow_hiz] output: coverage={cov:.4f} "
          f"shadow_maps_covered={(targets['ShadowMaps'] > 0).float().mean().item():.4f}")
    return total


def check_small_shadow_frame():
    """A 256x128 shadowed, culled frame (shadow_resolution 128), two frames,
    on the card against the same frames on the CPU path (which the CPU
    tests hold to the JAX package): ShadowMaps, Depth and TriId equal on
    >= 99.9% of texels and pixels, Main within 1e-4 relative on >= 99.5% of
    pixels, Final within 2/255 on >= 99.9%; HiZCulledCount printed."""
    import torch

    from sailor_tpu_torch.scenes import flagship_scene

    out = {}
    for dev in ("cuda", "cpu"):
        scene = flagship_scene(256, 128, 24, 10, device=dev)
        fg = _shadow_hiz_graph(256, 128, dev, dict(SHADOW_HIZ_CONFIG, shadow_resolution=128))
        state = fg.initial_state()
        out[dev] = []
        for _ in range(2):
            t, state = fg.process(scene, state)
            out[dev].append({k: t[k].cpu() for k in ("ShadowMaps", "Depth", "TriId", "Main",
                                                     "Final", "HiZCulledCount")})
    for i, (g, r) in enumerate(zip(out["cuda"], out["cpu"])):
        eq = {k: (g[k] == r[k]).float().mean().item() for k in ("ShadowMaps", "Depth", "TriId")}
        rel = ((g["Main"] - r["Main"]).abs() / r["Main"].abs().clamp(min=1e-3)).amax(-1)
        main = (rel <= 1e-4).float().mean().item()
        final = ((g["Final"] - r["Final"]).abs().amax(-1) <= 2 / 255).float().mean().item()
        print(f"small frame[shadow_hiz] {i + 1} card vs cpu: "
              + " ".join(f"{k}_equal={v:.5f}" for k, v in eq.items())
              + f" main_within_1e-4={main:.5f} final_within_2/255={final:.5f} "
              f"hiz_culled={int(g['HiZCulledCount'])}/{int(r['HiZCulledCount'])}")
        check(min(eq.values()) >= 0.999 and main >= 0.995 and final >= 0.999,
              "card shadow frame disagrees with the CPU path")


CULL_GRAPH = ["DepthPrepass", "LinearizeDepth", "LightCulling", "DepthHighZ", "RenderScene",
              "EyeAdaptation"]


def check_culled_frame():
    """The HiZ cull on the card against the CPU path at a nonzero count:
    ``scenes.occlusion_scene`` (24 cubes behind a wall, 128x96) through
    DepthPrepass -> LinearizeDepth -> LightCulling -> DepthHighZ ->
    RenderScene -> EyeAdaptation, two frames with the state threaded
    through. Frame 2 culls the hidden cubes against frame 1's pyramid;
    its HiZCulledCount (> 0), Depth and TriId must equal the CPU path's
    exactly, as must frame 1's."""
    import torch

    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
    from sailor_tpu_torch.scenes import occlusion_scene

    out = {}
    for dev in ("cuda", "cpu"):
        scene = occlusion_scene(128, 96, device=dev)
        fg = FrameGraph(FrameGraphAsset.from_nodes(CULL_GRAPH), 128, 96,
                        dict(SLICE_CONFIG, bin_capacity=256, bin_rounds=2, hiz_culling=True),
                        device=dev)
        state = fg.initial_state()
        out[dev] = []
        for _ in range(2):
            t, state = fg.process(scene, state)
            out[dev].append({k: t[k].cpu() for k in ("Depth", "TriId", "HiZCulledCount")})
    counts = [(int(g["HiZCulledCount"]), int(r["HiZCulledCount"]))
              for g, r in zip(out["cuda"], out["cpu"])]
    same = all(torch.equal(g[k], r[k]) for g, r in zip(out["cuda"], out["cpu"])
               for k in ("Depth", "TriId", "HiZCulledCount"))
    print(f"culled frame card vs cpu: hiz_culled (card, cpu) per frame={counts} "
          f"depth_tid_count_equal={same}")
    check(counts[1][0] > 0, "the culled frame culled nothing on the card")
    check(same, "the card's culled frame differs from the CPU path")


def _full_graph(width, height, device="cuda", config=None):
    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset

    return FrameGraph(FrameGraphAsset.load(RENDERER), width, height,
                      dict(config or FULL_CONFIG), device=device)


def _turned(scene, yaw):
    """The scene with its camera turned by ``yaw`` rad about y (the same
    position, the previous frame's camera kept for MotionBlur)."""
    import dataclasses
    import math

    import torch

    from sailor_tpu_torch.core import math3d as m3
    from sailor_tpu_torch.rhi.types import FrameData

    f = scene.frame
    cam = f.camera_position
    c, s = math.cos(yaw), math.sin(yaw)
    rot = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]], device=cam.device)
    target = cam + rot @ (torch.tensor([0.0, 0.5, 0.0], device=cam.device) - cam)
    view = m3.look_at(cam, target, torch.tensor([0.0, 1.0, 0.0], device=cam.device))
    frame = FrameData.create(view, f.projection, cam, 0.1, 150.0, dt=1 / 60)
    return dataclasses.replace(scene, frame=frame, prev_frame=f)


def _moved_sun(scene, sun=(-0.25, -0.75, -0.35)):
    import dataclasses

    import numpy as np

    d = np.asarray(sun, np.float32)
    return dataclasses.replace(scene, sky=dataclasses.replace(
        scene.sky, sun_direction=(d / np.linalg.norm(d)).astype(np.float32)))


def run_full_frames(scene, width, height, card):
    """frame[full]: the flagship scene through all of
    content/DefaultRenderer.renderer (``FULL_CONFIG``), 1 warm-up + 5
    frames with the state threaded through and ``prepare`` before each,
    launches counted per frame (B1 5 on the dirty warm-up, 1 cached; B2
    and B3 once). Then per-node ms of a cached frame; one frame with the
    sky made dirty (the camera turned 2e-3 rad, so the cascades re-raster
    too: B1 5, B2 and B3 once, checked) and its per-node ms; the
    environment's full bake (a new Environment node, the sun moved:
    ``prepare`` timed) and one incremental face refresh of the graph's own
    node; peak memory; the output (finite, in [0, 1]); one profiled
    cached frame, last. Returns the launches of frames 1-6."""
    import torch

    from sailor_tpu_torch.framegraph.nodes import EnvironmentNode
    from sailor_tpu_torch.framegraph.graph import RenderContext
    from sailor_tpu_torch.kernels import cuda_lib

    fg = _full_graph(width, height)
    state = fg.initial_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, per_frame, culled, total = [], [], [], {}
    for i in range(6):
        cuda_lib.LAUNCHES.clear()

        def frame():
            fg.prepare(scene, state)
            return fg.process(scene, state)

        ms, (targets, state) = _wall_ms(frame)
        launches = dict(cuda_lib.LAUNCHES)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        times.append(ms)
        per_frame.append(launches)
        culled.append(int(targets["HiZCulledCount"]))
    peak = torch.cuda.max_memory_allocated()
    for i, launches in enumerate(per_frame):
        for name in ("raster_worklist", "resolve_worklist", "shade_forward_plus"):
            want = 5 if (i == 0 and name == "raster_worklist") else 1
            check(launches.get(name, 0) == want,
                  f"frame[full] {i + 1} launched {name} {launches.get(name, 0)} times, not {want}")
    final, sky = targets["Final"], targets["Sky"]
    cov = (targets["TriId"] >= 0).float().mean().item()
    check(tuple(final.shape) == (height, width, 3), f"frame[full]: Final has shape {final.shape}")
    check(bool(torch.isfinite(final).all()) and final.min().item() >= 0.0
          and final.max().item() <= 1.0, "frame[full]: Final is not finite in [0, 1]")
    check(cov > 0.0 and bool(torch.isfinite(sky).all()), "frame[full]: nothing rendered")
    _, _, per_node = fg.process_debug(scene, state)

    turned = _turned(scene, 2e-3)
    fg.prepare(turned, state)
    cuda_lib.LAUNCHES.clear()
    dirty_ms, (t_dirty, _) = _wall_ms(lambda: fg.process(turned, state))
    dirty_launches = dict(cuda_lib.LAUNCHES)
    for name, want in (("raster_worklist", 5), ("resolve_worklist", 1), ("shade_forward_plus", 1)):
        check(dirty_launches.get(name, 0) == want,
              f"frame[full] sky-dirty launched {name} {dirty_launches.get(name, 0)} times, "
              f"not {want}")
    check(not torch.equal(t_dirty["Sky"], sky), "frame[full]: the turned camera kept the sky")
    _, _, per_node_dirty = fg.process_debug(turned, state)

    moved = _moved_sun(scene)
    fresh = EnvironmentNode({})
    ctx = RenderContext(width=width, height=height, scene=moved, state={}, config=fg.config)
    bake_ms, _ = _wall_ms(lambda: fresh.prepare(ctx))
    check(sorted(ctx.state) == sorted(k for k in state if k.startswith("env/")),
          "frame[full]: the bake published other maps")
    bake_parts = env_bake_parts(moved, fg.config)
    sky_parts = sky_march_parts(turned, width, height, fg.config)
    env = next(n for n in fg.nodes if n.node_name == "Environment")
    face_state = dict(state)
    face_ms, _ = _wall_ms(lambda: env.prepare(RenderContext(
        width=width, height=height, scene=moved, state=face_state, config=fg.config)))
    check(env._next_face == 1, "frame[full]: the incremental refresh did not render one face")
    profile(lambda: fg.process(scene, state), card, "profile_full")
    mean = sum(times[1:]) / 5
    print(f"frame[full] {width}x{height}: dirty_frame1_ms={times[0]:.3f} "
          f"cached_frame_ms={[round(m, 3) for m in times[1:]]} cached_mean_ms={mean:.3f} "
          f"sky_dirty_frame_ms={dirty_ms:.3f} env_bake_ms={bake_ms:.3f} "
          f"env_face_ms={face_ms:.3f} peak_mem_bytes={peak} hiz_culled={culled} on {card}")
    print("frame[full] per_node_ms_cached "
          + json.dumps({k: round(v, 3) for k, v in per_node.items()}))
    print("frame[full] per_node_ms_sky_dirty "
          + json.dumps({k: round(v, 3) for k, v in per_node_dirty.items()}))
    print("frame[full] env_bake_parts_ms " + json.dumps(bake_parts) + f" on {card}")
    print("frame[full] sky_march_parts_ms " + json.dumps(sky_parts) + f" on {card}")
    print("frame[full] launches_per_frame " + json.dumps(per_frame)
          + " sky_dirty_frame " + json.dumps(dirty_launches))
    print(f"frame[full] output: coverage={cov:.4f} Final in [{final.min().item():.4f}, "
          f"{final.max().item():.4f}] sky_mean={sky.mean().item():.4f} "
          f"ao_mean={targets['AO'].mean().item():.4f} "
          f"avg_luminance={state['avg_luminance'].item():.5f}")
    return total


def env_bake_parts(scene, config):
    """Wall ms of each step of the environment's full bake, synchronised:
    the cube from the sky, the irradiance map, the four prefiltered mips,
    the BRDF LUT, the SH9 projection."""
    from sailor_tpu_torch.kernels import cubemap as cm
    from sailor_tpu_torch.kernels import ibl
    from sailor_tpu_torch.kernels import sky as sky_k

    res = int(config.get("env_resolution", 64))
    dev = scene.frame.view.device
    parts = {}
    ms, env = _wall_ms(lambda: cm.render_cubemap(
        lambda d: sky_k.sky_radiance(d, scene.sky, 0.0, with_clouds=False), res, dev))
    parts["cube"] = ms
    for name, fn in (("irradiance", lambda: ibl.irradiance_map(env, 16, 128)),
                     ("prefiltered_mips", lambda: ibl.prefiltered_env_mips(env, 4, 32)),
                     ("brdf_lut", lambda: ibl.brdf_lut(64, 128, device=dev)),
                     ("sh9", lambda: ibl.sh9_project(env))):
        parts[name] = _wall_ms(fn)[0]
    return {k: round(v, 3) for k, v in parts.items()}


def sky_march_parts(scene, width, height, config):
    """Wall ms of the Sky node's steps on a dirty frame, synchronised: the
    rays, the cloud march at 1/(downsample * stride), the atmosphere and
    sun (``sky_radiance`` with the clouds given) at 1/downsample, and the
    upsample to the frame."""
    from sailor_tpu_torch.core import math3d as m3
    from sailor_tpu_torch.kernels import sampling
    from sailor_tpu_torch.kernels import sky as sky_k
    from sailor_tpu_torch.raster import interpolate

    q = int(config.get("sky_downsample", 2))
    cs = int(config.get("cloud_stride", 2))
    inv_vp = m3.inverse(scene.frame.view_projection)
    cam, t = scene.frame.camera_position, scene.frame.current_time
    hq, wq = -(-height // q), -(-width // q)
    parts = {}
    parts["rays"], (d, d_c) = _wall_ms(lambda: (
        interpolate.pixel_rays_strided(inv_vp, cam, height, width, q, fused=False),
        interpolate.pixel_rays_strided(inv_vp, cam, height, width, q * cs, fused=False)))
    parts["clouds"], (cl, ct) = _wall_ms(lambda: sky_k.clouds(d_c, scene.sky, t))
    over = (sampling.upsample_bilinear_pow2(cl, (hq, wq)),
            sampling.upsample_bilinear_pow2(ct[..., None], (hq, wq))[..., 0])
    parts["atmosphere_and_sun"], color = _wall_ms(
        lambda: sky_k.sky_radiance(d, scene.sky, t, cloud_override=over))
    parts["upsample"], _ = _wall_ms(
        lambda: sampling.upsample_bilinear_pow2(color, (height, width)))
    return {k: round(v, 3) for k, v in parts.items()}


def check_small_full_frame():
    """A 256x128 DefaultRenderer frame (``FULL_CONFIG``, shadow_resolution
    128) on the card against the CPU path (which the CPU tests hold to the
    JAX package), two frames with ``prepare`` before each, the second
    turned 0.05 rad with the sun moved: Depth, TriId, ShadowMaps and
    HiZCulledCount exact, Sky within 5e-5 * (1 + |cpu|), Main within 1e-4
    relative (to max(|cpu|, 1e-3)) on >= 99.5% of pixels, Final within
    2/255 on every pixel."""
    import torch

    from sailor_tpu_torch.scenes import flagship_scene

    out = {}
    for dev in ("cuda", "cpu"):
        scene = flagship_scene(256, 128, 24, 10, device=dev)
        fg = _full_graph(256, 128, dev, dict(FULL_CONFIG, shadow_resolution=128))
        state = fg.initial_state()
        out[dev] = []
        for s in (scene, _moved_sun(_turned(scene, 0.05))):
            fg.prepare(s, state)
            t, state = fg.process(s, state)
            out[dev].append({k: t[k].cpu() for k in FULL_FRAME_KEYS})
    for i, (g, r) in enumerate(zip(out["cuda"], out["cpu"])):
        ok, line = full_frame_agreement(g, r)
        print(f"small frame[full] {i + 1} card vs cpu: {line}")
        check(ok, "card full frame disagrees with the CPU path")


FULL_FRAME_KEYS = ("Depth", "TriId", "ShadowMaps", "HiZCulledCount", "Sky", "Main", "Final")


def full_frame_agreement(got, ref):
    """A full frame on the card (``got``) against the CPU path's (``ref``),
    dicts of FULL_FRAME_KEYS on the CPU: Depth, TriId, ShadowMaps and
    HiZCulledCount exact, Sky within 5e-5 * (1 + |ref|), Main within 1e-4
    relative (to max(|ref|, 1e-3)) on >= 99.5% of pixels, Final within
    2/255 on every pixel. Returns (ok, the measured figures as a line)."""
    import torch

    exact = {k: bool(torch.equal(got[k], ref[k]))
             for k in ("Depth", "TriId", "ShadowMaps", "HiZCulledCount")}
    sky = ((got["Sky"] - ref["Sky"]).abs() / (1 + ref["Sky"].abs())).max().item()
    rel = ((got["Main"] - ref["Main"]).abs() / ref["Main"].abs().clamp(min=1e-3)).amax(-1)
    main = (rel <= 1e-4).float().mean().item()
    final = (got["Final"] - ref["Final"]).abs().max().item()
    line = (" ".join(f"{k}_equal={v}" for k, v in exact.items())
            + f" sky_rel_err={sky:.3g} main_within_1e-4={main:.5f} "
            f"final_max_err={final:.3g} hiz_culled={int(got['HiZCulledCount'])}")
    return all(exact.values()) and sky <= 5e-5 and main >= 0.995 and final <= 2 / 255, line


# the queue frame (materials on the raster path): flagship_queue_scene's
# Opaque, Masked and Transparent queues through all of DefaultRenderer.renderer
QUEUE_CONFIG = dict(FULL_CONFIG, masked_layers=3, transparent_layers=3)


def queue_inputs(qscene, width, height, config=None):
    """The queue frame's kernel inputs, made by its nodes (no HiZ pyramid
    yet): DepthPrepass (the opaque bins, the masked bins and the masked
    peel), LinearizeDepth and LightCulling, and RenderTransparent's
    two-sided setup with its own bins. Returns (ctx, targets, (tri_t,
    aabb_t, bins_t))."""
    from sailor_tpu_torch.framegraph import nodes as nodes_mod
    from sailor_tpu_torch.framegraph.graph import RenderContext, node_types

    nodes = node_types()
    ctx = RenderContext(width=width, height=height, scene=qscene, state={}, values={},
                        config=dict(config or QUEUE_CONFIG))
    targets = {}
    for name in ("DepthPrepass", "LinearizeDepth", "LightCulling"):
        targets = nodes[name]().process(ctx, targets)
    tri_t, aabb_t, _, sb_t = nodes_mod.transparent_raster(ctx)
    return ctx, targets, (tri_t, aabb_t, sb_t)


def check_queue_kernels(qscene, width, height, card):
    """The material forms of the queue frame's kernels against their plain
    versions, on flagship_queue_scene's own rows at full size: B1 z-bounded
    on RenderTransparent's two-sided setup (its first peel layer, behind
    nothing and in front of Depth; then its second) bit-equal; B2's 29
    planes from the 49-column rows of the opaque and the masked bin sets,
    and its 5-plane ``mode="alpha"`` emit on the masked queue's nearest
    layer, and B10's 29 planes from 49-column grid-k bins of the opaque
    queue, each within B2's bar. Returns the kernel-line entries."""
    import torch

    from sailor_tpu_torch.framegraph import nodes as nodes_mod
    from sailor_tpu_torch.raster import tile_raster as tr

    ctx, targets, (_, _, sb_t) = queue_inputs(qscene, width, height)
    tiles_y, tiles_x = -(-height // tr.TILE_H), -(-width // tr.TILE_W)
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x)
    npix = tiles_y * tr.TILE_H * tiles_x * tr.TILE_W
    sb_o, sb_m = targets["StreamBins"]
    out = {}

    # ---- B1 on the two-sided transparent setup, z-bounded as the peel runs it
    args = (sb_t["rows"], sb_t["big_rows"], sb_t["starts"], sb_t["counts"], sb_t["n_big"])
    cand, pairs = raster_work(*args, tiles_y, tiles_x)
    zb = (targets["Depth"], torch.full_like(targets["Depth"], 2.0))
    out["raster_worklist[two_sided_peel]"], d1, t1 = _raster_check(
        "raster_worklist[two_sided_peel]", tr.rasterize_worklist_cuda,
        tr.rasterize_worklist_plain, args, dict(kw, z_bounds=zb), card,
        (cand, pairs, 17 * 4), ntiles_bytes(sb_t["starts"]) + npix * 8)
    h, w = height, width
    zb = (targets["Depth"], torch.where(t1[:h, :w] >= 0, d1[:h, :w], 0.0))
    _raster_check("raster_worklist[two_sided_peel_layer2]", tr.rasterize_worklist_cuda,
                  tr.rasterize_worklist_plain, args, dict(kw, z_bounds=zb), card,
                  (cand, pairs, 17 * 4), ntiles_bytes(sb_t["starts"]) + npix * 8, reps=3)
    check(int((t1 >= 0).sum()) > 0, "the transparent peel covered no pixel")

    # ---- B2 from the 49-column rows: 29 planes (opaque and masked sets)
    inv_vp = nodes_mod.inverse_view_projection(qscene.frame)
    par = tr._resolve_params(inv_vp, qscene.frame.camera_position, width, height, 0,
                             sb_o["rows"].device)
    tid = torch.nn.functional.pad(targets["TriId"], (0, tiles_x * tr.TILE_W - width,
                                                     0, tiles_y * tr.TILE_H - height),
                                  value=-1).contiguous()
    for label, sb in (("", sb_o), ("[masked_set]", sb_m)):
        kw2 = dict(kw, na=int(sb["na"]), chunk=int(sb["chunk"]))
        res = _resolve_check("resolve_worklist[49]" + label, tr.resolve_worklist_cuda,
                             tr.resolve_worklist_plain,
                             (sb["rows"], sb["big_rows"], tid, sb["starts"], sb["counts"], par),
                             kw2, card, tid, int(sb["na"]), 127)
        out.setdefault("resolve_worklist[49]", res)

    # ---- B2's 5-plane alpha emit on the masked queue's nearest layer
    ma = (sb_m["rows"], sb_m["big_rows"], sb_m["starts"], sb_m["counts"], sb_m["n_big"])
    _, tid_m = tr.rasterize_worklist_cuda(*ma, **kw)
    check(int((tid_m >= 0).sum()) > 0, "the masked queue covers no pixel")
    kw2 = dict(kw, na=int(sb_m["na"]), chunk=int(sb_m["chunk"]), mode="alpha")
    out["resolve_worklist[alpha]"] = _resolve_check(
        "resolve_worklist[alpha]", tr.resolve_worklist_cuda, tr.resolve_worklist_plain,
        (sb_m["rows"], sb_m["big_rows"], tid_m, sb_m["starts"], sb_m["counts"], par), kw2,
        card, tid_m, int(sb_m["na"]), 91)

    # ---- B10 from 49-column grid-k bins (the opaque queue, B7's winners)
    tri, aabb = targets["TriSetup"], targets["TriAABB"]
    queue = nodes_mod._queue_of_raster_tris(qscene, tri)
    cfg = dict(QUEUE_CONFIG, raster_worklist=False)
    raster, ovf, sb10 = nodes_mod._make_raster(
        tri, tri.valid & (queue == 0), aabb, tiles_y, tiles_x, cfg,
        capacity=cfg["bin_capacity"], rounds=cfg["bin_rounds"],
        attrs=nodes_mod._packed_attrs(qscene, tri, cfg))
    check(int(ovf) == 0, f"B7 drops {int(ovf)} candidates past kmax on the queue frame")
    _, tid10 = raster()
    c0, spt, _ = tr.stream_windows(sb10["starts"], sb10["counts"], sb10["chunk"], sb10["kmax"])
    out["resolve_stream[49]"] = _resolve_check(
        "resolve_stream[49]", tr.resolve_stream_cuda, tr.resolve_stream_plain,
        (sb10["rows"], sb10["big_rows"], tid10.contiguous(), sb10["starts"], sb10["counts"],
         c0, spt, par), dict(kw, na=int(sb10["na"]), chunk=int(sb10["chunk"])), card,
        tid10, int(sb10["na"]), 127)

    sources = {"raster_worklist[two_sided_peel]": ("raster.cu", 442),
               "resolve_worklist[49]": ("resolve.cu", 1310),
               "resolve_worklist[alpha]": ("resolve.cu", 1310),
               "resolve_stream[49]": ("resolve_stream.cu", 1159)}
    return [dict(name=name, route="cuda", source=f"sailor_tpu_torch/csrc/{src}",
                 replaces=f"sailor_tpu/raster/tile_raster.py:{line}", library_ms=None,
                 **out[name]) for name, (src, line) in sources.items()]


@contextlib.contextmanager
def sync_counter():
    """The CUDA sync debug mode on: yields a function giving the
    synchronising calls made so far (each warns once)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield lambda: sum("synchroniz" in str(c.message) for c in caught)
        finally:
            torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def around_node(name, measure):
    """Wraps the process of the frame-graph node type ``name``: yields a
    one-item list that sums measure()'s growth over each call."""
    from sailor_tpu_torch.framegraph.graph import node_types

    cls = node_types()[name]
    inner, acc = cls.process, [0]

    def process(self, ctx, targets):
        m0 = measure()
        try:
            return inner(self, ctx, targets)
        finally:
            acc[0] += measure() - m0

    cls.process = process
    try:
        yield acc
    finally:
        cls.process = inner


def run_queue_frames(qscene, width, height, card):
    """frame[queues]: flagship_queue_scene through all of
    content/DefaultRenderer.renderer (``QUEUE_CONFIG``), 1 warm-up + 5
    frames with the state threaded through and ``prepare`` before each:
    frame ms, the masked peel's layers per frame, launches per frame (B1
    1 + peel layers + 3 transparent layers, + 4 cascades on the dirty
    warm-up; B2 2 + 3 full, one alpha a peel layer; B3 once). Then the
    synchronising calls of a cached frame, per-node ms of a cached frame,
    peak memory, the output (finite, in [0, 1], all three queues on
    screen), one profiled cached frame; and one frame on the grid-k path
    (``raster_worklist`` off: B7, and B10 from the 49-column rows, the
    masked alpha through B10's full emit). Returns (launches of frames
    1-6, launches of the grid-k frame); the launches' key
    "raster_worklist[two_sided_peel]" counts the B1 launches made inside
    RenderTransparent."""
    import torch

    from sailor_tpu_torch.kernels import cuda_lib

    fg = _full_graph(width, height, config=QUEUE_CONFIG)
    state = fg.initial_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, per_frame, layers, total = [], [], [], {}
    for i in range(6):
        cuda_lib.LAUNCHES.clear()

        def frame():
            fg.prepare(qscene, state)
            return fg.process(qscene, state)

        with around_node("RenderTransparent",
                         lambda: cuda_lib.LAUNCHES.get("raster_worklist", 0)) as peel:
            ms, (targets, state) = _wall_ms(frame)
        launches = dict(cuda_lib.LAUNCHES, **{"raster_worklist[two_sided_peel]": peel[0]})
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        times.append(ms)
        per_frame.append(launches)
        layers.append(targets["MaskedPeelLayers"])
    peak = torch.cuda.max_memory_allocated()
    for i, (launches, n) in enumerate(zip(per_frame, layers)):
        want = {"raster_worklist": 1 + n + 3 + (4 if i == 0 else 0),
                "raster_worklist[two_sided_peel]": 3,
                "resolve_worklist": 2 + 3 + n, "resolve_worklist_alpha": n,
                "shade_forward_plus": 1}
        for name, k in want.items():
            check(launches.get(name, 0) == k,
                  f"frame[queues] {i + 1} launched {name} {launches.get(name, 0)} times, not {k}")
    with sync_counter() as syncs, around_node("DepthPrepass", syncs) as prepass_syncs:
        fg.prepare(qscene, state)
        fg.process(qscene, state)
        frame_syncs = syncs()
    _, _, per_node = fg.process_debug(qscene, state)
    final = targets["Final"]
    tid = targets["TriId"]
    src = targets["TriSetup"].src_id.long()
    queue = qscene.materials.queue[qscene.geometry.material_id[src[tid.clamp(min=0).long()]]
                                   .long()]
    on_screen = [int(((tid >= 0) & (queue == q)).sum()) for q in (0, 1)]
    check(tuple(final.shape) == (height, width, 3), f"frame[queues]: Final has shape {final.shape}")
    check(bool(torch.isfinite(final).all()) and final.min().item() >= 0.0
          and final.max().item() <= 1.0, "frame[queues]: Final is not finite in [0, 1]")
    check(min(on_screen) > 0, f"frame[queues]: opaque and masked winners {on_screen}")
    profile(lambda: (fg.prepare(qscene, state), fg.process(qscene, state)), card,
            "profile_queues")
    gfg = _full_graph(width, height, config=dict(QUEUE_CONFIG, raster_worklist=False))
    gstate = gfg.initial_state()
    gfg.prepare(qscene, gstate)
    cuda_lib.LAUNCHES.clear()
    grid_ms, (gt, _) = _wall_ms(lambda: gfg.process(qscene, gstate))
    grid = dict(cuda_lib.LAUNCHES)
    check(grid.get("resolve_stream", 0) == 2 + 3 + gt["MaskedPeelLayers"]
          and grid.get("raster_stream", 0) == 1 + gt["MaskedPeelLayers"] + 3 + 4,
          f"frame[queues] grid-k launched {grid}")
    mean = sum(times[1:]) / 5
    print(f"frame[queues] {width}x{height}: dirty_frame1_ms={times[0]:.3f} "
          f"cached_frame_ms={[round(m, 3) for m in times[1:]]} cached_mean_ms={mean:.3f} "
          f"masked_peel_layers={layers} host_syncs_cached_frame={frame_syncs} "
          f"(DepthPrepass {prepass_syncs[0]} of them) peak_mem_bytes={peak} on {card}")
    print("frame[queues] per_node_ms_cached "
          + json.dumps({k: round(v, 3) for k, v in per_node.items()}))
    print("frame[queues] launches_per_frame " + json.dumps(per_frame))
    print(f"frame[queues] grid-k frame: ms={grid_ms:.3f} launches " + json.dumps(grid))
    print(f"frame[queues] output: coverage={(tid >= 0).float().mean().item():.4f} "
          f"opaque_px={on_screen[0]} masked_px={on_screen[1]} Final in "
          f"[{final.min().item():.4f}, {final.max().item():.4f}] "
          f"avg_luminance={state['avg_luminance'].item():.5f}")
    return total, grid


def check_small_queue_frame():
    """A 256x128 queue frame (``QUEUE_CONFIG``, shadow_resolution 128) on
    the card against the CPU path (which the CPU tests hold to the JAX
    package): Depth, TriId and ShadowMaps exact, Main within 1e-4
    relative (to max(|cpu|, 1e-3)) on >= 99.5% of pixels, Final within
    2/255 on every pixel."""
    import torch

    from sailor_tpu_torch.scenes import flagship_queue_scene

    out = {}
    for dev in ("cuda", "cpu"):
        scene = flagship_queue_scene(256, 128, 24, 10, device=dev)[0]
        fg = _full_graph(256, 128, dev, dict(QUEUE_CONFIG, shadow_resolution=128))
        state = fg.initial_state()
        fg.prepare(scene, state)
        t, _ = fg.process(scene, state)
        out[dev] = {k: t[k].cpu() for k in ("Depth", "TriId", "ShadowMaps", "Main", "Final")}
        out[dev]["layers"] = t["MaskedPeelLayers"]
    g, r = out["cuda"], out["cpu"]
    exact = {k: bool(torch.equal(g[k], r[k])) for k in ("Depth", "TriId", "ShadowMaps")}
    rel = ((g["Main"] - r["Main"]).abs() / r["Main"].abs().clamp(min=1e-3)).amax(-1)
    main = (rel <= 1e-4).float().mean().item()
    final = (g["Final"] - r["Final"]).abs().max().item()
    print("small frame[queues] card vs cpu: "
          + " ".join(f"{k}_equal={v}" for k, v in exact.items())
          + f" main_within_1e-4={main:.5f} final_max_err={final:.3g} "
          f"masked_peel_layers={g['layers']}/{r['layers']}")
    check(all(exact.values()) and main >= 0.995 and final <= 2 / 255,
          "card queue frame disagrees with the CPU path")


def record_passes(scene, cam, view, proj, width, height, seed=0, sample_batch=1):
    """Every intersector pass of one ``render_cached`` pass of
    ``sample_batch`` samples at width x height with two bounces: [bounce-0
    camera rays, their shadow rays, bounce-1 rays, their shadow rays], each
    a dict of origin, direction, any_hit and active, recorded by wrapping
    the tracer's ``_isect`` for the length of one render."""
    from sailor_tpu_torch.raytracing import path_tracer

    isect, log = path_tracer._isect, []

    def recording(scene, origin, direction, *, any_hit=False, active=None):
        log.append(dict(origin=origin, direction=direction, any_hit=any_hit, active=active))
        return isect(scene, origin, direction, any_hit=any_hit, active=active)

    path_tracer._isect = recording
    try:
        path_tracer.render_cached(scene, cam, view, proj, width=width, height=height,
                                  spp=sample_batch, max_bounces=2, seed=seed,
                                  sample_batch=sample_batch)
    finally:
        path_tracer._isect = isect
    return log


def tracer_passes(scene, cam, view, proj, width, height, seed=0):
    """``record_passes`` of one sample, each as the sweep kernels' inputs
    (``sweep.prepare``)."""
    from sailor_tpu_torch.raytracing import sweep

    return [dict(sweep.prepare(scene.sweep, p["origin"], p["direction"],
                               active=p["active"]), any_hit=p["any_hit"])
            for p in record_passes(scene, cam, view, proj, width, height, seed)]


def _sweep_bound(p, work, cluster):
    """The least time of a cluster sweep on the pass ``p`` from its twin's
    ``work`` over a scene of ``cluster`` triangles a cluster: per
    (sub-block, step) pair walked, the 25 rows of the cluster block the
    kernel reads (18 side, 4 num, 3 den: 100 B a column, 25 KB at 256); ~45
    float operations (three 6-term sides, num, den, divide, compares) per
    test of a ray live at its step (any hit stops at a ray's first hit);
    rays' features, tmax and the tables read once, t and index written
    once."""
    from sailor_tpu_torch.raytracing import sweep

    rp = p["feats"].shape[0]
    nbytes = (work["pairs"] * sweep.USED_ROWS * cluster * 4 + rp * 76
              + 4 * (p["e_bits"].numel() + 2 * p["order"].numel() + p["nlive"].numel()))
    return _bound(nbytes, work["tests"] * 45)


def packed_walk(p, g_cluster, *, any_hit):
    """The cluster sweeps' mapping on the card (csrc/sweep_common.cuh) in
    plain PyTorch: for the count of live rays a walked pair, and for the CPU
    test of the kernels' merge order against the twins. Every
    (sub-block, step) pair the grid walks (B5's pairs) packs the rays live at
    the step's start (best t > 1e-4), at any sub-block size (the kernels
    test a list of at most 256 of them at a time; a ray's result does not
    depend on its list), and tests them against the cluster a
    chunk of 256 columns at a time (``g_cluster``'s last axis is the cluster
    size), each chunk in 8 slices of 32 columns, one a warp; columns past
    the cluster's end hold no triangle and never hit. Every chunk tests
    against the t at the step's start. Closest hit: each slice is reduced to
    its least t, equal t going to the larger column, and the slices are
    merged in order, chunk by chunk (least t, equal t to the later slice);
    the test already asked t < best. Any hit: a hit in any slice retires the
    ray (t = -1, index 0). Returns (t, idx, live rays summed over the
    walked pairs)."""
    import torch

    from sailor_tpu_torch.raytracing import sweep

    e_bits, order, feats = p["e_bits"], p["order"], p["feats"]
    nb, nc = order.shape
    cluster = g_cluster.shape[2]
    sub = sweep.check_ray_block()[1]
    width = -(-cluster // 256) * 256  # whole chunks
    nsb, slices = feats.shape[0] // sub, width // 32
    t = p["tmax"].clone().view(nsb, sub)
    idx = torch.full_like(t, -1, dtype=torch.int32)
    f = feats.view(nsb, sub, sweep.FEATS)
    blk = torch.arange(nsb, device=feats.device) // (nsb // nb)
    col = torch.arange(width, device=feats.device, dtype=torch.int32).view(slices, 32)
    g_cluster = torch.nn.functional.pad(g_cluster, (0, width - cluster))
    valid = torch.arange(width, device=feats.device) < cluster
    live_rays = 0
    for j in range(nc):
        bound = t.view(torch.int32).amax(1)
        for s in (e_bits[:, j] < bound).nonzero()[:, 0].split(max(1, 64 * 256 // sub)):
            cid = order[blk[s], j]
            g = g_cluster[cid.long()][:, None]               # (n, 1, 40, width)
            r = f[s][..., None]                              # (n, sub, 16, 1)
            best = t[s]
            live = best > 1e-4
            live_rays += int(live.sum())
            sides = []
            for e in range(3):
                acc = r[:, :, 0] * g[:, :, 8 * e]
                for k in range(1, 6):
                    acc = acc + r[:, :, k] * g[:, :, 8 * e + k]
                sides.append(acc)
            s0, s1, s2 = sides
            num = ((r[:, :, 8] * g[:, :, 24] + r[:, :, 9] * g[:, :, 25])
                   + r[:, :, 10] * g[:, :, 26]) + g[:, :, 27]
            den = (r[:, :, 0] * g[:, :, 36] + r[:, :, 1] * g[:, :, 37]) + r[:, :, 2] * g[:, :, 38]
            agree = (((s0 >= 0) & (s1 >= 0) & (s2 >= 0))
                     | ((s0 <= 0) & (s1 <= 0) & (s2 <= 0)))
            tval = num / torch.where(den == 0.0, 1.0, den)
            ok = (live[..., None] & valid & agree & (den != 0.0) & (tval > 1e-4)
                  & (tval < best[..., None])).view(-1, sub, slices, 32)
            tm = torch.where(ok, tval.view(ok.shape), torch.inf)
            smin = tm.amin(3)                                # (n, sub, slices)
            sk = torch.where(ok & (tm == smin[..., None]), col, -1).amax(3)
            if any_hit:
                found = (sk >= 0).any(2)
                t[s] = torch.where(found, -1.0, best)
                idx[s] = torch.where(found, 0, idx[s])
                continue
            cur, ci = torch.full_like(best, torch.inf), torch.full_like(idx[s], -1)
            for w in range(slices):
                take = (sk[..., w] >= 0) & (smin[..., w] <= cur)
                cur = torch.where(take, smin[..., w], cur)
                ci = torch.where(take, sk[..., w], ci)
            t[s] = torch.where(ci >= 0, cur, best)
            idx[s] = torch.where(ci >= 0, cid[:, None] * cluster + ci, idx[s])
    return t.view(-1), idx.view(-1), live_rays


def sparse_pass(sweep_scene, p, live):
    """The pass ``p`` with ``live`` rays live in each sub-block, the first
    ones (0, 1, 33 or all 256: the packing's edges): those keep their tmax
    (+inf where ``p`` has them dead), the others are dead (tmax = -1); the
    visit tables are rebuilt for the new tmax."""
    import torch

    from sailor_tpu_torch.raytracing import sweep

    feats, tmax = p["feats"], p["tmax"]
    rank = torch.arange(feats.shape[0], device=feats.device) % sweep.SUB
    tmax = torch.where(rank < live, torch.where(tmax > 1e-4, tmax, torch.inf), -1.0)
    return dict(sweep._tables(sweep_scene, feats[:, 8:11].contiguous(),
                              feats[:, 0:3].contiguous(), tmax), any_hit=p["any_hit"])


def tied_clusters(g_cluster):
    """Clusters with exact ties, for any cluster size c (``g_cluster``'s
    last axis): columns 32-63 repeat 0-31 (ties across the kernels' warp
    slices; as far as the cluster reaches), column 129 repeats 128 (a tie
    within one slice; at c <= 129 the last column repeats the one before),
    and at c > 256 columns 256-287 repeat 0-31 (ties across the kernels'
    256-column chunks)."""
    g = g_cluster.clone()
    c = g.shape[2]
    n = min(64, c) - 32
    if n > 0:
        g[:, :, 32:32 + n] = g[:, :, 0:n]
    if c > 129:
        g[:, :, 129] = g[:, :, 128]
    elif c >= 2:
        g[:, :, c - 1] = g[:, :, c - 2]
    n = min(288, c) - 256
    if n > 0:
        g[:, :, 256:256 + n] = g[:, :, 0:n]
    return g


def _bits_equal(ta, ia, tb, ib):
    import torch

    return bool(torch.equal(ia, ib)) and bool(torch.equal(ta.view(torch.int32),
                                                          tb.view(torch.int32)))


TABLES = ("feats", "e_bits", "order", "blk_bits", "nlive")


def bits_equal(a, b):
    """Float tensors equal bit for bit, a NaN matching any NaN (some shadow
    rays carry infinite coordinates, whose feature rows hold NaN; its bits
    are no part of the result)."""
    import torch

    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and bool(torch.equal(
        torch.where(nan, 0, a.view(torch.int32)), torch.where(nan, 0, b.view(torch.int32))))


def tables_equal(a, b):
    """B4's outputs equal, bit for bit: the feature rows and four tables."""
    import torch

    return bits_equal(a["feats"], b["feats"]) and all(
        bool(torch.equal(a[k], b[k])) for k in TABLES[1:])


def check_sparse_sweeps(sw, passes):
    """B4's tables against their twin, and B5 and B6 against their twin and
    each other (t bits, ids), on the bounce-1 passes with 0, 1, 33 and all
    256 rays of each sub-block live, and with all live on clusters with
    exact ties."""
    from sailor_tpu_torch.raytracing import sweep

    for name in ("bounce1", "bounce1_shadow"):
        for live, tied in ((0, False), (1, False), (33, False), (256, False), (256, True)):
            p = sparse_pass(sw, passes[name], live)
            label = f"{name}, {live} live a sub-block{', tied' if tied else ''}"
            o, d = p["feats"][:, 8:11].contiguous(), p["feats"][:, 0:3].contiguous()
            check(tables_equal(p, sweep.visit_tables_plain(o, d, p["tmax"], sw.cl_min,
                                                           sw.cl_max)),
                  f"slab entry kernel disagrees with its plain version ({label})")
            g = tied_clusters(sw.g_cluster) if tied else sw.g_cluster
            a5 = (p["e_bits"], p["order"], p["blk_bits"], p["nlive"], p["feats"], p["tmax"], g)
            kw = dict(any_hit=p["any_hit"])
            t5, i5 = sweep.sweep_cuda(*a5, **kw)
            t6, i6 = sweep.sweep_grid_cuda(*a5[:2], *a5[4:], **kw)
            tp, ip = sweep.sweep_plain(*a5, **kw)
            ok = _bits_equal(t5, i5, tp, ip) and _bits_equal(t6, i6, tp, ip)
            print(f"sparse sweep[{label}]: b4_tables_equal=True b5_and_b6_equal_to_twin={ok} "
                  f"hits={int((ip >= 0).sum())}")
            check(ok, f"sweep kernels disagree with their twin on a sparse pass ({label})")


def check_tracer_kernels(card):
    """B4, B5 and B6 against their plain versions on the tracer's own rays,
    and B6 against B5."""
    import torch

    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.raytracing import sweep
    from sailor_tpu_torch.scenes import tracer_scene

    scene, cam, view, proj = tracer_scene()
    width, height = TRACER[:2]
    sw = scene.sweep
    names = ["bounce0", "bounce0_shadow", "bounce1", "bounce1_shadow"]
    passes = dict(zip(names, tracer_passes(scene, cam, view, proj, width, height)))
    rows = {}
    for name, p in passes.items():
        feats, tmax = p["feats"], p["tmax"]
        rp, nc = feats.shape[0], sw.n_clusters
        # ---- B4 slab entry, feature rows and visit tables: all bit-equal
        # (the rows also to the pass's own), one launch, no host sync
        args4 = (feats[:, 8:11].contiguous(), feats[:, 0:3].contiguous(), tmax, sw.cl_min,
                 sw.cl_max)
        before = cuda_lib.LAUNCHES["slab_entry"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            k4 = sweep.visit_tables_cuda(*args4)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launched = cuda_lib.LAUNCHES["slab_entry"] - before
        plain_ms, p4 = _wall_ms(lambda: sweep.visit_tables_plain(*args4))
        ms = _time_ms(lambda: sweep.visit_tables_cuda(*args4), 20)
        same = tables_equal(k4, p4) and bits_equal(k4["feats"], feats)
        e_blk = sub_entries(p4).view(-1, sweep.RAY_BLOCK // sweep.SUB, nc).amin(1)
        ranks_ok = bool(torch.equal(visit_order(e_blk).to(torch.int32), p4["order"]))
        # origin, direction and tmax (28 B) read per ray, boxes; feature
        # rows (64 B) and the four tables written; ~30 operations per (ray,
        # cluster), none of them fused: 6 products and differences, 6
        # selects, 2 compares, the hit test and the entry
        nsb, nb = rp // sweep.SUB, rp // sweep.RAY_BLOCK
        bound, by = _bound(rp * (28 + 64) + nc * 24 + (nsb * nc + 2 * nb * nc + nb) * 4,
                           rp * nc * 30)
        print(f"kernel slab_entry[{name}]: bit_equal={same} launches={launched} "
              f"no_host_sync=True rank_model_equal={ranks_ok} ms={ms:.4f} "
              f"plain_ms={plain_ms:.2f} bound_ms={bound:.5f} ({by}) rays={rp} "
              f"clusters={nc} live_block_steps={int(p4['nlive'].sum())} on {card}")
        check(same and launched == 1 and ranks_ok,
              f"slab entry kernel disagrees with its plain version ({name})")
        rows.setdefault("slab_entry", {})[name] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        # ---- B5 sweep: t bits and ids equal to its twin's
        any_hit = p["any_hit"]
        args5 = (p["e_bits"], p["order"], p["blk_bits"], p["nlive"], feats, tmax,
                 sw.g_cluster)
        t_k, i_k = sweep.sweep_cuda(*args5, any_hit=any_hit)
        work = {}
        plain_ms, (t_p, i_p) = _wall_ms(lambda: sweep.sweep_plain(*args5, any_hit=any_hit,
                                                                   work=work))
        ms = _time_ms(lambda: sweep.sweep_cuda(*args5, any_hit=any_hit), 10)
        same = _bits_equal(t_k, i_k, t_p, i_p)
        pairs, tests = work["pairs"], work["tests"]
        bound, by = _sweep_bound(p, work, sw.cluster)
        # how sparse the pass is: the share of the (ray, triangle) lanes of
        # the walked pairs that the bound charges, and the rays live a pair
        lane_use = tests / max(1, pairs * sweep.SUB * sw.cluster)
        t_m, i_m, live = packed_walk(p, sw.g_cluster, any_hit=any_hit)
        live_per_pair = live / max(1, pairs)
        kind = "any" if any_hit else "closest"
        print(f"kernel sweep_{kind}[{name}]: bit_equal={same} "
              f"ms={ms:.4f} plain_ms={plain_ms:.2f} bound_ms={bound:.5f} ({by}) "
              f"pairs={pairs} of {p['e_bits'].numel()} tests={tests} lane_use={lane_use:.5f} "
              f"live_rays_per_pair={live_per_pair:.2f} hits={int((i_k >= 0).sum())} on {card}")
        check(same, f"sweep kernel disagrees with its plain version ({name})")
        check(_bits_equal(t_m, i_m, t_p, i_p), f"the kernels' mapping disagrees with the twin ({name})")
        rows.setdefault("sweep", {})[name] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        # ---- B6 grid sweep: t bits and ids equal to its twin's and to B5's
        args6 = (p["e_bits"], p["order"], feats, tmax, sw.g_cluster)
        t_g, i_g = sweep.sweep_grid_cuda(*args6, any_hit=any_hit)
        work6 = {}
        plain_ms, (t_gp, i_gp) = _wall_ms(lambda: sweep.sweep_grid_plain(
            *args6, any_hit=any_hit, work=work6))
        ms = _time_ms(lambda: sweep.sweep_grid_cuda(*args6, any_hit=any_hit), 10)
        to_twin, to_b5 = _bits_equal(t_g, i_g, t_gp, i_gp), _bits_equal(t_g, i_g, t_k, i_k)
        bound, by = _sweep_bound(p, work6, sw.cluster)
        print(f"kernel sweep_grid_{kind}[{name}]: equal_to_twin={to_twin} equal_to_b5={to_b5} "
              f"ms={ms:.4f} plain_ms={plain_ms:.2f} bound_ms={bound:.5f} ({by}) "
              f"pairs={work6['pairs']} steps={p['e_bits'].numel()} tests={work6['tests']} "
              f"lane_use={lane_use:.5f} live_rays_per_pair={live_per_pair:.2f} "
              f"b5_ms={rows['sweep'][name]['ms']:.4f} on {card}")
        check(to_twin and to_b5 and work6 == work,
              f"grid sweep kernel disagrees with its plain version or with B5 ({name})")
        rows.setdefault("sweep_grid", {})[name] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    check_sparse_sweeps(sw, passes)
    # the JSON rows: the incoherent bounce-1 closest-hit pass
    return [
        dict(name="slab_entry", source="sailor_tpu_torch/csrc/slab_entry.cu",
             replaces="sailor_tpu/raytracing/sweep.py:185", route="cuda", library_ms=None,
             **rows["slab_entry"]["bounce1"]),
        dict(name="sweep", source="sailor_tpu_torch/csrc/sweep.cu",
             replaces="sailor_tpu/raytracing/sweep.py:379", route="cuda", library_ms=None,
             **rows["sweep"]["bounce1"]),
        dict(name="sweep_grid", source="sailor_tpu_torch/csrc/sweep_grid.cu",
             replaces="sailor_tpu/raytracing/sweep.py:269", route="cuda", library_ms=None,
             **rows["sweep_grid"]["bounce1"]),
    ]


def run_tracer(card):
    """The tracer's main path: 1 warm-up + 3 timed renders of the bench
    tracer scene at TRACER: (launch counts of that run, peak device
    bytes)."""
    import torch

    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.raytracing import path_tracer
    from sailor_tpu_torch.scenes import tracer_scene

    width, height, bounces, spp = TRACER
    scene, cam, view, proj = tracer_scene()
    print(f"tracer scene: {scene.sweep.num_tris} triangles in {scene.sweep.n_clusters} "
          f"clusters, {width}x{height}, {bounces} bounces, {spp} spp")
    kw = dict(width=width, height=height, spp=spp, max_bounces=bounces)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.LAUNCHES.clear()
    renders = 4
    warm_ms, _ = _wall_ms(lambda: path_tracer.render_cached(scene, cam, view, proj, seed=0,
                                                            **kw))
    times, counts = [], []
    for rep in range(renders - 1):
        ms, (img, rays) = _wall_ms(
            lambda: path_tracer.render_cached(scene, cam, view, proj, seed=1 + rep, **kw))
        times.append(ms)
        counts.append(float(rays))
    launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    mrays = [c / (ms / 1e3) / 1e6 for c, ms in zip(counts, times)]
    print(f"trace {width}x{height} b{bounces} spp{spp}: warmup_ms={warm_ms:.1f} "
          f"render_ms={[round(m, 1) for m in times]} rays={counts} "
          f"mrays_per_s={[round(m, 4) for m in mrays]} best_mrays_per_s={max(mrays):.4f} "
          f"peak_mem_bytes={peak} on {card}")
    per_render = {k: v / renders for k, v in launches.items()}
    print("trace_launches_per_render " + json.dumps(per_render))
    for name in ("slab_entry", "sweep"):
        check(per_render.get(name, 0) == 2 * bounces * spp,
              f"{name}: {per_render.get(name, 0)} launches a render, not 2 * bounces * spp")
    check(tuple(img.shape) == (height, width, 3), f"image has shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "image has non-finite values")
    check(img.min().item() >= 0.0, "image has negative radiance")
    print(f"output: image in [{img.min().item():.4f}, {img.max().item():.4f}] "
          f"mean={img.mean().item():.5f}")
    profile(lambda: path_tracer.render_cached(scene, cam, view, proj, seed=9,
                                              **dict(kw, spp=1)), card, "profile_trace_sample")
    return launches, peak


def _bvh8_bound(rays, work):
    """The least time of a BVH8 traversal from its twin's ``work``: each
    distinct row the rays read, once (the half its flag selects and the
    flag: 284 B of a leaf, 228 B of an internal row), rays' origin,
    direction, t0 and active (29 B) read and t, tri, u, v (16 B) written
    once; ~50 float operations a triangle slot, ~25 a child of every row
    read."""
    from sailor_tpu_torch.raytracing import bvh8

    nbytes = (work["distinct_leaf_rows"] * bvh8.LEAF_ROW_BYTES
              + work["distinct_inner_rows"] * bvh8.INNER_ROW_BYTES + rays * (29 + 16))
    return _bound(nbytes, work["leaf_rows"] * 7 * 50 + work["inner_rows"] * 8 * 25)


def bvh8_walks(table, args, any_hit):
    """Each ray's walk through the BVH8 twin: (t, tri, u, v, work, walks),
    ``walks`` = (start, length, kinds) numpy arrays: ray i's rows are
    kinds[start[i]:start[i] + length[i]] in order (True for a leaf), as
    ``intersect_plain``'s ``on_step`` sees them."""
    import torch

    from sailor_tpu_torch.raytracing import bvh8

    record, work = [], {}
    out = bvh8.intersect_plain(table, *args, any_hit=any_hit, work=work,
                               on_step=lambda idx, leaf: record.append((idx, leaf)))
    n = args[0].shape[0]
    if record:
        idx = torch.cat([i for i, _ in record]).cpu()
        leaf = torch.cat([f for _, f in record]).cpu()
    else:
        idx, leaf = torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.bool)
    length = torch.bincount(idx, minlength=n)
    start = torch.cumsum(length, 0) - length
    kinds = leaf[torch.sort(idx, stable=True).indices]  # iteration order within a ray
    return (*out, work, (start.numpy(), length.numpy(), kinds.numpy()))


def bvh8_schedule(walks, active, warps, refill_idle, leaf_wait):
    """The BVH8 kernel's schedule (csrc/bvh8.cu) in plain numpy, on the
    walks of ``bvh8_walks``: ``warps`` persistent warps run in lockstep,
    one iteration each a step. An iteration: every warp that has no ray
    pending and at least ``refill_idle`` idle lanes (and has not seen the
    counter pass the rays) fetches the next 32 rays in warp order; the
    active ones wait, in ray order, and idle lanes take them in lane
    order; then the warp steps its internal rows, and its leaf rows when it
    has no internal row or after ``leaf_wait`` internal steps with a leaf
    waiting; a ray whose walk ends frees its lane. Returns the rows each
    ray stepped, ``lane_steps``, ``warp_steps`` (warp iterations with a
    ray), ``warp_branch_steps`` (branches run: one or two an iteration),
    ``longest_warp`` (the most branches one warp ran) and ``iterations``.
    With ``refill_idle`` 32 and ``leaf_wait`` 0 and a warp for every 32
    rays, this is the one-thread-a-ray mapping that the twin's ``work``
    counts."""
    import numpy as np

    start, length, kinds = walks
    act = np.asarray(active, bool)
    n = len(act)
    lane = np.arange(32)
    ray = np.full((warps, 32), -1)
    pos = np.zeros((warps, 32), np.int64)
    pend = np.full((warps, 32), -1)
    head, count = np.zeros(warps, np.int64), np.zeros(warps, np.int64)
    drained = np.zeros(warps, bool)
    waited = np.zeros(warps, np.int64)
    branches = np.zeros(warps, np.int64)
    rows = np.zeros(n, np.int64)
    counter = lane_steps = warp_steps = iterations = 0
    while True:
        idle = ray < 0
        nidle = idle.sum(1)
        fetch = np.nonzero(~drained & (head == count) & (nidle >= refill_idle))[0]
        if len(fetch):
            base = counter + 32 * np.arange(len(fetch))
            counter += 32 * len(fetch)
            drained[fetch] = base >= n - 32
            ids = base[:, None] + lane
            ok = ids < n
            ok[ok] = act[ids[ok]]
            # the active rays of each batch, in ray order, then -1
            order = np.argsort(~ok, axis=1, kind="stable")
            pend[fetch] = np.where(np.take_along_axis(ok, order, 1),
                                   np.take_along_axis(ids, order, 1), -1)
            head[fetch], count[fetch] = 0, ok.sum(1)
        take = np.minimum(nidle, count - head)
        rank = np.cumsum(idle, 1) - 1
        w, l = np.nonzero(idle & (rank < take[:, None]))
        ray[w, l] = pend[w, head[w] + rank[w, l]]
        pos[w, l] = 0
        head += take
        busy = ray >= 0
        if not busy.any():
            if drained.all():
                break
            continue
        iterations += 1
        leaf = busy & kinds[np.where(busy, start[np.maximum(ray, 0)] + pos, 0)]
        inner = busy & ~leaf
        inner_turn = inner.any(1)
        leaves = leaf.any(1)
        leaf_turn = leaves & (~inner_turn | (waited >= leaf_wait))
        waited = np.where(leaf_turn, 0, waited + leaves)
        stepped = (inner & inner_turn[:, None]) | (leaf & leaf_turn[:, None])
        warp_steps += int(busy.any(1).sum())
        branches += inner_turn.astype(np.int64) + leaf_turn
        lane_steps += int(stepped.sum())
        np.add.at(rows, ray[stepped], 1)
        pos[stepped] += 1
        done = stepped & (pos == length[np.maximum(ray, 0)])
        ray[done] = -1
    return dict(rows=rows, lane_steps=lane_steps, warp_steps=warp_steps,
                warp_branch_steps=int(branches.sum()), longest_warp=int(branches.max()),
                iterations=iterations)


def bvh8_cells():
    """The two cells whose passes take the BVH8 traversal: (label, scene
    maker, sample_batch, spp)."""
    from sailor_tpu_torch.scenes import dense_tracer_scene, tracer_scene

    return [("tracer-512-batch4", tracer_scene, BATCH4, TRACER[3]),
            ("tracer-512-dense", dense_tracer_scene, 1, TRACER_SPP_CUT)]


@contextlib.contextmanager
def around_call(module, name):
    """Wraps ``module.name``: yields a list of each call's wall seconds."""
    inner, secs = getattr(module, name), []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kwargs)
        finally:
            secs.append(time.perf_counter() - t0)

    setattr(module, name, timed)
    try:
        yield secs
    finally:
        setattr(module, name, inner)


THREAD_PER_RAY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                              "torch_bvh8_thread_per_ray.cu")


def start_thread_per_ray_build():
    """Start nvcc on the BVH8 traversal's one-thread-a-ray form
    (tests/torch_bvh8_thread_per_ray.cu: the kernel that the persistent one
    replaced, not in the port's library), to be built beside the port's
    kernels: (process or None if already built, library path)."""
    import hashlib

    from sailor_tpu_torch.kernels import cuda_lib

    with open(THREAD_PER_RAY, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(cuda_lib.NVCC_FLAGS).encode())
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "thread_per_ray",
                       digest.hexdigest()[:16])
    lib = os.path.join(out, "libbvh8_thread_per_ray.so")
    if os.path.exists(lib):
        return None, lib
    os.makedirs(out, exist_ok=True)
    cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", cuda_lib._CSRC, "-shared",
           THREAD_PER_RAY, "-o", lib + f".{os.getpid()}.tmp"]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def thread_per_ray_kernel(build):
    """Wait for ``start_thread_per_ray_build``'s nvcc (printing its ptxas
    lines) and load it: a function (table, args, any_hit) -> (t, tri, u, v)
    that launches the one-thread-a-ray kernel on ``bvh8.ray_inputs``'s
    args. Its launches are not counted: it is no kernel of the port."""
    import ctypes

    import torch

    from sailor_tpu_torch.kernels import cuda_lib

    proc, path = build
    if proc is not None:
        out, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed on {THREAD_PER_RAY}:\n{out}")
        os.replace(path + f".{os.getpid()}.tmp", path)
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print("  one thread a ray: " + line.strip())
    fn = ctypes.CDLL(path).sailor_bvh8_intersect
    sig = cuda_lib._SIGNATURES["sailor_bvh8_intersect"]
    fn.argtypes = list(sig[:-2] + sig[-1:])  # no ray counter
    fn.restype = ctypes.c_int

    def run(table, args, any_hit):
        r = args[0].shape[0]
        out = (torch.empty(r, device=table.device),
               torch.empty(r, dtype=torch.int32, device=table.device),
               torch.empty(r, device=table.device), torch.empty(r, device=table.device))
        cuda_lib.check(fn(table.data_ptr(), *(a.data_ptr() for a in args),
                          *(o.data_ptr() for o in out), r, int(any_hit),
                          cuda_lib.stream_of(table)), "one-thread-a-ray bvh8")
        return out

    return run


def check_bvh8_kernel(scene, cam, view, proj, label, sample_batch, card, thread_per_ray):
    """The BVH8 traversal (csrc/bvh8.cu) against its plain twin on the
    cell's bounce-1 rays, closest and any hit (with their active masks):
    t, tri, u, v bit-equal; timed in turns with the one-thread-a-ray kernel
    it replaced (``thread_per_ray``: that one, this one twice, that one),
    with its bound from the twin's work, the row bytes its rays read in all,
    the pushes dropped at MAX_STACK, and the warp schedules' lane use: the
    one-thread-a-ray mapping's from the twin's work (lane steps over 32 x
    warp steps, and over 32 x warp branch steps) and the kernel's from its
    plain model (``bvh8_schedule`` on the card's resident warps). Returns
    the rows by pass."""
    import torch

    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.raytracing import bvh8

    def equal(a, b):
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))

    width, height = TRACER[:2]
    table = scene.bvh.table
    info = bvh8.kernel_info()
    warps = info["resident_blocks"] * info["threads"] // 32
    rows = {}
    passes = record_passes(scene, cam, view, proj, width, height, sample_batch=sample_batch)
    for name, p in (("bounce1", passes[2]), ("bounce1_shadow", passes[3])):
        args = bvh8.ray_inputs(p["origin"], p["direction"], None, p["active"])
        any_hit = p["any_hit"]
        before = cuda_lib.LAUNCHES["bvh8_intersect"]
        got = bvh8.intersect_cuda(table, *args, any_hit=any_hit)
        launched = cuda_lib.LAUNCHES["bvh8_intersect"] - before
        plain_ms, want = _wall_ms(lambda: bvh8.intersect_plain(table, *args, any_hit=any_hit))
        *_, work, walks = bvh8_walks(table, args, any_hit)
        same = equal(got, want)
        parent_same = equal(thread_per_ray(table, args, any_hit), want)

        def kernel():
            return bvh8.intersect_cuda(table, *args, any_hit=any_hit)

        def parent():
            return thread_per_ray(table, args, any_hit)

        turns = [_time_ms(fn, 20) for fn in (parent, kernel, kernel, parent)]
        ms, parent_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        model = bvh8_schedule(walks, args[3].cpu().numpy(), warps, info["refill_idle"], 0)
        r = args[0].shape[0]
        bound, by = _bvh8_bound(r, work)
        live = int(args[3].sum())
        row_read = (work["leaf_rows"] * bvh8.LEAF_ROW_BYTES
                    + work["inner_rows"] * bvh8.INNER_ROW_BYTES)
        steps = max(1, work["lane_steps"])
        print(f"kernel bvh8_intersect[{label}/{name}]: bit_equal={same} launches={launched} "
              f"ms={ms:.4f} parent_ms={parent_ms:.4f} (one thread a ray, bit_equal="
              f"{parent_same}; turns {[round(t, 4) for t in turns]}) "
              f"plain_ms={plain_ms:.2f} bound_ms={bound:.5f} ({by}) rays={r} "
              f"active={live} hits={int((want[1] >= 0).sum())} "
              f"rows_per_active_ray={(work['leaf_rows'] + work['inner_rows']) / max(1, live):.2f} "
              f"leaf_rows={work['leaf_rows']} inner_rows={work['inner_rows']} "
              f"distinct_rows={work['distinct_leaf_rows'] + work['distinct_inner_rows']} "
              f"row_read_bytes={row_read} "
              f"iterations={work['iterations']} dropped_pushes={work['dropped_pushes']} "
              f"table_rows={table.shape[0]} lane_steps={work['lane_steps']} "
              f"one_thread_a_ray: lane_use={steps / (32 * max(1, work['warp_steps'])):.3f} "
              f"branch_use={steps / (32 * max(1, work['warp_branch_steps'])):.3f} "
              f"persistent_model ({warps} warps, refill at {info['refill_idle']}): "
              f"lane_use={model['lane_steps'] / (32 * max(1, model['warp_steps'])):.3f} "
              f"branch_use={model['lane_steps'] / (32 * max(1, model['warp_branch_steps'])):.3f} "
              f"longest_warp_branches={model['longest_warp']} on {card}")
        check(same and launched == 1 and parent_same,
              f"bvh8 kernel disagrees with its plain version ({label}/{name})")
        check(bool((model["rows"] == walks[1]).all()),
              f"bvh8 schedule model lost rows ({label}/{name})")
        rows[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by)
    return rows


def run_bvh8_cells(card, tracer_peak, thread_per_ray):
    """The two cells whose every pass takes the BVH8 traversal, through
    ``render_cached`` at TRACER's size and depth: tracer-512-batch4 (the
    bench tracer scene, ``sample_batch`` 4: the reference's scalar table
    outgrows 1 MiB, 16 spp, bounce sort on) and tracer-512-dense (294,914
    triangles, "auto" builds no sweep, 4 spp). Each scene is built once
    (its host table build timed inside it) and first holds the kernel to
    its twin (``check_bvh8_kernel``, beside ``thread_per_ray``); then 1
    warm-up + 2 renders, launches
    per render checked (bvh8_intersect 2 * bounces * passes, no sweep, no
    slab entry), the same renders with ``thread_per_ray`` in the kernel's
    place (Mrays/s and peak bytes beside the kernel's; the same image),
    peak bytes against tracer-512's ``tracer_peak`` and, on
    the dense cell, a profiled 1-spp sample. Returns (the JSON row: the
    batch4 cell's bounce-1 closest-hit pass, the launches of both cells'
    renders)."""
    import torch

    from sailor_tpu_torch.raytracing import bvh8, path_tracer

    width, height, bounces, _ = TRACER
    total, rows = {}, {}
    info = bvh8.kernel_info()
    print(f"bvh8 kernel: registers={info['registers']} shared_bytes={info['shared_bytes']} "
          f"local_bytes={info['local_bytes']} resident_blocks={info['resident_blocks']} of "
          f"{info['threads']} threads, refill at {info['refill_idle']} idle lanes on {card}")
    for label, make, sb, spp in bvh8_cells():
        with around_call(bvh8, "build_table") as table_s:
            build_ms, (scene, cam, view, proj) = _wall_ms(make)
        print(f"{label}: {scene.tri_pack.shape[0]} triangles, sweep "
              f"{'none' if scene.sweep is None else scene.sweep.n_clusters}, "
              f"bvh8 rows {scene.bvh.table.shape[0]} of {bvh8.ROW} floats, "
              f"bvh8 host build_s={table_s[0]:.3f}, scene build_ms={build_ms:.1f}, "
              f"{width}x{height}, {bounces} bounces, {spp} spp, sample_batch {sb}")
        rows[label] = check_bvh8_kernel(scene, cam, view, proj, label, sb, card,
                                        thread_per_ray)
        kw = dict(width=width, height=height, spp=spp, max_bounces=bounces, sample_batch=sb)
        cell = f"{label} {width}x{height} b{bounces} spp{spp}"

        def render(seed):
            return path_tracer.render_cached(scene, cam, view, proj, seed=seed, **kw)

        img, launches, per_render, peak = _timed_renders(cell, render, card)
        want = 2 * bounces * spp // sb
        check(per_render.get("bvh8_intersect", 0) == want
              and not per_render.get("sweep") and not per_render.get("slab_entry"),
              f"{label}: {per_render} launches a render, not {want} of bvh8_intersect alone")
        # the same renders on the one-thread-a-ray kernel: the same image
        kernel = bvh8.intersect_cuda
        bvh8.intersect_cuda = lambda table, *args, any_hit: thread_per_ray(table, args, any_hit)
        try:
            parent_img, _, _, parent_peak = _timed_renders(
                f"{cell} on the one-thread-a-ray kernel", render, card)
        finally:
            bvh8.intersect_cuda = kernel
        check(torch.equal(img, parent_img),
              f"{label}: the render differs on the one-thread-a-ray kernel")
        print(f"{label} peak_mem_bytes={peak} (on the one-thread-a-ray kernel {parent_peak}) "
              f"against tracer-512's {tracer_peak} on {card}")
        if label == "tracer-512-dense":
            profile(lambda: path_tracer.render_cached(scene, cam, view, proj, seed=9,
                                                      **dict(kw, spp=1)), card,
                    "profile_dense_sample")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        del scene
    row = dict(name="bvh8_intersect", source="sailor_tpu_torch/csrc/bvh8.cu",
               replaces="sailor_tpu/raytracing/bvh8.py:213", route="cuda", library_ms=None,
               **rows["tracer-512-batch4"]["bounce1"])
    return row, total


def _timed_renders(label, render, card, renders=3):
    """1 warm-up + ``renders - 1`` timed calls of ``render(seed)`` with the
    launch counts cleared before: (last image, launches, per-render
    launches, peak device bytes)."""
    import torch

    from sailor_tpu_torch.kernels import cuda_lib

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.LAUNCHES.clear()
    warm_ms, _ = _wall_ms(lambda: render(0))
    times, counts = [], []
    for rep in range(renders - 1):
        ms, (img, rays) = _wall_ms(lambda: render(1 + rep))
        times.append(ms)
        counts.append(float(rays))
    launches = dict(cuda_lib.LAUNCHES)
    per_render = {k: v / renders for k, v in launches.items()}
    mrays = [c / (ms / 1e3) / 1e6 for c, ms in zip(counts, times)]
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: warmup_ms={warm_ms:.1f} render_ms={[round(m, 1) for m in times]} "
          f"rays={counts} mrays_per_s={[round(m, 4) for m in mrays]} "
          f"peak_mem_bytes={peak} on {card}")
    print(f"{label}_launches_per_render " + json.dumps(per_render))
    check(bool(torch.isfinite(img).all()), f"{label}: image has non-finite values")
    check(img.min().item() >= 0.0, f"{label}: image has negative radiance")
    return img, launches, per_render, peak


def run_tracer_grid(card):
    """The tracer's main path with DMA_SWEEP off, through B6: the bench
    tracer scene at TRACER's size and depth, TRACER_SPP_CUT spp; the image
    must equal the B5 render's at the same seed."""
    import torch

    from sailor_tpu_torch.raytracing import path_tracer, sweep
    from sailor_tpu_torch.scenes import tracer_scene

    width, height, bounces, _ = TRACER
    spp = TRACER_SPP_CUT
    scene, cam, view, proj = tracer_scene()
    kw = dict(width=width, height=height, spp=spp, max_bounces=bounces)
    dma = sweep.DMA_SWEEP
    try:
        sweep.DMA_SWEEP = False
        img, launches, per_render, _ = _timed_renders(
            f"trace_grid {width}x{height} b{bounces} spp{spp}",
            lambda seed: path_tracer.render_cached(scene, cam, view, proj, seed=seed, **kw), card)
        profile(lambda: path_tracer.render_cached(scene, cam, view, proj, seed=9,
                                                  **dict(kw, spp=1)), card,
                "profile_trace_grid_sample")
        check(per_render.get("sweep_grid", 0) == 2 * bounces * spp and "sweep" not in per_render,
              f"grid trace: {per_render} launches a render, not 2 * bounces * spp of sweep_grid")
        sweep.DMA_SWEEP = True  # the last timed render's seed, through B5
        ref, _ = path_tracer.render_cached(scene, cam, view, proj, seed=2, **kw)
    finally:
        sweep.DMA_SWEEP = dma
    same = bool(torch.equal(img, ref))
    print(f"trace_grid vs B5 render at the same seed: equal={same} "
          f"max_abs_diff={(img - ref).abs().max().item():.3g}")
    check(same, "the B6 render differs from the B5 render")
    return launches


def run_material_balls(card):
    """The tracer demo scene at full width: the procedural sky baked for
    miss rays, procedural maps on the ground; render_cached's defaults,
    then sample_batch=2 with SAILOR_SWEEP_SORT=1."""
    from sailor_tpu_torch.kernels.sky import SkyParams
    from sailor_tpu_torch.raytracing import path_tracer
    from sailor_tpu_torch.scenes import material_balls

    width, height, bounces, _ = TRACER
    spp = TRACER_SPP_CUT
    build_ms, (scene, cam, view, proj) = _wall_ms(
        lambda: material_balls(sky=SkyParams.default(), textured=True))
    print(f"material balls: {scene.sweep.num_tris} triangles, env {tuple(scene.env_map.shape)}, "
          f"mips {scene.mip_sizes}, quad rows {tuple(scene.tex_quad.shape)}, "
          f"build_ms={build_ms:.1f}, {width}x{height}, {bounces} bounces, {spp} spp")
    kw = dict(width=width, height=height, spp=spp, max_bounces=bounces)
    _timed_renders("balls[render_cached]", lambda seed: path_tracer.render_cached(
        scene, cam, view, proj, seed=seed, **kw), card)
    profile(lambda: path_tracer.render_cached(scene, cam, view, proj, seed=9, **dict(kw, spp=1)),
            card, "profile_balls_sample")
    sort = os.environ.get("SAILOR_SWEEP_SORT")
    os.environ["SAILOR_SWEEP_SORT"] = "1"
    try:
        _timed_renders("balls[sample_batch=2,sort_rays]", lambda seed: path_tracer.render_cached(
            scene, cam, view, proj, seed=seed, sample_batch=2, **kw), card)
    finally:
        if sort is None:
            del os.environ["SAILOR_SWEEP_SORT"]
        else:
            os.environ["SAILOR_SWEEP_SORT"] = sort


def check_small_trace(scene_fn=None, label="tracer", grid=False, spp=2):
    """A 64x64 render (4 bounces, ``spp`` samples) of ``scene_fn(device)``
    (the tracer scene by default; ``grid``: through B6) on the card against
    the same render on the CPU path (which the CPU tests hold to the JAX
    package), same uniforms: >= 99% of pixels within 1e-3 * (1 + |cpu|)."""
    import torch

    from sailor_tpu_torch.raytracing import path_tracer, sweep
    from sailor_tpu_torch.scenes import tracer_scene

    w = h = 64
    bounces = 4
    gen = torch.Generator().manual_seed(7)
    uniforms = torch.rand((spp, 5 * bounces, path_tracer.rays_per_sample(w, h)), generator=gen)
    out = {}
    dma = sweep.DMA_SWEEP
    try:
        sweep.DMA_SWEEP = not grid
        for dev in ("cuda", "cpu"):
            scene, cam, view, proj = (scene_fn or tracer_scene)(dev)
            img, rays = path_tracer.render_cached(scene, cam, view, proj, width=w, height=h,
                                                  spp=spp, max_bounces=bounces,
                                                  uniforms=uniforms)
            out[dev] = (img.cpu(), float(rays))
    finally:
        sweep.DMA_SWEEP = dma
    ref = out["cpu"][0]
    close = ((out["cuda"][0] - ref).abs().amax(-1) <= 1e-3 * (1 + ref.abs().amax(-1)))
    share = close.float().mean().item()
    print(f"small trace {label} card vs cpu: within_1e-3={share:.5f} rays card={out['cuda'][1]} "
          f"cpu={out['cpu'][1]}")
    check(share >= 0.99, f"card render disagrees with the CPU path ({label})")


SWEEP_CLUSTERS = (64, 128, 256, 512, 1024)  # sweep-clusters' sizes (256: the tracer scene's)
SMALL_CLUSTER = 37  # sweep-clusters' 64x64 card-vs-CPU render: a size no power of two


def cluster_scene(cluster, **soup_kw):
    """A ``scene_fn`` for ``check_small_trace``: ``tracer_scene(device,
    **soup_kw)`` with its sweep built by ``sweep.build_arrays(cluster=)``,
    the host arrays built once for both devices (the dense scene's numpy
    BVH takes half a minute)."""
    import dataclasses

    from sailor_tpu_torch.raytracing import sweep
    from sailor_tpu_torch.scenes import tracer_scene, tracer_soup

    arrays = {}

    def scene_fn(device):
        scene, cam, view, proj = tracer_scene(device, tracer="bvh8", **soup_kw)
        if not arrays:
            soup = tracer_soup(**soup_kw)
            p, i = soup["position"], soup["indices"]
            arrays.update(sweep.build_arrays(p[i[:, 0]], p[i[:, 1]], p[i[:, 2]],
                                             cluster=cluster))
        sw = sweep.sweep_scene_from_numpy(arrays, scene.tri_pack.device)
        return dataclasses.replace(scene, sweep=sw), cam, view, proj

    return scene_fn


def profiled_us(fns, reps=5, per_call=False):
    """Mean device us a launch of each of ``fns`` (a name: a call that
    launches one kernel), over ``reps`` calls in a torch.profiler session of
    its own: {name: (us, "profiler")}; ``per_call``: the device us of all
    the port's kernels a call launches, summed (a raster's plan and raster
    kernels). Where the profiler records no device event (it sometimes
    records none in a process that profiled before), CUDA events around
    each call time it instead: (us, "events")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    out = {}
    for name, fn in fns.items():
        fn()  # warm
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and "(anonymous namespace)::" in e.name]
        if us:
            out[name] = (sum(us) / (reps if per_call else len(us)), "profiler")
            continue
        total = 0.0
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end) * 1e3
        out[name] = (total / reps, "events")
    return out


def hold_sweep_pass(sw, rec, rays=None):
    """B4's tables, B5 and B6 (closest or any hit, as the recorded pass
    ``rec`` asks; ``rays``: only so many of its rays, from the ray block at
    its middle on) at the sweep
    module's present ray block and sub-block, held to their twins bit for
    bit, also on tied clusters (``tied_clusters``), and timed by the
    profiler's mean a launch (``profiled_us``) beside ``_sweep_bound``.
    Returns a dict: ok (each check), ms and timed_by, w5 and w6 (the twins'
    work), b5 and b6 ((bound ms, bound by)), hits (B5's twin)."""
    from sailor_tpu_torch.raytracing import sweep

    n = rec["origin"].shape[0]
    first = 0 if rays is None else n // 2 // sweep.RAY_BLOCK * sweep.RAY_BLOCK
    cut = slice(first, None if rays is None else first + rays)
    p = sweep.prepare(sw, rec["origin"][cut], rec["direction"][cut], active=rec["active"][cut])
    any_hit = rec["any_hit"]
    args4 = (p["feats"][:, 8:11].contiguous(), p["feats"][:, 0:3].contiguous(), p["tmax"],
             sw.cl_min, sw.cl_max)
    b4_ok = tables_equal(sweep.visit_tables_cuda(*args4), sweep.visit_tables_plain(*args4))
    a5 = (p["e_bits"], p["order"], p["blk_bits"], p["nlive"], p["feats"], p["tmax"])
    a6 = (p["e_bits"], p["order"], p["feats"], p["tmax"])
    w5, w6 = {}, {}
    tp, ip = sweep.sweep_plain(*a5, sw.g_cluster, any_hit=any_hit, work=w5)
    tg, ig = sweep.sweep_grid_plain(*a6, sw.g_cluster, any_hit=any_hit, work=w6)
    t5, i5 = sweep.sweep_cuda(*a5, sw.g_cluster, any_hit=any_hit)
    t6, i6 = sweep.sweep_grid_cuda(*a6, sw.g_cluster, any_hit=any_hit)
    tied = tied_clusters(sw.g_cluster)
    tq, iq = sweep.sweep_plain(*a5, tied, any_hit=any_hit)
    ok = {"b4": b4_ok,
          "b5": _bits_equal(t5, i5, tp, ip), "b6": _bits_equal(t6, i6, tg, ig),
          "tied": (_bits_equal(*sweep.sweep_cuda(*a5, tied, any_hit=any_hit), tq, iq)
                   and _bits_equal(*sweep.sweep_grid_cuda(*a6, tied, any_hit=any_hit), tq, iq))}
    us = profiled_us({
        "slab_entry": lambda: sweep.visit_tables_cuda(*args4),
        "sweep": lambda: sweep.sweep_cuda(*a5, sw.g_cluster, any_hit=any_hit),
        "sweep_grid": lambda: sweep.sweep_grid_cuda(*a6, sw.g_cluster, any_hit=any_hit)})
    return {"ok": ok, "ms": {k: v / 1e3 for k, (v, _) in us.items()},
            "timed_by": "+".join(sorted({by for _, by in us.values()})), "w5": w5, "w6": w6,
            "b5": _sweep_bound(p, w5, sw.cluster), "b6": _sweep_bound(p, w6, sw.cluster),
            "hits": int((ip >= 0).sum())}


def rows_of_pass(rows, key, name, h, n_clusters, run):
    """The kernel line's rows of one ``hold_sweep_pass`` result ``h``:
    rows[kernel][key][name], with the render's launches ``run``."""
    for k, (bound, by) in (("slab_entry", (None, None)), ("sweep", h["b5"]),
                           ("sweep_grid", h["b6"])):
        row = {"ms": h["ms"][k], "n_clusters": n_clusters}
        if bound is not None:
            row.update(bound_ms=bound, bound_by=by)
        if k != "sweep_grid":
            row["launches"] = run[k]
        rows[k].setdefault(key, {})[name] = row


def run_sweep_clusters(card):
    """sweep-clusters: the tracer-512 scene's sweep built at each of
    SWEEP_CLUSTERS with ``sweep.build(cluster=)``. At each size one
    ``render_cached`` sample at TRACER's size and 2 bounces records the
    passes (the main path at that size: its B4 and B5 launches where the
    routing rule sends the passes to the sweep, else the BVH8's), and on the
    bounce-1 and bounce-1 shadow passes B4's tables, B5 and B6 (closest or
    any hit, as the pass asks) are held to their twins bit for bit, also on
    tied clusters (``tied_clusters``), and timed by the profiler's mean a
    launch (``profiled_us``) beside ``_sweep_bound``. B4 also on one ray block over the
    18,434 clusters of cluster size 1 (its global-scratch tables; the
    routing rule admits it: 36 B x 18,434 <= 1 MiB), then
    ``SAILOR_SWEEP_CLUSTER=512 python -m sailor_tpu_torch.tools.time_sweep``
    in a subprocess, a 64x64 render at cluster 37 and the dense scene's
    ``tracer="sweep"`` render (1,153 clusters through B4, 1 spp) against
    the CPU path. Returns ({kernel: {cluster: row}}, the renders' launch
    counts)."""
    import collections
    import dataclasses
    import math

    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.raytracing import sweep
    from sailor_tpu_torch.scenes import tracer_scene, tracer_soup

    scene, cam, view, proj = tracer_scene()
    dev = scene.tri_pack.device
    soup = tracer_soup()
    tris = tuple(soup["position"][soup["indices"][:, k]] for k in range(3))
    width, height = TRACER[:2]
    rows = {"slab_entry": {}, "sweep": {}, "sweep_grid": {}}
    launches = collections.Counter()
    bounce1 = None
    for cluster in SWEEP_CLUSTERS:
        sw = (scene.sweep if cluster == scene.sweep.cluster
              else sweep.build(*tris, cluster=cluster, device=dev))
        check(sw.cluster == cluster, f"the sweep was built at {sw.cluster}, not {cluster}")
        cuda_lib.LAUNCHES.clear()
        log = record_passes(dataclasses.replace(scene, sweep=sw), cam, view, proj, width, height)
        run = {k: cuda_lib.LAUNCHES.get(k, 0) for k in ("slab_entry", "sweep", "bvh8_intersect")}
        # the reference's routing rule: a pass of this many rays takes the
        # sweep only while its entry table fits SMEM_BUDGET (at 512x512 not
        # at cluster 64: 289 clusters x 128 ray blocks x 36 B > 1 MiB)
        routed = sweep.scalar_bytes(sw, log[0]["origin"].shape[0]) <= sweep.SMEM_BUDGET
        check(run["slab_entry"] > 0 and run["sweep"] > 0 if routed
              else run["bvh8_intersect"] > 0 and run["sweep"] == 0,
              f"the render at cluster {cluster} took another route than the rule's: {run}")
        launches.update({k: run[k] for k in ("slab_entry", "sweep")})
        bounce1 = bounce1 or log[2]
        for name, rec in (("bounce1", log[2]), ("bounce1_shadow", log[3])):
            h = hold_sweep_pass(sw, rec)
            ok, ms, w5 = h["ok"], h["ms"], h["w5"]
            (b5, by5), (b6, by6) = h["b5"], h["b6"]
            lane_use = w5["tests"] / max(1, w5["pairs"] * sweep.SUB * cluster)
            column_lanes = cluster / (math.ceil(cluster / 256) * 256)
            print(f"sweep-clusters[{cluster}/{name}]: {sw.n_clusters} clusters "
                  f"b4_equal={ok['b4']} b5_equal={ok['b5']} b6_equal={ok['b6']} "
                  f"tied_equal={ok['tied']} b4_ms={ms['slab_entry']:.4f} "
                  f"b5_ms={ms['sweep']:.4f} bound_ms={b5:.5f} ({by5}) "
                  f"b6_ms={ms['sweep_grid']:.4f} bound_ms={b6:.5f} ({by6}) "
                  f"pairs={w5['pairs']} tests={w5['tests']} lane_use={lane_use:.5f} "
                  f"column_lanes={column_lanes:.4f} hits={h['hits']} "
                  f"render_route={'sweep' if routed else 'bvh8'} render_launches={run} "
                  f"timed_by={h['timed_by']} on {card}")
            check(all(ok.values()), f"a sweep kernel disagrees with its twin at cluster "
                                    f"{cluster} ({name}): {ok}")
            check(w5 == h["w6"], f"B6's twin walked other work than B5's at cluster {cluster}")
            rows_of_pass(rows, str(cluster), name, h, sw.n_clusters, run)
    # B4 over the most clusters the tracer soup gives: cluster size 1, one
    # ray block (global-scratch tables)
    sw1 = sweep.build(*tris, cluster=1, device=dev)
    r = sweep.RAY_BLOCK
    check(sweep.scalar_bytes(sw1, r) <= sweep.SMEM_BUDGET and sw1.n_clusters > 3 * 1024,
          "cluster size 1 no longer gives a pass the sweep takes past B4's shared tables")
    o, d, tmax = sweep._pad_rays(bounce1["origin"][:r], bounce1["direction"][:r], None,
                                 bounce1["active"][:r])
    args4 = (o, d, tmax, sw1.cl_min, sw1.cl_max)
    b4_ok = tables_equal(sweep.visit_tables_cuda(*args4), sweep.visit_tables_plain(*args4))
    ms = _time_ms(lambda: sweep.visit_tables_cuda(*args4), 10)
    print(f"sweep-clusters[1/bounce1, one ray block]: {sw1.n_clusters} clusters "
          f"scalar_bytes={sweep.scalar_bytes(sw1, r)} b4_equal={b4_ok} b4_ms={ms:.4f} "
          f"(CUDA events over 10 launches) on {card}")
    check(b4_ok, "slab entry kernel disagrees with its twin past its shared tables")
    rows["slab_entry"]["1"] = {"bounce1_one_block": {"ms": ms, "n_clusters": sw1.n_clusters}}
    # the tool, as its docstring gives it
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sailor_tpu_torch.tools.time_sweep"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=300, env={**os.environ, "SAILOR_SWEEP_CLUSTER": "512"})
    print(f"SAILOR_SWEEP_CLUSTER=512 python -m sailor_tpu_torch.tools.time_sweep "
          f"({time.perf_counter() - t0:.1f} s, {card}):")
    for line in (proc.stderr.strip().splitlines()[-1:] + proc.stdout.strip().splitlines()):
        print("  " + line)
    check(proc.returncode == 0 and "cluster=512" in proc.stdout,
          f"time_sweep at SAILOR_SWEEP_CLUSTER=512 failed: {proc.stderr[-2000:]}")
    cuda_lib.LAUNCHES.clear()
    check_small_trace(cluster_scene(SMALL_CLUSTER), f"tracer_cluster_{SMALL_CLUSTER}")
    check_small_trace(cluster_scene(sweep.CLUSTER, rings=96, sectors=192), "tracer_dense_sweep",
                      spp=1)
    small = {k: cuda_lib.LAUNCHES.get(k, 0) for k in ("slab_entry", "sweep")}
    check(all(small.values()), f"the small renders skipped a kernel: {small}")
    launches.update(small)
    return rows, dict(launches)


# sweep-rayblocks' (RAY_BLOCK, SUB) pairs, each through a tracer-512 sample;
# SMALL_RAY_BLOCKS on two ray blocks at the middle of each pass only
SWEEP_RAY_BLOCKS = ((1024, 128), (1536, 192), (2048, 512), (2048, 2048), (4096, 256),
                    (8192, 1024), (8192, 8192), (2048, 64))
SMALL_RAY_BLOCKS = ((512, 16), (96, 1))
SMALL_RAY_BLOCK_TRACE = (1536, 192)  # sweep-rayblocks' 64x64 card-vs-CPU render


@contextlib.contextmanager
def ray_block(rb, sub):
    """The sweep's ray block and sub-block sizes (``sweep.RAY_BLOCK``,
    ``sweep.SUB``) set to (rb, sub) for the length of the block."""
    from sailor_tpu_torch.raytracing import sweep

    old = sweep.RAY_BLOCK, sweep.SUB
    sweep.RAY_BLOCK, sweep.SUB = rb, sub
    try:
        yield
    finally:
        sweep.RAY_BLOCK, sweep.SUB = old


@contextlib.contextmanager
def tile_height(th):
    """The raster tile height (``tile_raster.TILE_H``) set to th for the
    length of the block (None: as it is)."""
    from sailor_tpu_torch.raster import tile_raster

    old = tile_raster.TILE_H
    tile_raster.TILE_H = old if th is None else th
    try:
        yield
    finally:
        tile_raster.TILE_H = old


def run_sweep_rayblocks(card):
    """sweep-rayblocks: the tracer-512 scene (73 clusters of 256) at each
    (RAY_BLOCK, SUB) pair of SWEEP_RAY_BLOCKS and SMALL_RAY_BLOCKS, set on
    the sweep module. At each pair one ``render_cached`` sample at TRACER's
    size and 2 bounces records the passes (the main path at that pair: B4
    and B5 where the routing rule sends the passes to the sweep, else the
    BVH8), and on the bounce-1 and bounce-1 shadow passes (two ray blocks
    at the middle of each at SMALL_RAY_BLOCKS: the first ones hold sky
    rays, which hit nothing) B4's tables, B5 and B6 are held
    to their twins bit for bit, also on tied clusters, and timed by the
    profiler beside their bounds (``hold_sweep_pass``). At (8192, 1024) a
    4-sample pool (tracer-512-batch4's passes, which the default pair sends
    to the BVH8) records its passes too, and must take the sweep. Then
    ``SAILOR_SWEEP_RAY_BLOCK=4096 SAILOR_SWEEP_SUB=512 python -m
    sailor_tpu_torch.tools.time_sweep`` in a subprocess and a 64x64 render
    (1 spp) at SMALL_RAY_BLOCK_TRACE against the CPU path. Returns ({kernel:
    {"RAY_BLOCK/SUB": row}}, the renders' launch counts)."""
    import collections

    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.raytracing import sweep
    from sailor_tpu_torch.scenes import tracer_scene

    scene, cam, view, proj = tracer_scene()
    sw = scene.sweep
    width, height = TRACER[:2]
    rows = {"slab_entry": {}, "sweep": {}, "sweep_grid": {}}
    launches = collections.Counter()
    for rb, sub in SWEEP_RAY_BLOCKS + SMALL_RAY_BLOCKS:
        key, small = f"{rb}/{sub}", (rb, sub) in SMALL_RAY_BLOCKS
        t_pair = time.perf_counter()
        with ray_block(rb, sub):
            batches = (1, 4) if (rb, sub) == (8192, 1024) else (1,)
            for batch in batches:
                cuda_lib.LAUNCHES.clear()
                log = record_passes(scene, cam, view, proj, width, height, sample_batch=batch)
                run = {k: cuda_lib.LAUNCHES.get(k, 0)
                       for k in ("slab_entry", "sweep", "bvh8_intersect")}
                routed = (sweep.scalar_bytes(sw, log[0]["origin"].shape[0])
                          <= sweep.SMEM_BUDGET)
                check(run["slab_entry"] > 0 and run["sweep"] > 0 and not run["bvh8_intersect"]
                      if routed else run["bvh8_intersect"] > 0 and run["sweep"] == 0,
                      f"the render at {key} (sample_batch {batch}) took another route than "
                      f"the rule's: {run}")
                check(batch == 1 or routed, f"tracer-512-batch4's passes left the sweep at {key}")
                launches.update({k: run[k] for k in ("slab_entry", "sweep")})
                print(f"sweep-rayblocks[{key}] sample_batch={batch}: rays a pass="
                      f"{log[0]['origin'].shape[0]} scalar_bytes="
                      f"{sweep.scalar_bytes(sw, log[0]['origin'].shape[0])} "
                      f"route={'sweep' if routed else 'bvh8'} launches={run}")
            rays = 2 * rb if small else None
            for name, rec in (("bounce1", log[2]), ("bounce1_shadow", log[3])):
                h = hold_sweep_pass(sw, rec, rays)
                ok, ms, w5 = h["ok"], h["ms"], h["w5"]
                (b5, by5), (b6, by6) = h["b5"], h["b6"]
                print(f"sweep-rayblocks[{key}/{name}]: {sw.n_clusters} clusters "
                      f"rays={rays or rec['origin'].shape[0]} "
                      f"b4_equal={ok['b4']} b5_equal={ok['b5']} b6_equal={ok['b6']} "
                      f"tied_equal={ok['tied']} b4_ms={ms['slab_entry']:.4f} "
                      f"b5_ms={ms['sweep']:.4f} bound_ms={b5:.5f} ({by5}) "
                      f"b6_ms={ms['sweep_grid']:.4f} bound_ms={b6:.5f} ({by6}) "
                      f"pairs={w5['pairs']} tests={w5['tests']} "
                      f"lane_use={w5['tests'] / max(1, w5['pairs'] * sub * sw.cluster):.5f} "
                      f"hits={h['hits']} timed_by={h['timed_by']} on {card}")
                check(all(ok.values()), f"a sweep kernel disagrees with its twin at {key} "
                                        f"({name}): {ok}")
                check(w5 == h["w6"], f"B6's twin walked other work than B5's at {key}")
                rows_of_pass(rows, key, name, h, sw.n_clusters, run)
        print(f"sweep-rayblocks[{key}]: {time.perf_counter() - t_pair:.1f} s")
    t0 = time.perf_counter()
    env = {**os.environ, "SAILOR_SWEEP_RAY_BLOCK": "4096", "SAILOR_SWEEP_SUB": "512"}
    proc = subprocess.run([sys.executable, "-m", "sailor_tpu_torch.tools.time_sweep"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=300, env=env)
    print(f"SAILOR_SWEEP_RAY_BLOCK=4096 SAILOR_SWEEP_SUB=512 python -m "
          f"sailor_tpu_torch.tools.time_sweep ({time.perf_counter() - t0:.1f} s, {card}):")
    for line in (proc.stderr.strip().splitlines()[-1:] + proc.stdout.strip().splitlines()):
        print("  " + line)
    check(proc.returncode == 0 and "ray_block=4096 sub=512" in proc.stdout,
          f"time_sweep at SAILOR_SWEEP_RAY_BLOCK=4096 SAILOR_SWEEP_SUB=512 failed: "
          f"{proc.stderr[-2000:]}")
    cuda_lib.LAUNCHES.clear()
    with ray_block(*SMALL_RAY_BLOCK_TRACE):  # 1 spp: the CPU render is most of its time
        check_small_trace(label="tracer_ray_block_{}_{}".format(*SMALL_RAY_BLOCK_TRACE),
                          spp=1)
    small = {k: cuda_lib.LAUNCHES.get(k, 0) for k in ("slab_entry", "sweep")}
    check(all(small.values()), f"the small render skipped a kernel: {small}")
    launches.update(small)
    return rows, dict(launches)


def textured_sky_balls(device):
    """The material balls with the default sky and the procedural maps."""
    from sailor_tpu_torch.kernels.sky import SkyParams
    from sailor_tpu_torch.scenes import material_balls

    return material_balls(device, sky=SkyParams.default(), textured=True)


ENGINE_EDITOR_SIZE = (1920, 1088)  # the CLI's frame in the engine phase
PATH_KERNELS = ("raster_worklist", "resolve_worklist", "shade_forward_plus")


@contextlib.contextmanager
def timed_methods(obj, names, measure=lambda: 0):
    """Wraps the methods ``names`` of ``obj`` (on the instance): yields a
    dict of name -> [host ms, growth of ``measure()``], each summed over
    the method's calls since."""
    acc = {n: [0.0, 0] for n in names}

    def wrap(name, inner):
        def call(*args, **kw):
            t0, m0 = time.perf_counter(), measure()
            try:
                return inner(*args, **kw)
            finally:
                acc[name][0] += (time.perf_counter() - t0) * 1e3
                acc[name][1] += measure() - m0
        return call

    for n in names:
        setattr(obj, n, wrap(n, getattr(obj, n)))
    try:
        yield acc
    finally:
        for n in names:
            delattr(obj, n)


@contextlib.contextmanager
def content_copy():
    """A temporary working directory holding a copy of the repository's
    content/ (the asset registry writes `.asset` sidecars into the content
    it scans); the previous working directory is restored after."""
    import shutil
    import tempfile

    here, cwd = os.path.dirname(os.path.abspath(__file__)), os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(here, "content"), os.path.join(tmp, "content"))
        os.chdir(tmp)
        try:
            yield tmp
        finally:
            os.chdir(cwd)


def run_engine_editor(card):
    """engine-editor-world: ``python -m sailor_tpu_torch`` in process over a
    temporary copy of content/Editor.world at 1920x1088, 8 frames, with
    the console's stats.memory and profile, on the card: the CLI's lines
    as it prints them, each frame's ms to a synchronise and synchronising
    calls (``EngineLoop.process_cpu_frame`` wrapped for the run), the peak
    memory, the PNG checked (1088x1920x3, nonzero spread), B1 and B2
    launched, B3 not (the CLI's config shades plainly, as the
    reference's); then one profiled frame of the CLI's loop. Returns the
    launches."""
    import numpy as np
    import torch

    from sailor_tpu_torch.__main__ import main as engine_main
    from sailor_tpu_torch.engine.app import EngineLoop
    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.utils.png import decode_png

    width, height = ENGINE_EDITOR_SIZE
    frames, loops = [], []
    inner = EngineLoop.process_cpu_frame

    def frame(self, dt):
        """One CLI frame, timed to a synchronise, its syncs counted."""
        loops[:] = [self]
        with sync_counter() as syncs:
            t0 = time.perf_counter()
            out = inner(self, dt)
            n = syncs()
        torch.cuda.synchronize()
        frames.append({"frame_ms": round((time.perf_counter() - t0) * 1e3, 3), "syncs": n})
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    EngineLoop.process_cpu_frame = frame
    try:
        with content_copy() as tmp:
            out = os.path.join(tmp, "editor.png")
            cuda_lib.LAUNCHES.clear()
            t0 = time.perf_counter()
            rc = engine_main(["--world", os.path.join(tmp, "content", "Editor.world"),
                              "--width", str(width), "--height", str(height), "--frames", "8",
                              "--out", out, "--command", "stats.memory", "--command", "profile"])
            wall = time.perf_counter() - t0
            launches = dict(cuda_lib.LAUNCHES)
            with open(out, "rb") as f:
                img = decode_png(f.read())
    finally:
        EngineLoop.process_cpu_frame = inner
    peak = torch.cuda.max_memory_allocated()
    spread = float(np.asarray(img, np.float32).std())
    print(f"engine-editor-world: rc={rc} wall_s={wall:.3f} png={img.shape} spread={spread:.3f} "
          f"peak_mem_bytes={peak} launches {json.dumps(launches)} on {card}")
    for i, f in enumerate(frames):
        print("engine-editor-world frame " + json.dumps(dict(frame=i + 1, **f)))
    profile(lambda: inner(loops[0], 1 / 60), card, "profile_engine_editor")
    loops[0].renderer.wait_idle()
    check(rc == 0 and img.shape == (height, width, 3) and spread > 0,
          "engine-editor-world: the CLI wrote no frame")
    check(launches.get("raster_worklist", 0) > 0 and launches.get("resolve_worklist", 0) > 0,
          f"engine-editor-world: B1/B2 launches {launches}")
    check(launches.get("shade_forward_plus", 0) == 0,
          "engine-editor-world: B3 ran though the CLI's config shades plainly")
    return launches


def _engine_loop(doc, width, height, config, device):
    """An EngineLoop over the document with the CLI's sky."""
    from sailor_tpu_torch.__main__ import SUN_DIRECTION
    from sailor_tpu_torch.engine import World
    from sailor_tpu_torch.engine.app import EngineLoop, Renderer
    from sailor_tpu_torch.kernels.sky import SkyParams

    world = World.deserialize(doc, device=device)
    renderer = Renderer(RENDERER, width, height, dict(config), device=device)
    return EngineLoop(world, renderer, sky=SkyParams.default(sun_direction=SUN_DIRECTION))


def run_engine_flagship(card):
    """engine-flagship-world: EngineLoop over
    ``World.deserialize(flagship_world_doc(1000, 96))`` (1,099 game
    objects, 1,001 lights, the camera orbiting) with
    ``Renderer(RENDERER, 1920, 1088, FULL_CONFIG)`` on the card, 1 warm-up
    + 5 frames: per frame the host ms of world.tick, world.scene_view and
    push_frame, the frame ms to a synchronise, the synchronising calls and
    B1/B2/B3 launches (each > 0); the peak memory; the per-node ms of one
    more frame (``process_debug``: its cascades dirty, as every frame's);
    one profiled frame, last. Returns the launches of frames 1-6."""
    import torch

    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.scenes import flagship_world_doc

    width, height, n_lights, n_objects = FLAGSHIP
    t0 = time.perf_counter()
    loop = _engine_loop(flagship_world_doc(n_lights, n_objects, aspect=width / height),
                        width, height, FULL_CONFIG, "cuda")
    load_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, total = [], {}
    for i in range(6):
        cuda_lib.LAUNCHES.clear()
        with sync_counter() as syncs, \
                timed_methods(loop.world, ("tick", "scene_view"), syncs) as host, \
                timed_methods(loop.renderer, ("push_frame",), syncs) as push:
            t1 = time.perf_counter()
            targets = loop.process_cpu_frame(1 / 60)
            n_syncs = syncs()
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t1) * 1e3
        launches = {k: cuda_lib.LAUNCHES.get(k, 0) for k in PATH_KERNELS}
        for k, v in cuda_lib.LAUNCHES.items():
            total[k] = total.get(k, 0) + v
        host.update(push)
        rows.append({"frame": i + 1, **{f"{k}_ms": round(v[0], 3) for k, v in host.items()},
                     "frame_ms": round(frame_ms, 3), "syncs": n_syncs,
                     "syncs_by_step": {k: v[1] for k, v in host.items()}, "launches": launches})
        for k in PATH_KERNELS:
            check(launches[k] > 0, f"engine-flagship-world frame {i + 1} launched no {k}")
    peak = torch.cuda.max_memory_allocated()
    final = targets["Final"]
    cov = (targets["TriId"] >= 0).float().mean().item()
    check(tuple(final.shape) == (height, width, 3) and bool(torch.isfinite(final).all())
          and cov > 0.0, "engine-flagship-world: bad frame")
    world = loop.world
    print(f"engine-flagship-world {width}x{height}: load_ms={load_ms:.3f} "
          f"objects={len(world.game_objects)} lights={world.lighting.snapshot.num} "
          f"triangles={world.meshes.geometry.indices.shape[0]} peak_mem_bytes={peak} "
          f"coverage={cov:.4f} on {card}")
    for r in rows:
        print("engine-flagship-world frame " + json.dumps(r))
    world.tick(1 / 60)  # one more frame node by node: the camera moved, the cascades are dirty
    scene = world.scene_view(sky=loop.sky, prev_frame=loop._prev_frame)
    fg, state = loop.renderer.frame_graph, loop.renderer.state
    fg.prepare(scene, state)
    per_node = fg.process_debug(scene, state)[2]
    print("engine-flagship-world per_node_ms " + json.dumps(
        {k: round(v, 3) for k, v in per_node.items()}))
    profile(lambda: loop.process_cpu_frame(1 / 60), card, "profile_engine_flagship")
    loop.renderer.wait_idle()
    return total


def check_small_engine():
    """flagship_world_doc(24, 6) through EngineLoop at 256x128 (FULL_CONFIG,
    shadow_resolution 128), 2 frames, on the card against the CPU path,
    held as check_small_full_frame holds its frame (full_frame_agreement)."""
    from sailor_tpu_torch.scenes import flagship_world_doc

    out = {}
    for dev in ("cuda", "cpu"):
        loop = _engine_loop(flagship_world_doc(24, 6, aspect=2.0), 256, 128,
                            dict(FULL_CONFIG, shadow_resolution=128), dev)
        out[dev] = []
        for _ in range(2):
            t = loop.process_cpu_frame(1 / 60)
            out[dev].append({k: t[k].cpu() for k in FULL_FRAME_KEYS})
    for i, (g, r) in enumerate(zip(out["cuda"], out["cpu"])):
        ok, line = full_frame_agreement(g, r)
        print(f"small engine frame {i + 1} card vs cpu: {line}")
        check(ok, "the card's engine frame disagrees with the CPU path")


def check_engine_lost_device(card):
    """A frame graph that raises torch.AcceleratorError once: the Renderer
    rebuilds its graph on the card and the frame retries there."""
    import torch
    import yaml

    from sailor_tpu_torch.__main__ import CLI_CONFIG

    with open(os.path.join(os.path.dirname(RENDERER), "Editor.world")) as f:
        doc = yaml.safe_load(f)
    loop = _engine_loop(doc, 256, 128, CLI_CONFIG, "cuda")
    r = loop.renderer
    calls = {"n": 0}

    class LostGraph:
        def prepare(self, scene, state):
            pass

        def process(self, scene, state):
            calls["n"] += 1
            raise torch.AcceleratorError("CUDA error: device lost (injected)")

    r.frame_graph = LostGraph()
    targets = loop.process_cpu_frame(1 / 60)
    torch.cuda.synchronize()
    final = targets["Final"]
    print(f"engine lost device: raised={calls['n']} device_losses={r.stats.get('device_losses')} "
          f"retried_on={final.device} graph_on={r.frame_graph.device} on {card}")
    check(calls["n"] == 1 and r.stats.get("device_losses") == 1 and final.device.type == "cuda"
          and r.frame_graph.device.type == "cuda" and bool(torch.isfinite(final).all()),
          "the lost-device retry did not render on the card")


# the engine at night with the HUD and debug draw (engine-night-hud)
NIGHT_SUN = (-0.35, 0.7, -0.3)  # y > 0: the sun is below the horizon, night factor 1
NIGHT_STARS = 4096  # the reference's catalogue cap (stars.load(max_stars=4096))
HUD_SIZE = (384, 192)
NIGHT_CONFIG = dict(FULL_CONFIG, tonemap="uncharted2")
STAR_REL = 2e-3  # a frame's star term against another's: 1 ulp of cos near 1 is 5e-4
HUD_STATS = {"last_frame_ms": 16.6, "gpu_frames": 7, "triangles": 2074,
             "node_ms": {"Sky": 3.25, "RenderScene": 5.5, "Bloom": 1.0}}


def _night_loop(doc, width, height, config, device):
    """An EngineLoop at night over the document: the CLI's sky with the sun
    at NIGHT_SUN, ``stars.procedural(NIGHT_STARS)``, the stats HUD on an
    OverlayContext of HUD_SIZE and debug lines (a box on each solid mesh
    object, an origin) in the renderer's config."""
    from sailor_tpu_torch.assets import stars
    from sailor_tpu_torch.engine import World
    from sailor_tpu_torch.engine.app import EngineLoop, Renderer
    from sailor_tpu_torch.engine.overlay import OverlayContext
    from sailor_tpu_torch.kernels.sky import SkyParams
    from sailor_tpu_torch.rhi.debug_context import DebugContext
    from sailor_tpu_torch.scenes import mesh_boxes

    dbg = DebugContext()
    for lo, hi in mesh_boxes(doc):
        dbg.draw_aabb(lo, hi)
    dbg.draw_origin((0.0, 0.05, 0.0), 2.0)
    world = World.deserialize(doc, device=device)
    renderer = Renderer(RENDERER, width, height, dict(config, debug_context=dbg), device=device)
    return EngineLoop(world, renderer, sky=SkyParams.default(sun_direction=NIGHT_SUN),
                      stars=stars.procedural(NIGHT_STARS, seed=0),
                      overlay=OverlayContext(*HUD_SIZE)), dbg


@contextlib.contextmanager
def twin_checked(record):
    """While open, every launch of B1-B3 through their wrappers is also run
    through its plain twin on the same inputs and held to it (B1 bit-equal,
    B2 B2's bar, B3 within 1e-5 relative to max(|twin|, 1e-3)); record[name]
    collects each launch's largest absolute difference. The twins count no
    launch."""
    import torch

    from sailor_tpu_torch.kernels import pbr_kernel
    from sailor_tpu_torch.raster import tile_raster as tr

    def b1(k, p):
        same = all(bool(torch.equal(a, b)) for a, b in zip(k, p))
        return same, (k[0] - p[0]).abs().max().item()

    def b2(k, p):
        k, p = torch.stack(k), torch.stack(p)
        diff = (k - p).abs()
        ok = ((diff > 1e-5).float().mean().item() <= 1e-5
              and bool((diff <= 1e-4 * (1 + p.abs())).all()))
        return ok, diff.max().item()

    def b3(k, p):
        rel = ((k - p).abs() / p.abs().clamp(min=1e-3)).max().item()
        return rel <= 1e-5, (k - p).abs().max().item()

    wrapped = ((tr, "rasterize_worklist_cuda", tr.rasterize_worklist_plain, "raster_worklist", b1),
               (tr, "resolve_worklist_cuda", tr.resolve_worklist_plain, "resolve_worklist", b2),
               (pbr_kernel, "shade_tiles_cuda", pbr_kernel.shade_tiles_plain,
                "shade_forward_plus", b3))
    saved = []
    for mod, attr, plain, name, agree in wrapped:
        inner = getattr(mod, attr)

        def call(*a, _inner=inner, _plain=plain, _name=name, _agree=agree, **kw):
            out = _inner(*a, **kw)
            ok, err = _agree(out, _plain(*a, **kw))
            check(ok, f"{_name} disagrees with its plain version")
            record.setdefault(_name, []).append(err)
            return out

        saved.append((mod, attr, inner))
        setattr(mod, attr, call)
    try:
        yield record
    finally:
        for mod, attr, inner in saved:
            setattr(mod, attr, inner)


@contextlib.contextmanager
def captured_node(name, keys, out):
    """Wraps the frame-graph node type ``name``: appends to ``out`` a dict of
    the targets' and the state's ``keys`` (on the CPU) before and after
    each call."""
    from sailor_tpu_torch.framegraph.graph import node_types

    cls = node_types()[name]
    inner = cls.process

    def grab(ctx, targets):
        src = {**(ctx.state or {}), **targets}
        return {k: src[k].cpu() for k in keys if k in src}

    def process(self, ctx, targets):
        before = grab(ctx, targets)
        t = inner(self, ctx, targets)
        out.append((before, grab(ctx, t)))
        return t

    cls.process = process
    try:
        yield out
    finally:
        cls.process = inner


def sky_with_and_without_stars(fg, scene):
    """The Sky node rendered afresh (no cache) on ``scene`` with its stars
    and without: (ms with, ms without, lit Sky, unlit Sky), each ms the
    least of 3 runs to a synchronise."""
    import dataclasses

    from sailor_tpu_torch.framegraph.nodes import SkyNode

    node = SkyNode({})
    dark = dataclasses.replace(scene, star_dirs=None, star_colors=None)
    out = []
    for s in (scene, dark):
        runs = [_wall_ms(lambda: node.process(fg._ctx(s, {}), {})["Sky"]) for _ in range(3)]
        out.append((min(r[0] for r in runs), runs[-1][1]))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def star_term_cost(scene, width, height, config, card):
    """Prints the star term alone at the Sky node's resolution on a
    sky-dirty frame: ms (the least of 3 runs to a synchronise), the memory
    it adds over what was allocated, and its bound (the rays, the catalogue
    and the colours read once, the term written; two products and an exp a
    (direction, star) pair)."""
    import torch

    from sailor_tpu_torch.core import math3d as m3
    from sailor_tpu_torch.kernels import sky as sky_k
    from sailor_tpu_torch.raster import interpolate

    q = int(config.get("sky_downsample", 2))
    inv_vp = m3.inverse(scene.frame.view_projection)
    d = interpolate.pixel_rays_strided(inv_vp, scene.frame.camera_position, height, width, q,
                                       fused=False)
    p_ = scene.sky.on(d.device)
    _, trans = sky_k.atmosphere(d, p_["sun_direction"], p_["sun_intensity"])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runs = [_wall_ms(lambda: sky_k.stars(d, scene.star_dirs, scene.star_colors, trans))
            for _ in range(3)]
    extra = torch.cuda.max_memory_allocated() - base
    n_dirs, n_stars = d.numel() // 3, scene.star_dirs.shape[0]
    bound, by = _bound(d.numel() * 4 * 3 + n_stars * 24, n_dirs * n_stars * (6 + 6 + 4))
    ms = min(r[0] for r in runs)
    print(f"engine-night-hud star_term: directions={n_dirs} stars={n_stars} "
          f"chunk={sky_k.STAR_CHUNK} ms={ms:.3f} bound_ms={bound:.4f} ({by}) "
          f"added_peak_bytes={extra} lit={int((runs[-1][1].abs().amax(-1) > 1e-6).sum())} "
          f"on {card}")


def run_engine_night(card):
    """engine-night-hud: EngineLoop over ``flagship_world_doc(1000, 96)`` at
    1920x1088 at night (NIGHT_CONFIG: FULL_CONFIG with the uncharted2
    tonemap; the sun at NIGHT_SUN; ``stars.procedural(4096)``; the stats
    HUD built every frame; 1,152 debug lines on the 96 objects and an
    origin), 1 warm-up + 5 frames: host ms of world.tick, scene_view,
    push_frame and the HUD (the rest of the frame's host time: stats_hud,
    the canvas and its copy to the card), frame ms to a synchronise,
    synchronising calls by step, B1-B3 launches checked per frame; peak
    memory; per-node ms of a moving frame and of a sky-dirty frame (the
    camera turned 2e-3 rad, so the star term runs over all 522,240 sky
    directions); the Sky node with and without the stars and the star term
    alone (ms, added memory, bound); then two moving frames and a sky-dirty
    frame with every B1-B3 launch held to its twin; a profiled frame, last.
    Returns the launches of frames 1-6."""
    import torch

    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.scenes import flagship_world_doc

    width, height, n_lights, n_objects = FLAGSHIP
    t0 = time.perf_counter()
    loop, dbg = _night_loop(flagship_world_doc(n_lights, n_objects, aspect=width / height),
                            width, height, NIGHT_CONFIG, "cuda")
    load_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, total = [], {}
    for i in range(6):
        cuda_lib.LAUNCHES.clear()
        with sync_counter() as syncs, \
                timed_methods(loop.world, ("tick", "scene_view"), syncs) as host, \
                timed_methods(loop.renderer, ("push_frame",), syncs) as push:
            t1 = time.perf_counter()
            targets = loop.process_cpu_frame(1 / 60)
            host_ms = (time.perf_counter() - t1) * 1e3
            n_syncs = syncs()
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t1) * 1e3
        launches = {k: cuda_lib.LAUNCHES.get(k, 0) for k in PATH_KERNELS}
        for k, v in cuda_lib.LAUNCHES.items():
            total[k] = total.get(k, 0) + v
        host.update(push)
        steps = {k: v[1] for k, v in host.items()}
        steps["hud"] = n_syncs - sum(steps.values())
        rows.append({"frame": i + 1, **{f"{k}_ms": round(v[0], 3) for k, v in host.items()},
                     "hud_ms": round(host_ms - sum(v[0] for v in host.values()), 3),
                     "frame_ms": round(frame_ms, 3), "syncs": n_syncs, "syncs_by_step": steps,
                     "launches": launches})
        for k in PATH_KERNELS:
            check(launches[k] > 0, f"engine-night-hud frame {i + 1} launched no {k}")
    peak = torch.cuda.max_memory_allocated()
    final = targets["Final"]
    cov = (targets["TriId"] >= 0).float().mean().item()
    check(tuple(final.shape) == (height, width, 3) and bool(torch.isfinite(final).all())
          and final.min().item() >= 0.0 and final.max().item() <= 1.0 and cov > 0.0,
          "engine-night-hud: bad frame")
    canvas = loop.renderer.state["overlay/canvas"]
    check(canvas.device.type == loop.renderer.device.type
          and tuple(canvas.shape) == (HUD_SIZE[1], HUD_SIZE[0], 4)
          and float(canvas[..., 3].max()) > 0.4, "engine-night-hud: no HUD canvas on the card")
    world = loop.world
    print(f"engine-night-hud {width}x{height}: load_ms={load_ms:.3f} "
          f"objects={len(world.game_objects)} lights={world.lighting.snapshot.num} "
          f"triangles={world.meshes.geometry.indices.shape[0]} stars={NIGHT_STARS} "
          f"debug_lines={len(dbg._lines)} hud={HUD_SIZE[0]}x{HUD_SIZE[1]} "
          f"peak_mem_bytes={peak} coverage={cov:.4f} on {card}")
    for r in rows:
        print("engine-night-hud frame " + json.dumps(r))
    mean = sum(r["frame_ms"] for r in rows[1:]) / 5
    print(f"engine-night-hud frame_ms={[r['frame_ms'] for r in rows]} mean_2_6={mean:.3f} "
          f"syncs={[r['syncs'] for r in rows]} on {card}")

    # a moving frame node by node, then a sky-dirty one (the camera turned)
    fg, state = loop.renderer.frame_graph, loop.renderer.state
    world.tick(1 / 60)
    scene = world.scene_view(sky=loop.sky, stars=loop.stars, prev_frame=loop._prev_frame)
    fg.prepare(scene, state)
    per_node = fg.process_debug(scene, state)[2]
    turned = _turned(scene, 2e-3)
    fg.prepare(turned, state)
    per_node_dirty = fg.process_debug(turned, state)[2]
    named = ("Sky", "DebugDraw", "RenderOverlay", "EyeAdaptation")
    for label, pn in (("moving", per_node), ("sky_dirty", per_node_dirty)):
        by_name = {k.split("_", 1)[1]: v for k, v in pn.items()}  # keys are "<index>_<node>"
        check(all(n in by_name for n in named), f"engine-night-hud: per-node ms lack {named}")
        print(f"engine-night-hud per_node_ms_{label} "
              + json.dumps({k: round(v, 3) for k, v in pn.items()})
              + " named " + json.dumps({n: round(by_name[n], 3) for n in named}) + f" on {card}")
    ms_lit, ms_dark, lit, dark = sky_with_and_without_stars(fg, turned)
    star_px = int(((lit - dark).abs().amax(-1) > 1e-6).sum())
    print(f"engine-night-hud sky_node_sky_dirty: with_stars_ms={ms_lit:.3f} "
          f"without_stars_ms={ms_dark:.3f} star_lit_pixels={star_px} of {lit[..., 0].numel()} "
          f"on {card}")
    check(star_px > 1000, f"engine-night-hud: the star term lit {star_px} pixels")
    star_term_cost(turned, width, height, NIGHT_CONFIG, card)

    # B1-B3 held to their twins on every launch of three more frames
    record = {}
    with twin_checked(record):
        for _ in range(2):
            loop.process_cpu_frame(1 / 60)
        back = _turned(world.scene_view(sky=loop.sky, stars=loop.stars,
                                        prev_frame=loop._prev_frame), -2e-3)
        fg.prepare(back, state)
        fg.process(back, state)
        torch.cuda.synchronize()
    print("engine-night-hud twin_checked_frames=3 launches_held "
          + json.dumps({k: len(v) for k, v in record.items()})
          + " max_abs_err " + json.dumps({k: max(v) for k, v in record.items()}) + f" on {card}")
    for k in PATH_KERNELS:
        check(len(record.get(k, ())) >= 3, f"engine-night-hud: {k} was held on too few frames")
    profile(lambda: loop.process_cpu_frame(1 / 60), card, "profile_engine_night")
    loop.renderer.wait_idle()
    return total


def night_frame_agreement(got, ref, term):
    """A night frame on the card (``got``) against the CPU path's (``ref``),
    dicts of NIGHT_KEYS on the CPU, ``term`` the CPU's star term on its
    Sky: Depth, TriId, LightIndices, ShadowMaps and HiZCulledCount exact;
    Sky within 5e-5 * (1 + |ref|) + STAR_REL * |term|; Main within 1e-4
    relative (to max(|ref|, 1e-3)) or within 1e-4 * max(|ref|, 1e-3) +
    STAR_REL * (the term's largest channel within 2 px) on >= 99.5% of
    pixels; Final within 2/255 on every pixel. Returns (ok, a line)."""
    import torch

    exact = {k: bool(torch.equal(got[k], ref[k]))
             for k in ("Depth", "TriId", "LightIndices", "ShadowMaps", "HiZCulledCount")}
    near = torch.nn.functional.max_pool2d(term.abs().amax(-1)[None, None], 5, 1, 2)[0, 0]
    sky_err = (got["Sky"] - ref["Sky"]).abs()
    sky = (sky_err - 5e-5 * (1 + ref["Sky"].abs()) - STAR_REL * term.abs()).max().item()
    err = (got["Main"] - ref["Main"]).abs()
    scale = ref["Main"].abs().clamp(min=1e-3)
    ok = ((err / scale <= 1e-4) | (err <= 1e-4 * scale + STAR_REL * near[..., None])).all(-1)
    main = ok.float().mean().item()
    final = (got["Final"] - ref["Final"]).abs().max().item()
    line = (" ".join(f"{k}_equal={v}" for k, v in exact.items())
            + f" sky_rel_err={(sky_err / (1 + ref['Sky'].abs())).max().item():.3g} "
            f"sky_over_bar={sky:.3g} main_within_bar={main:.5f} final_max_err={final:.3g}")
    return all(exact.values()) and sky <= 0 and main >= 0.995 and final <= 2 / 255, line


NIGHT_KEYS = ("Depth", "TriId", "LightIndices", "ShadowMaps", "HiZCulledCount", "Sky",
              "Main", "Final")


def check_small_night():
    """flagship_world_doc(24, 6) through the night loop at 256x128
    (NIGHT_CONFIG, shadow_resolution 128), 2 frames, on the card against
    the CPU path, the HUD drawn from one fixed stats dict on both:
    night_frame_agreement's bars; the pixels DebugDraw writes and their
    colours exact; the canvas equal, and RenderOverlay's output on the card
    equal to the CPU's composite of the card's own Final and canvas."""
    import dataclasses

    import torch

    from sailor_tpu_torch.engine import overlay as overlay_mod
    from sailor_tpu_torch.framegraph.nodes import RenderOverlayNode, SkyNode
    from sailor_tpu_torch.framegraph.graph import RenderContext
    from sailor_tpu_torch.scenes import flagship_world_doc

    hud = overlay_mod.stats_hud
    overlay_mod.stats_hud = lambda ov, stats, console_lines=(): hud(ov, HUD_STATS)
    out, draws, comps, terms = {}, {}, {}, {}
    try:
        for dev in ("cuda", "cpu"):
            loop, _ = _night_loop(flagship_world_doc(24, 6, aspect=2.0), 256, 128,
                                  dict(NIGHT_CONFIG, shadow_resolution=128), dev)
            scenes = []
            push = loop.renderer.push_frame
            loop.renderer.push_frame = lambda s, _p=push: (scenes.append(s), _p(s))[1]
            out[dev], draws[dev], comps[dev] = [], [], []
            with captured_node("DebugDraw", ("Main",), draws[dev]), \
                    captured_node("RenderOverlay", ("Final", "overlay/canvas"), comps[dev]):
                for _ in range(2):
                    t = loop.process_cpu_frame(1 / 60)
                    out[dev].append({k: t[k].cpu() for k in NIGHT_KEYS})
            if dev == "cpu":  # the star term of each Sky shown: the frame it was rendered on
                fg = loop.renderer.frame_graph
                node = SkyNode({})
                for i, shown in enumerate(o["Sky"] for o in out[dev]):
                    for s in scenes:
                        lit = node.process(fg._ctx(s, {}), {})["Sky"]
                        if torch.equal(lit, shown):
                            dark = node.process(fg._ctx(dataclasses.replace(
                                s, star_dirs=None, star_colors=None), {}), {})["Sky"]
                            terms[i] = lit - dark
    finally:
        overlay_mod.stats_hud = hud
    for i, (g, r) in enumerate(zip(out["cuda"], out["cpu"])):
        check(i in terms, f"small night frame {i + 1}: no CPU frame rendered the Sky shown")
        ok, line = night_frame_agreement(g, r, terms[i])
        (db, da), (rb, ra) = draws["cuda"][i], draws["cpu"][i]
        wrote = (da["Main"] != db["Main"]).any(-1)
        lines_same = (bool(torch.equal(wrote, (ra["Main"] != rb["Main"]).any(-1)))
                      and bool(torch.equal(da["Main"][wrote], ra["Main"][wrote])))
        (cb, ca), (pb, _) = comps["cuda"][i], comps["cpu"][i]
        mine = RenderOverlayNode({}).process(
            RenderContext(width=256, height=128, state={"overlay/canvas": cb["overlay/canvas"]}),
            {"Final": cb["Final"]})["Final"]
        comp_same = (bool(torch.equal(cb["overlay/canvas"], pb["overlay/canvas"]))
                     and bool(torch.equal(mine, ca["Final"])))
        lit = int((terms[i].abs().amax(-1) > 1e-6).sum())
        print(f"small night frame {i + 1} card vs cpu: {line} debug_pixels={int(wrote.sum())} "
              f"debug_lines_equal={lines_same} composite_equal={comp_same} star_lit={lit}")
        check(ok and lines_same and comp_same and int(wrote.sum()) > 0 and lit > 100,
              "the card's night frame disagrees with the CPU path")


# --- content: GLB, .mat and .particles files written at run time -------------


class GltfWriter:
    """A glTF 2.0 document and its binary buffer, built in memory (test
    tooling: the content phases write their models with it, and
    tests/test_torch_assets.py holds both packages' loaders to what it
    writes)."""

    TYPES = {1: "SCALAR", 2: "VEC2", 3: "VEC3", 4: "VEC4", 16: "MAT4"}
    COMPONENTS = {"float32": 5126, "uint32": 5125, "uint16": 5123, "int16": 5122,
                  "uint8": 5121, "int8": 5120}

    def __init__(self):
        self.doc = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": []}]}
        self.bin = bytearray()

    def _add(self, key: str, item: dict) -> int:
        self.doc.setdefault(key, []).append(item)
        return len(self.doc[key]) - 1

    def view(self, data: bytes, stride: int | None = None) -> int:
        """A buffer view of ``data`` (4-byte aligned), strided if asked."""
        self.bin += b"\0" * (-len(self.bin) % 4)
        bv = {"buffer": 0, "byteOffset": len(self.bin), "byteLength": len(data)}
        if stride:
            bv["byteStride"] = stride
        self.bin += data
        return self._add("bufferViews", bv)

    def accessor(self, arr, *, normalized: bool = False, view: int | None = None,
                 offset: int = 0, dtype=None, count: int | None = None,
                 ncomp: int | None = None) -> int:
        """An accessor of the (N,) or (N, C) array ``arr`` in a view of its
        own, or of ``count`` x ``ncomp`` items of ``dtype`` at ``offset`` in
        ``view``."""
        import numpy as np

        if view is None:
            arr = np.ascontiguousarray(arr)
            dtype, count = arr.dtype, arr.shape[0]
            ncomp = arr.shape[1] if arr.ndim > 1 else 1
            view = self.view(arr.tobytes())
        acc = {"bufferView": view, "componentType": self.COMPONENTS[np.dtype(dtype).name],
               "count": int(count), "type": self.TYPES[ncomp]}
        if offset:
            acc["byteOffset"] = offset
        if normalized:
            acc["normalized"] = True
        return self._add("accessors", acc)

    def interleaved(self, arrays) -> list:
        """One strided view of float32 (N, C_i) arrays, vertex after vertex;
        returns their accessors."""
        import numpy as np

        arrays = [np.asarray(a, np.float32) for a in arrays]
        widths = [a.shape[1] for a in arrays]
        stride = 4 * sum(widths)
        view = self.view(np.concatenate(arrays, 1).tobytes(), stride=stride)
        offs = np.concatenate([[0], np.cumsum(widths)[:-1]]) * 4
        return [self.accessor(None, view=view, offset=int(o), dtype=np.float32,
                              count=a.shape[0], ncomp=w)
                for a, w, o in zip(arrays, widths, offs)]

    def image_texture(self, data: bytes, mime: str) -> int:
        """An embedded image of type ``mime`` and a texture of it; returns
        the texture."""
        img = self._add("images", {"bufferView": self.view(data), "mimeType": mime})
        return self._add("textures", {"source": img})

    def material(self, albedo, metallic: float, roughness: float, emissive=(0, 0, 0),
                 albedo_texture: int | None = None, normal_texture: int | None = None,
                 **extra) -> int:
        pbr = {"baseColorFactor": [float(v) for v in albedo] + [1.0][:4 - len(albedo)],
               "metallicFactor": float(metallic), "roughnessFactor": float(roughness)}
        m = {"pbrMetallicRoughness": pbr, "emissiveFactor": [float(v) for v in emissive]}
        if albedo_texture is not None:
            pbr["baseColorTexture"] = {"index": albedo_texture}
        if normal_texture is not None:
            m["normalTexture"] = {"index": normal_texture}
        m.update(extra)
        return self._add("materials", m)

    def mesh(self, mesh, material: int) -> int:
        """A mesh of one primitive from a ``primitives.Mesh``."""
        import numpy as np

        attrs = {"POSITION": self.accessor(mesh.positions), "NORMAL": self.accessor(mesh.normals),
                 "TEXCOORD_0": self.accessor(mesh.uvs)}
        idx = np.asarray(mesh.indices, np.uint32).reshape(-1)
        prim = {"attributes": attrs, "indices": self.accessor(idx), "material": material}
        return self._add("meshes", {"primitives": [prim]})

    def node(self, root: bool = True, **node) -> int:
        i = self._add("nodes", node)
        if root:
            self.doc["scenes"][0]["nodes"].append(i)
        return i

    def glb(self) -> bytes:
        import struct

        self.bin += b"\0" * (-len(self.bin) % 4)
        doc = dict(self.doc, buffers=[{"byteLength": len(self.bin)}])
        js = json.dumps(doc).encode()
        js += b" " * (-len(js) % 4)
        total = 12 + 8 + len(js) + 8 + len(self.bin)
        return (struct.pack("<4sII", b"glTF", 2, total)
                + struct.pack("<II", len(js), 0x4E4F534A) + js
                + struct.pack("<II", len(self.bin), 0x004E4942) + bytes(self.bin))


# Annex K of ITU-T T.81: the example quantisation tables (natural order) and
# the standard Huffman tables (BITS counts, HUFFVAL symbols) that libjpeg
# writes unless it optimises them
JPEG_QUANT = (
    (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57,
     69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64,
     81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99),
    (17, 18, 24, 47) + (99,) * 4 + (18, 21, 26, 66) + (99,) * 4 + (24, 26, 56) + (99,) * 5
    + (47, 66) + (99,) * 38)
JPEG_HUFFMAN = {  # (class, slot): (counts, symbols as hex)
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), "000102030405060708090a0b"),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), "000102030405060708090a0b"),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125),
             "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a"
             "161718191a25262728292a3435363738393a434445464748494a535455565758595a6364656667"
             "68696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3"
             "b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4"
             "f5f6f7f8f9fa"),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119),
             "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a1624"
             "34e125f11718191a262728292a35363738393a434445464748494a535455565758595a63646566"
             "6768696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aa"
             "b2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4"
             "f5f6f7f8f9fa"),
}
JPEG_ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
               41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15,
               23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)


def _huffman_codes(counts, symbols):
    """symbol -> (code, length) of a canonical Huffman table."""
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _image_files():
    """tests/torch_image_files.py (numpy only): the arithmetic-coded and
    lossless JPEG writers, and the other formats' writers."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_image_files

    return torch_image_files


def jpeg_frame(img_u8, colour: str = "ycc420"):
    """An (H, W, 3) uint8 image's JPEG frame as this script codes it:
    colour "ycc420" (YCbCr 4:2:0 by 2x2 means), or for (H, W, 4) CMYK
    samples "cmyk" (stored inverted, as Adobe files hold them) or "ycck"
    (the first three coded as YCbCr, K inverted), each 4:4:4, so that
    imageio reads the samples back. A float DCT and the
    Annex K tables scaled to quality 90 as libjpeg scales them. Returns
    (comps, quant): comps as tests/torch_image_files.arith_jpeg takes them
    (``coefs`` the MCU-padded (rows, columns, 64) zigzag blocks; luma or C
    on tables 0, the rest on 1), quant {slot: 64 values in zigzag order}."""
    import numpy as np

    img = np.asarray(img_u8, np.float64)
    h, w = img.shape[:2]
    hs = 2 if colour == "ycc420" else 1
    mh, mw = -(-h // (8 * hs)), -(-w // (8 * hs))
    pad = np.pad(img, ((0, mh * 8 * hs - h), (0, mw * 8 * hs - w), (0, 0)), mode="edge")

    def ycc(r, g, b):
        return (0.299 * r + 0.587 * g + 0.114 * b,
                -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128,
                0.5 * r - 0.418687589 * g - 0.081312411 * b + 128)

    if colour == "ycc420":
        y, cb, cr = ycc(pad[..., 0], pad[..., 1], pad[..., 2])
        planes = [y] + [c.reshape(mh * 8, 2, mw * 8, 2).mean((1, 3)) for c in (cb, cr)]
    elif colour == "cmyk":
        planes = [255.0 - pad[..., k] for k in range(4)]
    else:  # YCCK: decoded C, M, Y = 255 - R, G, B, so the inversion gives the first three
        planes = list(ycc(pad[..., 0], pad[..., 1], pad[..., 2])) + [255.0 - pad[..., 3]]
    scale = 200 - 2 * 90  # libjpeg's quality scaling, for qualities of 50 and up
    quant = [np.clip((np.asarray(t) * scale + 50) // 100, 1, 255) for t in JPEG_QUANT]
    x = np.arange(8)
    dct = np.where(x[:, None] == 0, np.sqrt(1 / 8), np.sqrt(2 / 8)) * np.cos(
        (2 * x[None, :] + 1) * x[:, None] * np.pi / 16)
    zz = np.asarray(JPEG_ZIGZAG)
    comps = []
    for k, plane in enumerate(planes):
        tq = 0 if k == 0 or (colour == "cmyk" and k == 3) else 1
        ph, pw = plane.shape
        b8 = (plane - 128.0).reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
        coef = np.round(dct @ b8 @ dct.T / quant[tq].reshape(8, 8)).astype(np.int64)
        sampling = hs if k == 0 else 1
        comps.append({"id": k + 1, "h": sampling, "v": sampling, "tq": tq, "dc": tq,
                      "ac": tq, "coefs": coef.reshape(ph // 8, pw // 8, 64)[..., zz]})
    return comps, {t: quant[t][zz] for t in range(2)}


def jpeg_bytes(img_u8, restart_rows: int = 1, coding: str = "huffman",
               colour: str = "ycc420") -> bytes:
    """A JFIF JPEG of an (H, W, 3) uint8 image (test tooling: the card's
    machine has no image library), ``jpeg_frame``'s coefficients coded
    with a restart interval of ``restart_rows`` MCU rows. ``coding``:
    "huffman", a baseline file with the standard tables, its entropy
    coding vectorised with numpy so that a 2048 x 2048 map encodes in
    seconds; "arith", the same coefficients arithmetic-coded (SOF9); or
    "progressive_cut", a progressive arithmetic-coded file (SOF10) of the
    DC scan and the first luma AC scan of libjpeg's simple progression,
    the rest cut (imageio block-smooths such a file). CMYK and YCCK
    (``colour``) files carry an Adobe marker instead of the JFIF one."""
    import numpy as np

    comps, quant = jpeg_frame(img_u8, colour)
    h, w = np.asarray(img_u8).shape[:2]
    hs = comps[0]["h"]
    mh, mw = -(-h // (8 * hs)), -(-w // (8 * hs))
    interval = restart_rows * mw if restart_rows else 0
    adobe = {"ycc420": None, "cmyk": 0, "ycck": 2}[colour]
    if coding != "huffman":
        files = _image_files()
        script = files.simple_progression(3)[:2] if coding == "progressive_cut" else None
        return files.arith_jpeg(w, h, comps, quant, script=script, restart=interval,
                                jfif=adobe is None, adobe=adobe)
    return _huffman_jpeg(w, h, comps, quant, mh, mw, interval, adobe)


def _huffman_jpeg(w, h, comps, quant, mh, mw, restart, adobe) -> bytes:
    """``jpeg_bytes``'s baseline coding: every block of the interleaved scan
    in MCU order, each symbol with its code, packed at once; a restart
    marker every ``restart`` MCUs (none for 0)."""
    import struct

    import numpy as np

    interval = restart or mh * mw

    per = [c["h"] * c["v"] for c in comps]
    grids = [c["coefs"].reshape(mh, c["v"], mw, c["h"], 64).transpose(0, 2, 1, 3, 4)
             .reshape(mh, mw, c["h"] * c["v"], 64) for c in comps]
    # every block of the scan in MCU order, with its component's tables
    seq = np.concatenate(grids, 2).reshape(-1, 64)
    comp_of = np.tile(np.repeat(np.arange(len(comps)), per), mh * mw)
    mcu_of = np.repeat(np.arange(mh * mw), sum(per))
    tables = {k: _huffman_codes(c, bytes.fromhex(v)) for k, (c, v) in JPEG_HUFFMAN.items()}
    # DC differences, the predictor reset at each restart interval
    dc = seq[:, 0]
    prev = np.zeros_like(dc)
    for c in range(len(comps)):
        idx = np.nonzero(comp_of == c)[0]
        d = dc[idx]
        p = np.concatenate([[0], d[:-1]])
        first = np.concatenate([[True], (mcu_of[idx][1:] // interval)
                                != (mcu_of[idx][:-1] // interval)])
        prev[idx] = np.where(first, 0, p)
    diff = dc - prev

    def magnitude(v):
        a = np.abs(v)
        s = np.zeros_like(a)
        nz = a > 0
        s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
        bits = np.where(v >= 0, v, v + (1 << s) - 1)
        return s, bits

    # every symbol as (block, key within the block, code with its extra bits,
    # length): the DC first (key -1), before AC coefficient k its ZRLs
    # (100 k + n) and itself (100 k + 50), the EOB last (6400)
    code_of = {key: (np.array([t.get(i, (0, 0))[0] for i in range(256)], np.int64),
                     np.array([t.get(i, (0, 0))[1] for i in range(256)], np.int64))
               for key, t in tables.items()}
    chroma_tab = np.asarray([c["dc"] for c in comps])[comp_of]
    sym_blk, sym_key, sym_code, sym_len = [], [], [], []

    def put(blk, key, cls, sym, extra, extra_len):
        (c0, l0), (c1, l1) = code_of[(cls, 0)], code_of[(cls, 1)]
        chroma = chroma_tab[blk] == 1
        length = np.where(chroma, l1[sym], l0[sym])
        sym_blk.append(blk)
        sym_key.append(key)
        sym_code.append((np.where(chroma, c1[sym], c0[sym]) << extra_len) | extra)
        sym_len.append(length + extra_len)

    nb = seq.shape[0]
    s_dc, b_dc = magnitude(diff)
    put(np.arange(nb), np.full(nb, -1), 0, s_dc, b_dc, s_dc)
    bi, ki = np.nonzero(seq[:, 1:])  # by block, then by position
    k = ki + 1
    first = np.concatenate([[True], bi[1:] != bi[:-1]])
    run = k - np.where(first, 0, np.concatenate([[0], k[:-1]])) - 1
    zrl = run // 16
    rep = np.repeat(np.arange(bi.size), zrl)
    if rep.size:
        nth = np.arange(rep.size) - np.repeat(np.cumsum(zrl) - zrl, zrl)
        zero = np.zeros(rep.size, np.int64)
        put(bi[rep], 100 * k[rep] + nth, 1, np.full(rep.size, 0xF0), zero, zero)
    s_ac, b_ac = magnitude(seq[bi, k])
    put(bi, 100 * k + 50, 1, ((run % 16) << 4) | s_ac, b_ac, s_ac)
    last = np.zeros(nb, np.int64)
    np.maximum.at(last, bi, k)
    eob = np.nonzero(last < 63)[0]
    zero = np.zeros(eob.size, np.int64)
    put(eob, np.full(eob.size, 6400), 1, zero, zero, zero)
    blk = np.concatenate(sym_blk)
    order = np.lexsort((np.concatenate(sym_key), blk))
    code = np.concatenate(sym_code)[order]
    length = np.concatenate(sym_len)[order]
    ivl = mcu_of[blk[order]] // interval
    # each restart interval ends on a byte, padded with 1 bits
    ends = np.nonzero(np.concatenate([ivl[1:] != ivl[:-1], [True]]))[0]
    ivl_bits = np.add.reduceat(length, np.concatenate([[0], ends[:-1] + 1]))
    padn = -ivl_bits % 8
    code = np.insert(code, ends + 1, (1 << padn) - 1)
    length = np.insert(length, ends + 1, padn)
    # pack: each code (at most 27 bits) left-aligned in the 64-bit window
    # of the two 32-bit words it starts in; the fields never overlap, so
    # summing them (exactly, in float64) is their OR
    start = np.cumsum(length) - length
    word, off = start // 32, start % 32
    window = code.astype(np.uint64) << (64 - off - length).astype(np.uint64)
    nwords = int(-(-int(length.sum()) // 32)) + 1
    words = (np.bincount(word, (window >> np.uint64(32)).astype(np.float64), nwords)
             + np.bincount(word + 1, (window & np.uint64(0xFFFFFFFF)).astype(np.float64),
                           nwords + 1)[:nwords])
    data = words.astype(">u4").view(np.uint8)
    ivl_bytes = np.cumsum((ivl_bits + padn) // 8)
    out = bytearray()
    start = 0
    for i, end in enumerate(ivl_bytes):
        part = data[start:end]
        out += np.insert(part, np.nonzero(part == 0xFF)[0] + 1, 0).tobytes()  # byte stuffing
        if i + 1 < len(ivl_bytes):
            out += bytes([0xFF, 0xD0 + i % 8])
        start = end

    def seg(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    head = b"\xff\xd8"
    if adobe is None:
        head += seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    else:
        head += seg(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([adobe]))
    for t in range(2):
        head += seg(0xDB, bytes([t]) + bytes(int(v) for v in quant[t]))
    head += seg(0xC0, struct.pack(">BHHB", 8, h, w, len(comps)) + b"".join(
        bytes([c["id"], c["h"] << 4 | c["v"], c["tq"]]) for c in comps))
    for (cls, slot), (counts, symbols) in JPEG_HUFFMAN.items():
        head += seg(0xC4, bytes([cls << 4 | slot, *counts]) + bytes.fromhex(symbols))
    if restart:
        head += seg(0xDD, struct.pack(">H", restart))
    head += seg(0xDA, bytes([len(comps)]) + b"".join(
        bytes([c["id"], c["dc"] << 4 | c["ac"]]) for c in comps) + bytes([0, 63, 0]))
    return head + bytes(out) + b"\xff\xd9"


def map_jpeg(img, coding: str = "huffman") -> bytes:
    """A float (H, W, 4) map in [0, 1] as a 4:2:0 JPEG (quality 90, a
    restart interval of one MCU row), coded as ``jpeg_bytes`` codes it."""
    import numpy as np

    return jpeg_bytes(np.clip(np.round(np.asarray(img)[..., :3] * 255.0), 0, 255)
                      .astype(np.uint8), coding=coding)


def map_png(img) -> bytes:
    """A float (H, W, 4) map in [0, 1] as an 8-bit RGB PNG (its alpha is 1)."""
    import numpy as np

    from sailor_tpu_torch.utils.png import encode_png

    return encode_png(np.clip(np.round(np.asarray(img)[..., :3] * 255.0), 0, 255)
                      .astype(np.uint8))


def flagship_objects(num_objects: int, seed: int = 11):
    """The flagship scene's meshes and translations from its own RNG calls
    (``scenes._flagship``): [(primitives.Mesh, (x, y, z))], the 60 m
    ground first."""
    import numpy as np

    from sailor_tpu_torch.assets import primitives

    rng = np.random.default_rng(seed)
    out = [(primitives.plane(60.0), (0.0, 0.0, 0.0))]
    for i in range(num_objects):
        t = tuple(float(v) for v in (rng.uniform(-20, 20), rng.uniform(0.4, 2.0),
                                     rng.uniform(-20, 20)))
        mesh = (primitives.cube(rng.uniform(0.8, 2.0)) if i % 2
                else primitives.uv_sphere(rng.uniform(0.4, 1.0), 16, 32))
        out.append((mesh, t))
    return out


CONTENT_MATERIALS = 8  # the content GLB's materials: the ground's, then 7 for the objects


def map_texture(w, img, jpeg: bool) -> int:
    """``img`` embedded in ``w`` as a PNG, or as a JPEG (``map_jpeg``)."""
    if jpeg:
        return w.image_texture(map_jpeg(img), "image/jpeg")
    return w.image_texture(map_png(img), "image/png")


def flagship_glb(num_objects: int, maps, jpeg: bool = False, encoded=None) -> bytes:
    """The flagship scene's geometry as a GLB: one node a mesh with its
    translation, the ground material 0 and object i material 1 + i % 7;
    ``maps`` (procedural_test_maps) embedded as PNG (as JPEG with
    ``jpeg``; ``encoded`` gives the albedo and normal JPEG bytes ready
    made): the albedo map on materials 0-3, the normal map on materials 0
    and 1."""
    w = GltfWriter()
    if encoded is not None:
        albedo, normal = (w.image_texture(data, "image/jpeg") for data in encoded)
    else:
        albedo, normal = map_texture(w, maps[0], jpeg), map_texture(w, maps[1], jpeg)
    for m in range(CONTENT_MATERIALS):
        w.material((0.55 + 0.05 * m, 0.6, 0.65 - 0.04 * m), metallic=0.1 * (m % 3),
                   roughness=0.35 + 0.08 * m, albedo_texture=albedo if m < 4 else None,
                   normal_texture=normal if m < 2 else None)
    for i, (mesh, t) in enumerate(flagship_objects(num_objects)):
        w.node(mesh=w.mesh(mesh, 0 if i == 0 else 1 + (i - 1) % 7), translation=list(t))
    return w.glb()


def balls_glb(maps, rings: int = 24, sectors: int = 48, jpeg: bool = False) -> bytes:
    """The material-ball scene (``scenes.material_balls_soup``: a 40 m
    ground and eight spheres, 9 materials) as a GLB, one node a mesh with
    its translation; ``maps[0]`` embedded as the ground's albedo, a PNG (a
    JPEG with ``jpeg``)."""
    from sailor_tpu_torch.assets import primitives
    from sailor_tpu_torch.scenes import material_balls_soup

    _, mats = material_balls_soup(rings, sectors)
    w = GltfWriter()
    tex = map_texture(w, maps[0], jpeg)
    for m in range(len(mats["albedo"])):
        w.material(mats["albedo"][m], mats["metallic"][m], mats["roughness"][m],
                   mats["emissive"][m], albedo_texture=tex if m == 0 else None)
    w.node(mesh=w.mesh(primitives.plane(40.0), 0), translation=[0.0, 0.0, 0.0])
    k = 1
    for i in range(2):
        for j in range(4):
            w.node(mesh=w.mesh(primitives.uv_sphere(0.9, rings, sectors), k),
                   translation=[(j - 1.5) * 2.2, 0.9, (i - 0.5) * 2.4])
            k += 1
    return w.glb()


def rgba_png(img_u8) -> bytes:
    """An (H, W, 4) uint8 image as an 8-bit RGBA PNG (filter 0)."""
    import struct
    import zlib

    h, w = img_u8.shape[:2]
    raw = b"".join(b"\x00" + img_u8[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


CONTENT_ROWS = ("albedo", "metallic", "roughness", "emissive", "albedo_texture",
                "normal_texture", "queue", "alpha_cutoff", "opacity")


def content_scene(folder, width, height, num_lights, num_objects, device="cuda",
                  map_size=256, jpeg=False, encoded=None):
    """tests/test_golden.py's render_content path on the flagship scene:
    ``flagship_glb`` written to ``folder``, loaded back through
    ``AssetRegistry.load`` (gltf.load_merged) and
    ``GLTF.load_texture_images``, the material rows through
    ``MaterialTable.from_host`` (256-px textures); the flagship lights,
    camera and sun. The GLB holds the ground, so no floor is added. With
    ``jpeg`` the maps are embedded as JPEG, with ``encoded`` as the given
    albedo and normal JPEG bytes. Returns (SceneView, {step: host ms});
    "write" includes the maps' encoding."""
    import numpy as np
    import torch

    from sailor_tpu_torch.assets.gltf import GLTF
    from sailor_tpu_torch.assets.materials import MaterialTable
    from sailor_tpu_torch.assets.registry import AssetRegistry
    from sailor_tpu_torch.raster.setup import Geometry
    from sailor_tpu_torch.rhi.scene_view import SceneView
    from sailor_tpu_torch.scenes import flagship_scene, procedural_test_maps

    ms = {}
    t0 = time.perf_counter()
    path = os.path.join(folder, "flagship.glb")
    with open(path, "wb") as f:
        maps = None if encoded is not None else procedural_test_maps(0, map_size)
        f.write(flagship_glb(num_objects, maps, jpeg, encoded))
    ms["write"] = (time.perf_counter() - t0) * 1e3
    reg = AssetRegistry(folder)
    t0 = time.perf_counter()
    soup, mats = reg.load(path)
    ms["parse"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    images = GLTF.load(path).load_texture_images()
    ms["decode"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    table = MaterialTable.from_host({k: mats[k] for k in CONTENT_ROWS}, images,
                                    texture_size=256, device=device)
    ms["table"] = (time.perf_counter() - t0) * 1e3
    ref = flagship_scene(width, height, num_lights, num_objects, device=device)
    geo = Geometry(**{k: torch.from_numpy(np.ascontiguousarray(soup[k])).to(ref.frame.view.device)
                      for k in ("position", "normal", "uv", "color", "indices", "material_id")})
    t0 = time.perf_counter()
    scene = SceneView.create(geo, ref.lights, ref.frame, sky=ref.sky, materials=table)
    ms["pack"] = (time.perf_counter() - t0) * 1e3
    return scene, ms


def at_time(scene, t):
    """The scene with its frame's current time set to ``t`` seconds."""
    import dataclasses

    import torch

    f = scene.frame
    return dataclasses.replace(scene, frame=dataclasses.replace(
        f, current_time=torch.tensor(t, dtype=torch.float32, device=f.view.device)))


def nodes_graph(width, height, particles_path, device="cuda", config=None):
    """DefaultRenderer.renderer's entries with Clear (Main, 0) first,
    Particles (the baked ``particles_path``) after RenderTransparent, and
    Blit of Final into a declared 480x272 Thumbnail followed by
    CopyTextureToRam(Thumbnail) last: the editor-thumbnail use."""
    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
    from sailor_tpu_torch.rhi.types import TargetSpec

    base = FrameGraphAsset.load(RENDERER)
    frame = [{"name": "Clear", "target": "Main", "clearValue": 0.0}]
    for e in base.frame:
        frame.append(dict(e))
        if e["name"] == "RenderTransparent":
            frame.append({"name": "Particles", "asset": particles_path})
    frame += [{"name": "Blit", "src": "Final", "dst": "Thumbnail"},
              {"name": "CopyTextureToRam", "target": "Thumbnail"}]
    asset = FrameGraphAsset(targets=base.targets + [TargetSpec("Thumbnail", width=480,
                                                               height=272)],
                            frame=frame, values=dict(base.values))
    return FrameGraph(asset, width, height, dict(config or FULL_CONFIG), device=device)


@contextlib.contextmanager
def splat_stats():
    """Records the stats of every particle splat (valid particles, binned
    candidates dropped, slot iterations) as tensors, in call order."""
    from sailor_tpu_torch.kernels import particles

    inner, rows = particles.splat_particles, []

    def recording(*args, **kw):
        stats = {}
        out = inner(*args, stats=stats, **kw)
        rows.append(stats)
        return out

    particles.splat_particles = recording
    try:
        yield rows
    finally:
        particles.splat_particles = inner


def synced_ms():
    import torch

    torch.cuda.synchronize()
    return time.perf_counter() * 1e3


def run_content_glb(card):
    """content-glb-full: the flagship scene's geometry written as a GLB
    (``flagship_glb``: 97 meshes, 8 materials, procedural_test_maps(0,
    256) as PNG albedo on 4 and normal maps on 2), loaded back and
    rendered as render_content does through all of DefaultRenderer.renderer
    (FULL_CONFIG) at 1920x1088: 1 warm-up + 5 frames, each beside a frame
    of the untextured flagship scene (flagship-full) on its own graph, in
    turns. Frame ms, synchronising calls, launches (B1-B3 checked each
    frame), peak memory, per-node ms, the importer's host ms. Then the
    node graph (``nodes_graph``: Clear, Particles with a baked 4096-particle
    fountain at the scene's centre, Blit to a 480x272 thumbnail,
    CopyTextureToRam) for 1 + 5 frames, the trail carried in the state and
    the time advanced 1/30 s a frame: frame ms, the Particles node's ms,
    particles valid and bins' overflow, the thumbnail's shape from fetch;
    and ``process_views`` with the flagship camera and one turned 90
    degrees about y, two steps: each view's ms; a profiled cached frame of
    the content scene, last. Returns the launches of all of these frames
    but the profiled one."""
    import dataclasses
    import math
    import tempfile

    import torch

    from sailor_tpu_torch.assets.particles import bake_fountain
    from sailor_tpu_torch.framegraph.nodes import CopyTextureToRamNode
    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.scenes import flagship_scene

    width, height, n_lights, n_objects = FLAGSHIP
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    with tempfile.TemporaryDirectory() as folder:
        scene, host_ms = content_scene(folder, width, height, n_lights, n_objects)
        plain = flagship_scene(width, height, n_lights, n_objects)
        print(f"content-glb-full: {scene.geometry.indices.shape[0]} triangles, "
              f"{scene.materials.albedo.shape[0]} materials, "
              f"{scene.materials.textures.shape[0]} textures, importer host ms "
              + json.dumps({k: round(v, 3) for k, v in host_ms.items()}) + f" on {card}")
        check(scene.geometry.indices.shape[0] == plain.geometry.indices.shape[0],
              "content-glb-full: the GLB's soup is not the flagship's")
        fg, fg_plain = _full_graph(width, height), _full_graph(width, height)
        state, state_plain = fg.initial_state(), fg_plain.initial_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rows, plain_ms = [], []
        for i in range(6):
            cuda_lib.LAUNCHES.clear()
            with sync_counter() as syncs:
                t0 = synced_ms()
                fg.prepare(scene, state)
                targets, state = fg.process(scene, state)
                ms = synced_ms() - t0
                n_syncs = syncs()
            launches = {k: cuda_lib.LAUNCHES.get(k, 0) for k in PATH_KERNELS}
            add(cuda_lib.LAUNCHES)
            for k in PATH_KERNELS:
                check(launches[k] > 0, f"content-glb-full frame {i + 1} launched no {k}")
            t0 = synced_ms()
            fg_plain.prepare(plain, state_plain)
            _, state_plain = fg_plain.process(plain, state_plain)
            plain_ms.append(synced_ms() - t0)
            rows.append({"frame": i + 1, "frame_ms": round(ms, 3),
                         "flagship_full_ms": round(plain_ms[-1], 3), "syncs": n_syncs,
                         "launches": launches})
        peak = torch.cuda.max_memory_allocated()
        final = targets["Final"]
        cov = (targets["TriId"] >= 0).float().mean().item()
        check(bool(torch.isfinite(final).all()) and cov > 0.3,
              "content-glb-full: the frame is not finite or covers nothing")
        _, _, per_node = fg.process_debug(scene, state)
        mean = sum(r["frame_ms"] for r in rows[1:]) / 5
        plain_mean = sum(plain_ms[1:]) / 5
        print(f"content-glb-full {width}x{height}: frame_ms_2_6={[r['frame_ms'] for r in rows[1:]]} "
              f"mean={mean:.3f} flagship_full_ms_2_6={[round(m, 3) for m in plain_ms[1:]]} "
              f"flagship_full_mean={plain_mean:.3f} peak_mem_bytes={peak} coverage={cov:.4f} "
              f"on {card}")
        for r in rows:
            print("content-glb-full frame " + json.dumps(r))
        print("content-glb-full per_node_ms " + json.dumps(
            {k: round(v, 3) for k, v in per_node.items()}))
        del fg_plain, state_plain, plain

        fountain = bake_fountain(frames=90, n=4096, fps=30)
        ppath = os.path.join(folder, "fountain.particles")
        fountain.save(ppath)
        ng = nodes_graph(width, height, ppath)
        nstate = ng.initial_state()
        node_rows = []
        with splat_stats() as stats, around_node("Particles", synced_ms) as particles_ms:
            for i in range(6):
                cuda_lib.LAUNCHES.clear()
                s = at_time(scene, i / 30)
                before = particles_ms[0]
                t0 = synced_ms()
                ng.prepare(s, nstate)
                nt, nstate = ng.process(s, nstate)
                thumb = CopyTextureToRamNode.fetch(nt)
                ms = synced_ms() - t0
                add(cuda_lib.LAUNCHES)
                for k in PATH_KERNELS:
                    check(cuda_lib.LAUNCHES.get(k, 0) > 0,
                          f"content-glb-full nodes frame {i + 1} launched no {k}")
                st = stats[-1]
                node_rows.append({"frame": i + 1, "frame_ms": round(ms, 3),
                                  "particles_ms": round(particles_ms[0] - before, 3),
                                  "particles_valid": int(st["valid"]),
                                  "bin_overflow": int(st["overflow"]),
                                  "slot_iterations": int(st["slots"]),
                                  "thumbnail": list(thumb["Thumbnail"].shape)})
        for r in node_rows:
            print("content-glb-full nodes frame " + json.dumps(r))
        check(all(r["thumbnail"] == [272, 480, 3] for r in node_rows),
              "content-glb-full: the thumbnail's readback has another shape")
        check(node_rows[-1]["particles_valid"] > 0, "content-glb-full: no particle on screen")
        check(bool(torch.isfinite(nstate["particles/trail"]).all())
              and nstate["particles/trail"].sum().item() > 0,
              "content-glb-full: the particle trail is empty")

        turned = _turned(scene, math.pi / 2).frame
        views = [ng.initial_state(), ng.initial_state()]
        ng.prepare(scene, views[0])
        ng.prepare(dataclasses.replace(scene, frame=turned), views[1])
        view_ms = []
        inner = ng.process

        def timed(sc, st):
            t0 = synced_ms()
            out = inner(sc, st)
            view_ms[-1].append(round(synced_ms() - t0, 3))
            return out

        ng.process = timed
        try:
            for step in range(2):
                cuda_lib.LAUNCHES.clear()
                view_ms.append([])
                outs, views = ng.process_views(scene, views, [scene.frame, turned])
                add(cuda_lib.LAUNCHES)
        finally:
            del ng.process
        diff = (outs[0]["Final"] - outs[1]["Final"]).abs().mean().item()
        print(f"content-glb-full process_views: view_ms_by_step={view_ms} "
              f"mean_abs_final_diff={diff:.4f} on {card}")
        check(diff > 1e-3, "content-glb-full: the two views rendered the same image")
        profile(lambda: fg.process(scene, state), card, "profile_content_glb")
    return total


def check_small_content():
    """The content paths at 256x128 on the card against the CPU path: the
    content GLB frame (6 objects, 64-px maps) two frames through
    DefaultRenderer.renderer (full_frame_agreement); the node graph
    (512-particle fountain) two frames with the trail: the frame held the
    same way, the thumbnail within 2/255 and the trail within 1e-4
    relative (to max(|cpu|, 1e-3)) on >= 99.5% of pixels; and
    process_views' two views of a step, each held the same way."""
    import dataclasses
    import math
    import tempfile

    import torch

    from sailor_tpu_torch.assets.particles import bake_fountain
    from sailor_tpu_torch.framegraph.nodes import CopyTextureToRamNode

    config = dict(FULL_CONFIG, shadow_resolution=128)
    out = {}
    with tempfile.TemporaryDirectory() as folder:
        ppath = os.path.join(folder, "fountain.particles")
        bake_fountain(frames=30, n=512, fps=30).save(ppath)
        for dev in ("cuda", "cpu"):
            scene, _ = content_scene(folder, 256, 128, 24, 6, device=dev, map_size=64)
            fg = _full_graph(256, 128, dev, config)
            state = fg.initial_state()
            frames = []
            for s in (scene, _turned(scene, 0.05)):
                fg.prepare(s, state)
                t, state = fg.process(s, state)
                frames.append({k: t[k].cpu() for k in FULL_FRAME_KEYS})
            ng = nodes_graph(256, 128, ppath, dev, config)
            nstate = ng.initial_state()
            node_frames = []
            for i in range(2):
                s = at_time(scene, i / 30)
                ng.prepare(s, nstate)
                t, nstate = ng.process(s, nstate)
                f = {k: t[k].cpu() for k in FULL_FRAME_KEYS}
                f["Thumbnail"] = torch.from_numpy(CopyTextureToRamNode.fetch(t)["Thumbnail"])
                f["trail"] = nstate["particles/trail"].cpu()
                node_frames.append(f)
            turned = _turned(scene, math.pi / 2).frame
            views = [ng.initial_state(), ng.initial_state()]
            ng.prepare(scene, views[0])
            ng.prepare(dataclasses.replace(scene, frame=turned), views[1])
            outs, _ = ng.process_views(scene, views, [scene.frame, turned])
            out[dev] = (frames, node_frames, [{k: o[k].cpu() for k in FULL_FRAME_KEYS}
                                              for o in outs])
    (gf, gn, gv), (rf, rn, rv) = out["cuda"], out["cpu"]
    for i, (g, r) in enumerate(zip(gf, rf)):
        ok, line = full_frame_agreement(g, r)
        print(f"small content-glb frame {i + 1} card vs cpu: {line}")
        check(ok, "the card's content frame disagrees with the CPU path")
    for i, (g, r) in enumerate(zip(gn, rn)):
        ok, line = full_frame_agreement(g, r)
        thumb = (g["Thumbnail"] - r["Thumbnail"]).abs().max().item()
        rel = ((g["trail"] - r["trail"]).abs() / r["trail"].abs().clamp(min=1e-3)).amax(-1)
        trail = (rel <= 1e-4).float().mean().item()
        print(f"small content-glb nodes frame {i + 1} card vs cpu: {line} "
              f"thumbnail_max_err={thumb:.3g} trail_within_1e-4={trail:.5f} "
              f"trail_sum={r['trail'].sum().item():.4f}")
        check(ok and thumb <= 2 / 255 and trail >= 0.995,
              "the card's node graph disagrees with the CPU path")
    for i, (g, r) in enumerate(zip(gv, rv)):
        ok, line = full_frame_agreement(g, r)
        print(f"small content-glb process_views view {i + 1} card vs cpu: {line}")
        check(ok, "the card's process_views disagrees with the CPU path")


JPEG_MAP_SIZE = 2048  # content-jpeg-full's maps: the size of DamagedHelmet's JPEG maps
JPEG_FRAMES = 5  # content-jpeg-full's timed frames, after one warm-up
JPEG_CODINGS_SIZE = 256  # content-jpeg-codings' files held to the plain decode
_CONTENT_MAPS = {}


def content_maps(size: int):
    """procedural_test_maps(0, size), made once a run."""
    if size not in _CONTENT_MAPS:
        from sailor_tpu_torch.scenes import procedural_test_maps

        _CONTENT_MAPS[size] = procedural_test_maps(0, size)
    return _CONTENT_MAPS[size]


def content_jpegs(size: int):
    """content-jpeg-full's albedo and normal maps (``content_maps``) as
    ``map_jpeg`` codes them, written once a run and reused: (albedo
    bytes, normal bytes). Prints the write's ms the first time."""
    if ("jpeg", size) not in _CONTENT_MAPS:
        t0 = time.perf_counter()
        _CONTENT_MAPS["jpeg", size] = tuple(map_jpeg(m) for m in content_maps(size)[:2])
        print(f"content maps {size} px made and written as JPEGs once: "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    return _CONTENT_MAPS["jpeg", size]


def timed_decodes(path):
    """Each image of the GLB at ``path`` decoded alone through
    ``textures.decode_bytes``: [{"image", "shape", "ms", "mp_per_s"}]."""
    from sailor_tpu_torch.assets import textures
    from sailor_tpu_torch.assets.gltf import GLTF

    g = GLTF.load(path)
    rows = []
    for i, img in enumerate(g.doc["images"]):
        bv = g.doc["bufferViews"][img["bufferView"]]
        off = bv.get("byteOffset", 0)
        raw = bytes(g.buffers[bv.get("buffer", 0)][off:off + bv["byteLength"]])
        t0 = time.perf_counter()
        arr = textures.decode_bytes(raw, f"images[{i}]", img.get("mimeType"))
        ms = (time.perf_counter() - t0) * 1e3
        rows.append({"image": i, "mime": img.get("mimeType"), "bytes": len(raw),
                     "shape": list(arr.shape), "ms": round(ms, 3),
                     "mp_per_s": round(arr.shape[0] * arr.shape[1] / 1e6 / (ms / 1e3), 3)})
    return rows


def run_content_jpeg(card):
    """content-jpeg-full: the flagship scene as ``flagship_glb`` writes it
    with its albedo and normal maps embedded as 2048 x 2048 baseline JPEGs
    (``map_jpeg``: 4:2:0, quality 90, a restart interval), loaded through
    the registry (gltf.load_merged; the port's JPEG decoder) and rendered
    through all of DefaultRenderer.renderer (FULL_CONFIG) at 1920x1088: 1
    warm-up + JPEG_FRAMES frames, each beside a frame of content-glb-full's PNG
    scene (256-px maps) on its own graph, in turns. Each texture's decode
    host ms and MP/s, the importer's ms, frame ms, syncs, launches (B1-B3
    checked each frame), peak memory and per-node ms; then one more frame
    whose every B1-B3 launch is held to its plain twin. Returns the
    launches of the timed frames."""
    import tempfile

    import torch

    from sailor_tpu_torch.kernels import cuda_lib

    width, height, n_lights, n_objects = FLAGSHIP
    total = {}
    with tempfile.TemporaryDirectory() as jfolder, tempfile.TemporaryDirectory() as pfolder:
        scene, host_ms = content_scene(jfolder, width, height, n_lights, n_objects,
                                       map_size=JPEG_MAP_SIZE,
                                       encoded=content_jpegs(JPEG_MAP_SIZE))
        decodes = timed_decodes(os.path.join(jfolder, "flagship.glb"))
        png, _ = content_scene(pfolder, width, height, n_lights, n_objects)
    importer = sum(v for k, v in host_ms.items() if k != "write")
    print(f"content-jpeg-full: {scene.geometry.indices.shape[0]} triangles, "
          f"{scene.materials.textures.shape[0]} textures from {JPEG_MAP_SIZE}-px JPEGs, "
          f"importer_total_ms={importer:.3f} host ms " + json.dumps(
              {k: round(v, 3) for k, v in host_ms.items()}) + f" on {card}")
    for r in decodes:
        print("content-jpeg-full decode " + json.dumps(r))
        check(r["mime"] == "image/jpeg" and r["shape"] == [JPEG_MAP_SIZE, JPEG_MAP_SIZE, 3],
              "content-jpeg-full: a map did not decode as a 2048 x 2048 RGB JPEG")
    fg, fg_png = _full_graph(width, height), _full_graph(width, height)
    state, state_png = fg.initial_state(), fg_png.initial_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for i in range(1 + JPEG_FRAMES):
        cuda_lib.LAUNCHES.clear()
        with sync_counter() as syncs:
            t0 = synced_ms()
            fg.prepare(scene, state)
            targets, state = fg.process(scene, state)
            ms = synced_ms() - t0
            n_syncs = syncs()
        launches = {k: cuda_lib.LAUNCHES.get(k, 0) for k in PATH_KERNELS}
        for k, v in cuda_lib.LAUNCHES.items():
            total[k] = total.get(k, 0) + v
        for k in PATH_KERNELS:
            check(launches[k] > 0, f"content-jpeg-full frame {i + 1} launched no {k}")
        t0 = synced_ms()
        fg_png.prepare(png, state_png)
        _, state_png = fg_png.process(png, state_png)
        rows.append({"frame": i + 1, "frame_ms": round(ms, 3),
                     "png_frame_ms": round(synced_ms() - t0, 3), "syncs": n_syncs,
                     "launches": launches})
    peak = torch.cuda.max_memory_allocated()
    cov = (targets["TriId"] >= 0).float().mean().item()
    check(bool(torch.isfinite(targets["Final"]).all()) and cov > 0.3,
          "content-jpeg-full: the frame is not finite or covers nothing")
    _, _, per_node = fg.process_debug(scene, state)
    timed = rows[1:]
    print(f"content-jpeg-full {width}x{height}: frame_ms_2_6={[r['frame_ms'] for r in timed]} "
          f"mean={sum(r['frame_ms'] for r in timed) / len(timed):.3f} "
          f"png_frame_ms_2_6={[r['png_frame_ms'] for r in timed]} "
          f"png_mean={sum(r['png_frame_ms'] for r in timed) / len(timed):.3f} "
          f"peak_mem_bytes={peak} "
          f"coverage={cov:.4f} on {card}")
    for r in rows:
        print("content-jpeg-full frame " + json.dumps(r))
    print("content-jpeg-full per_node_ms " + json.dumps(
        {k: round(v, 3) for k, v in per_node.items()}))
    record = {}
    with twin_checked(record):
        fg.prepare(scene, state)
        fg.process(scene, state)
    for k in PATH_KERNELS:
        check(len(record.get(k, [])) > 0, f"content-jpeg-full: the held frame launched no {k}")
    print("content-jpeg-full twin_checked_frames=1 launches_held " + json.dumps(
        {k: {"launches": len(v), "max_abs_err": max(v)} for k, v in record.items()}))
    return total


def jpeg_coding_files(size: int):
    """content-jpeg-codings' small files, one of each coding the decoder
    gained: {name: bytes}. The maps are procedural_test_maps(0, size), the
    lossless files a size / 4 crop of them; the CMYK samples take the
    albedo as C, M, Y and the normal map's red as K."""
    import numpy as np

    from sailor_tpu_torch.scenes import procedural_test_maps

    files = _image_files()
    maps = [np.clip(np.round(np.asarray(m)[..., :3] * 255.0), 0, 255).astype(np.uint8)
            for m in procedural_test_maps(0, size)[:2]]
    cmyk = np.concatenate([maps[0], maps[1][..., :1]], -1)
    out = {"arith": jpeg_bytes(maps[0], coding="arith"),
           "arith_progressive_cut": jpeg_bytes(maps[1], coding="progressive_cut"),
           "cmyk": jpeg_bytes(cmyk, colour="cmyk"),
           "ycck": jpeg_bytes(cmyk, coding="arith", colour="ycck")}
    comps, quant = jpeg_frame(maps[0])
    out["arith_progressive"] = files.arith_jpeg(size, size, comps, quant, restart=size // 16,
                                                script=files.simple_progression(3))
    crop = max(size // 4, 8)  # the plain lossless decode walks samples in Python
    for pred in (1, 4, 7):
        out[f"lossless_p{pred}"] = files.lossless_jpeg(
            [maps[pred % 2][:crop, :crop, k] for k in range(3)], pred, restart_rows=crop // 4)
    base = jpeg_bytes(maps[0])
    i = base.find(b"\xff\xd9")
    out["dnl"] = base[:i] + b"\xff\xdc\x00\x04" + size.to_bytes(2, "big") + base[i:]
    return out


def run_content_jpeg_codings(card):
    """content-jpeg-codings (phase 6j of the module docstring). Returns the
    launches of the arithmetic-albedo frames."""
    import tempfile

    import numpy as np
    import torch

    from sailor_tpu_torch.kernels import cuda_lib, host_lib
    from sailor_tpu_torch.utils import jpeg

    width, height, n_lights, n_objects = FLAGSHIP
    size = JPEG_MAP_SIZE
    host_lib.load("image")  # built before the decodes are timed
    huffman_albedo = content_jpegs(size)[0]
    t0 = time.perf_counter()
    maps = content_maps(size)
    arith_albedo = map_jpeg(maps[0], "arith")
    t1 = time.perf_counter()
    cut_normal = map_jpeg(maps[1], "progressive_cut")
    t2 = time.perf_counter()
    print(f"content-jpeg-codings {size} px: the albedo's coefficients arithmetic-coded in "
          f"{(t1 - t0) * 1e3:.3f} ms ({len(arith_albedo)} bytes; Huffman "
          f"{len(huffman_albedo)}), the cut progressive normal map in "
          f"{(t2 - t1) * 1e3:.3f} ms ({len(cut_normal)} bytes) on the host")
    decoded = {}
    for name, data in (("huffman_albedo", huffman_albedo), ("arith_albedo", arith_albedo),
                       ("progressive_cut_normal", cut_normal)):
        t0 = time.perf_counter()
        decoded[name] = jpeg.decode_jpeg(data)
        ms = (time.perf_counter() - t0) * 1e3
        print("content-jpeg-codings decode " + json.dumps(
            {"image": name, "bytes": len(data), "shape": list(decoded[name].shape),
             "ms": round(ms, 3), "mp_per_s": round(size * size / 1e6 / (ms / 1e3), 3),
             "card": card}))
        check(decoded[name].shape == (size, size, 3),
              f"content-jpeg-codings: {name} did not decode as a {size}-px RGB JPEG")
    check(np.array_equal(decoded["arith_albedo"], decoded["huffman_albedo"]),
          "content-jpeg-codings: the arithmetic-coded albedo differs from its Huffman source")
    err = np.abs(decoded["progressive_cut_normal"].astype(np.int64)
                 - np.round(np.asarray(maps[1])[..., :3] * 255).astype(np.int64)).mean()
    t0 = time.perf_counter()
    cut_plain = jpeg.decode_jpeg(cut_normal, plain=True)
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"content-jpeg-codings: arith albedo == Huffman albedo bit for bit; the cut normal "
          f"map's mean error against its source {err:.3f} / 255; its plain decode "
          f"{plain_ms:.3f} ms, equal to the C++ one: "
          f"{np.array_equal(cut_plain, decoded['progressive_cut_normal'])}")
    check(np.array_equal(cut_plain, decoded["progressive_cut_normal"]),
          "content-jpeg-codings: the C++ decode of the cut normal map differs from the plain one")
    check(err < 24, "content-jpeg-codings: the cut progressive normal map is far from its source")
    for name, data in jpeg_coding_files(JPEG_CODINGS_SIZE).items():
        t0 = time.perf_counter()
        native = jpeg.decode_jpeg(data)
        t1 = time.perf_counter()
        plain = jpeg.decode_jpeg(data, plain=True)
        t2 = time.perf_counter()
        same = native.shape == plain.shape and np.array_equal(native, plain)
        print(f"content-jpeg-codings {JPEG_CODINGS_SIZE} px {name}: {native.dtype} "
              f"{native.shape} C++ {(t1 - t0) * 1e3:.3f} ms equal to plain "
              f"{(t2 - t1) * 1e3:.3f} ms: {same}")
        check(same, f"content-jpeg-codings: the C++ decode of {name} differs from the plain one")
    with tempfile.TemporaryDirectory() as af, tempfile.TemporaryDirectory() as hf:
        scene, host_ms = content_scene(af, width, height, n_lights, n_objects,
                                       encoded=(arith_albedo, cut_normal))
        ref, _ = content_scene(hf, width, height, n_lights, n_objects,
                               encoded=(huffman_albedo, cut_normal))
    print("content-jpeg-codings importer host ms " + json.dumps(
        {k: round(v, 3) for k, v in host_ms.items()}))
    check(torch.equal(scene.materials.textures, ref.materials.textures),
          "content-jpeg-codings: the arithmetic albedo's textures differ from the Huffman ones")
    total = {}
    frames = {}
    for name, sc in (("arith", scene), ("huffman", ref)):
        fg = _full_graph(width, height)
        state = fg.initial_state()
        cuda_lib.LAUNCHES.clear()
        t0 = synced_ms()
        fg.prepare(sc, state)
        targets, state = fg.process(sc, state)
        ms = synced_ms() - t0
        launches = {k: cuda_lib.LAUNCHES.get(k, 0) for k in PATH_KERNELS}
        print(f"content-jpeg-codings {name}-albedo frame {width}x{height}: {ms:.3f} ms "
              f"launches {json.dumps(launches)} on {card}")
        if name == "arith":
            for k, v in cuda_lib.LAUNCHES.items():
                total[k] = total.get(k, 0) + v
            for k in PATH_KERNELS:
                check(launches[k] > 0, f"content-jpeg-codings: the frame launched no {k}")
            record = {}
            with twin_checked(record):
                fg.prepare(sc, state)
                fg.process(sc, state)
            for k in PATH_KERNELS:
                check(len(record.get(k, [])) > 0,
                      f"content-jpeg-codings: the held frame launched no {k}")
            print("content-jpeg-codings twin_checked_frames=1 launches_held " + json.dumps(
                {k: {"launches": len(v), "max_abs_err": max(v)} for k, v in record.items()}))
        frames[name] = {k: targets[k] for k in FULL_FRAME_KEYS}
    equal = {k: bool(torch.equal(frames["arith"][k], frames["huffman"][k]))
             for k in FULL_FRAME_KEYS}
    cov = (frames["arith"]["TriId"] >= 0).float().mean().item()
    print(f"content-jpeg-codings arith-albedo frame vs huffman-albedo frame bit-equal "
          f"{json.dumps(equal)} coverage={cov:.4f} on {card}")
    check(all(equal.values()) and cov > 0.3 and bool(torch.isfinite(frames["arith"]["Final"]).all()),
          "content-jpeg-codings: the arithmetic-albedo frame differs from the Huffman-albedo one")
    return total


def check_small_content_jpeg():
    """content-jpeg-full at 256x128 (6 objects, 64-px JPEG maps) on the card
    against the CPU path: one frame through DefaultRenderer.renderer
    (full_frame_agreement)."""
    import tempfile

    config = dict(FULL_CONFIG, shadow_resolution=128)
    out = {}
    with tempfile.TemporaryDirectory() as folder:
        for dev in ("cuda", "cpu"):
            scene, _ = content_scene(folder, 256, 128, 24, 6, device=dev, map_size=64, jpeg=True)
            fg = _full_graph(256, 128, dev, config)
            state = fg.initial_state()
            fg.prepare(scene, state)
            t, _ = fg.process(scene, state)
            out[dev] = {k: t[k].cpu() for k in FULL_FRAME_KEYS}
    ok, line = full_frame_agreement(out["cuda"], out["cpu"])
    print(f"small content-jpeg frame card vs cpu: {line}")
    check(ok, "the card's JPEG content frame disagrees with the CPU path")


def glb_trace_scene(folder, device="cuda", rings=24, sectors=48, map_size=256, jpeg=False):
    """examples/trace.py --gltf's path with render_tracer_textured's images:
    ``balls_glb`` written to ``folder``, loaded through the registry with
    ``GLTF.load_texture_images`` as mats["images"], the default sky baked,
    through ``path_tracer.scene_from_mesh``; the tracer demo's camera.
    Returns ((TraceScene, cam, view, proj), {step: host ms})."""
    from sailor_tpu_torch.assets.gltf import GLTF
    from sailor_tpu_torch.assets.registry import AssetRegistry
    from sailor_tpu_torch.kernels.sky import SkyParams
    from sailor_tpu_torch.raytracing import path_tracer
    from sailor_tpu_torch.scenes import procedural_test_maps, tracer_camera

    ms = {}
    path = os.path.join(folder, "balls.glb")
    with open(path, "wb") as f:
        f.write(balls_glb(procedural_test_maps(0, map_size), rings, sectors, jpeg))
    t0 = time.perf_counter()
    soup, mats = AssetRegistry(folder).load(path)
    mats = dict(mats)
    ms["parse"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    mats["images"] = GLTF.load(path).load_texture_images()
    mats["texture_size"] = map_size
    ms["decode"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    scene = path_tracer.scene_from_mesh(soup, mats, sky=SkyParams.default(), device=device)
    ms["scene_from_mesh"] = (time.perf_counter() - t0) * 1e3
    return (scene, *tracer_camera(scene.tri_pack.device)), ms


def run_content_trace(card):
    """content-glb-trace: the material-ball scene as a GLB (9 materials,
    procedural_test_maps(0)'s albedo embedded as PNG on the ground) loaded
    through the registry and traced as examples/trace.py --gltf does
    (``render_cached``, the default sky baked) at 512x512, 4 bounces, 4
    spp, 1 warm-up + 3 renders, each beside a render of material-balls
    (the same scene built in code, with all four maps) in turns: render
    ms, Mrays/s, peak memory, B4 and B5 launches (2 * bounces * spp a
    render, checked); a profiled 1-spp sample, last. Returns the launches
    of the GLB renders."""
    import tempfile

    import torch

    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.kernels.sky import SkyParams
    from sailor_tpu_torch.raytracing import path_tracer
    from sailor_tpu_torch.scenes import material_balls

    width, height, bounces, _ = TRACER
    spp = TRACER_SPP_CUT
    kw = dict(width=width, height=height, spp=spp, max_bounces=bounces)
    with tempfile.TemporaryDirectory() as folder:
        (scene, cam, view, proj), host_ms = glb_trace_scene(folder)
    balls = material_balls(sky=SkyParams.default(), textured=True)
    print(f"content-glb-trace: {scene.tri_pack.shape[0]} triangles, textures "
          f"{tuple(scene.textures.shape)}, importer host ms "
          + json.dumps({k: round(v, 3) for k, v in host_ms.items()}) + f" on {card}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total, rows = {}, []
    for i in range(4):
        cuda_lib.LAUNCHES.clear()
        ms, (img, rays) = _wall_ms(lambda: path_tracer.render_cached(
            scene, cam, view, proj, seed=i, **kw))
        launches = dict(cuda_lib.LAUNCHES)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        bms, (bimg, brays) = _wall_ms(lambda: path_tracer.render_cached(*balls, seed=i, **kw))
        rows.append({"render": i, "ms": round(ms, 3), "mrays_per_s": round(
            float(rays) / ms / 1e3, 4), "balls_ms": round(bms, 3),
            "balls_mrays_per_s": round(float(brays) / bms / 1e3, 4)})
        for k in ("slab_entry", "sweep"):
            check(launches.get(k, 0) == 2 * bounces * spp,
                  f"content-glb-trace render {i} launched {k} {launches.get(k, 0)} times")
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(img).all()) and img.min().item() >= 0.0,
          "content-glb-trace: the image is not finite and >= 0")
    timed = rows[1:]
    print(f"content-glb-trace {width}x{height} b{bounces} spp{spp}: "
          f"render_ms={[r['ms'] for r in timed]} mrays_per_s={[r['mrays_per_s'] for r in timed]} "
          f"material_balls_mrays_per_s={[r['balls_mrays_per_s'] for r in timed]} "
          f"peak_mem_bytes={peak} on {card}")
    for r in rows:
        print("content-glb-trace render " + json.dumps(r))
    profile(lambda: path_tracer.render_cached(scene, cam, view, proj, seed=9, **dict(kw, spp=1)),
            card, "profile_content_glb_trace_sample")
    return total


def run_content_jpeg_trace(card):
    """content-jpeg-trace: ``balls_glb`` with the ground's albedo embedded as
    a 256-px JPEG, loaded through the registry and traced as
    content-glb-trace traces its PNG twin (``render_cached``, the default
    sky baked, 512x512, 4 bounces, 4 spp): 1 warm-up + 3 renders, each
    beside a render of content-glb-trace's PNG GLB, in turns: render ms,
    Mrays/s, peak memory, B4 and B5 launches (2 * bounces * spp a render,
    checked). Returns the launches of the JPEG renders."""
    import tempfile

    import torch

    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.raytracing import path_tracer

    width, height, bounces, _ = TRACER
    spp = TRACER_SPP_CUT
    kw = dict(width=width, height=height, spp=spp, max_bounces=bounces)
    with tempfile.TemporaryDirectory() as jf, tempfile.TemporaryDirectory() as pf:
        (scene, cam, view, proj), host_ms = glb_trace_scene(jf, jpeg=True)
        png_scene = glb_trace_scene(pf)[0][0]
    print(f"content-jpeg-trace: {scene.tri_pack.shape[0]} triangles, textures "
          f"{tuple(scene.textures.shape)}, importer host ms "
          + json.dumps({k: round(v, 3) for k, v in host_ms.items()}) + f" on {card}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total, rows = {}, []
    for i in range(4):
        cuda_lib.LAUNCHES.clear()
        ms, (img, rays) = _wall_ms(lambda: path_tracer.render_cached(
            scene, cam, view, proj, seed=i, **kw))
        launches = dict(cuda_lib.LAUNCHES)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        pms, (_, prays) = _wall_ms(lambda: path_tracer.render_cached(
            png_scene, cam, view, proj, seed=i, **kw))
        rows.append({"render": i, "ms": round(ms, 3),
                     "mrays_per_s": round(float(rays) / ms / 1e3, 4), "png_ms": round(pms, 3),
                     "png_mrays_per_s": round(float(prays) / pms / 1e3, 4)})
        for k in ("slab_entry", "sweep"):
            check(launches.get(k, 0) == 2 * bounces * spp,
                  f"content-jpeg-trace render {i} launched {k} {launches.get(k, 0)} times")
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(img).all()) and img.min().item() >= 0.0,
          "content-jpeg-trace: the image is not finite and >= 0")
    timed = rows[1:]
    print(f"content-jpeg-trace {width}x{height} b{bounces} spp{spp}: "
          f"render_ms={[r['ms'] for r in timed]} mrays_per_s={[r['mrays_per_s'] for r in timed]} "
          f"png_mrays_per_s={[r['png_mrays_per_s'] for r in timed]} peak_mem_bytes={peak} "
          f"on {card}")
    for r in rows:
        print("content-jpeg-trace render " + json.dumps(r))
    return total


HIZ_HEAVY = (1920, 1088, 2000, 1000)  # tools/time_hiz.py's defaults: size, cubes, lights
HIZ_FRAMES = 5  # hiz-heavy's timed frames each way, after one warm-up
HIZ_NODES = ("DepthPrepass", "DepthHighZ", "RenderScene")


def _hiz_heavy_graph(width, height, hiz, device="cuda"):
    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
    from sailor_tpu_torch.tools import time_hiz

    return FrameGraph(FrameGraphAsset.load(RENDERER), width, height,
                      dict(time_hiz.CONFIG, hiz_culling=hiz), device=device)


def _node_ms(per_node, names=HIZ_NODES):
    """The per-node ms of the nodes named (process_debug keys carry an
    order prefix)."""
    return {n: round(sum(v for k, v in per_node.items() if k.split("_", 1)[-1] == n), 3)
            for n in names}


def run_hiz_heavy(card):
    """hiz-heavy: tools/time_hiz.py's occlusion-heavy scene
    (``time_hiz.occlusion_heavy_scene``: a near wall before 2,000 cubes,
    1,000 point lights) at 1920x1088 through all of DefaultRenderer.renderer
    with the tool's config, ``hiz_culling`` on and off on two graphs,
    prepared once: 1 warm-up + HIZ_FRAMES frames each, in turns. Frame ms both ways,
    the culled count of each frame, syncs, B1-B3 launches (checked each
    frame), peak memory, and the per-node ms of DepthPrepass, DepthHighZ
    and RenderScene both ways. Frame 1 culls nothing and later frames cull
    triangles; frame 2 is held to frame 1 (``compare_culled_frame``: Depth
    and TriId move only at pixels whose winner was culled). Then one more
    frame each way whose every B1-B3 launch is held to its plain twin.
    Returns the launches of the timed frames."""
    import torch

    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.tools import time_hiz

    width, height, n_cubes, n_lights = HIZ_HEAVY
    t0 = time.perf_counter()
    scene = time_hiz.occlusion_heavy_scene(width, height, n_cubes, n_lights)
    build_ms = (time.perf_counter() - t0) * 1e3
    graphs = {hiz: _hiz_heavy_graph(width, height, hiz) for hiz in (True, False)}
    states = {hiz: fg.initial_state() for hiz, fg in graphs.items()}
    for hiz, fg in graphs.items():
        fg.prepare(scene, states[hiz])
    ntri = int(scene.geometry.indices.shape[0])
    print(f"hiz-heavy: {ntri} triangles, {n_cubes} cubes behind a wall, {n_lights} lights, "
          f"{width}x{height}, scene host ms {build_ms:.3f} on {card}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total, rows, keep = {}, [], []
    for i in range(1 + HIZ_FRAMES):
        row = {"frame": i + 1}
        for hiz in (True, False):
            fg, prev = graphs[hiz], states[hiz]
            cuda_lib.LAUNCHES.clear()
            with sync_counter() as syncs:
                t0 = synced_ms()
                targets, states[hiz] = fg.process(scene, prev)
                ms = synced_ms() - t0
                n_syncs = syncs()
            for k, v in cuda_lib.LAUNCHES.items():
                total[k] = total.get(k, 0) + v
            for k in PATH_KERNELS:
                check(cuda_lib.LAUNCHES.get(k, 0) > 0,
                      f"hiz-heavy frame {i + 1} (hiz={hiz}) launched no {k}")
            tag = "on" if hiz else "off"
            row[f"{tag}_ms"] = round(ms, 3)
            row[f"{tag}_syncs"] = n_syncs
            row[f"{tag}_culled"] = int(targets.get("HiZCulledCount", 0))
            if hiz and i < 2:
                keep.append({k: targets[k].clone() for k in
                             ("Depth", "TriId", "Main", "ShadowMaps", "EvsmMaps")})
                if i == 1:
                    culled_ids = hiz_culled_ids(targets, prev, width, height)
                    check(int(culled_ids.sum()) == row["on_culled"],
                          "hiz-heavy: the recomputed cull differs from the node's")
        rows.append(row)
    peak = torch.cuda.max_memory_allocated()
    check(rows[0]["on_culled"] == 0 and all(r["off_culled"] == 0 for r in rows),
          "hiz-heavy: a frame culled without a pyramid")
    check(all(r["on_culled"] > 0 for r in rows[1:]), "hiz-heavy: a frame after the first culled "
          "no triangle")
    compare_culled_frame(keep[0], keep[1], culled_ids, card, "hiz-heavy")
    per_node = {("on" if hiz else "off"): _node_ms(fg.process_debug(scene, states[hiz])[2])
                for hiz, fg in graphs.items()}
    held = {}
    for hiz, fg in graphs.items():
        record = {}
        with twin_checked(record):
            _, states[hiz] = fg.process(scene, states[hiz])
        for k in PATH_KERNELS:
            check(len(record.get(k, [])) > 0, f"hiz-heavy: the held frame (hiz={hiz}) "
                  f"launched no {k}")
        held["on" if hiz else "off"] = {k: {"launches": len(v), "max_abs_err": max(v)}
                                        for k, v in record.items()}
    timed = rows[1:]
    on = [r["on_ms"] for r in timed]
    off = [r["off_ms"] for r in timed]
    print(f"hiz-heavy {width}x{height}: on_ms_2_6={on} on_mean={sum(on) / len(on):.3f} "
          f"off_ms_2_6={off} off_mean={sum(off) / len(off):.3f} "
          f"culled_by_frame={[r['on_culled'] for r in rows]} of {ntri} "
          f"peak_mem_bytes={peak} on {card}")
    for r in rows:
        print("hiz-heavy frame " + json.dumps(r))
    print("hiz-heavy per_node_ms " + json.dumps(per_node))
    print("hiz-heavy twin_checked_frames=2 launches_held " + json.dumps(held))
    return total


def small_glb_trace(device):
    import tempfile

    with tempfile.TemporaryDirectory() as folder:
        return glb_trace_scene(folder, device, 12, 24, 64)[0]


# the engine world with a material library: 8 .mat files over the flagship
# world's objects, written at run time (MATERIAL_FILES: name -> (YAML, texture))
MATERIAL_FILES = {
    "ground.mat": ("renderQueue: Opaque\nuniformsVec4:\n  material.albedo: [0.9, 0.9, 0.9, 1]\n"
                   "uniformsFloat:\n  material.roughness: 0.7\n"
                   "samplers:\n  baseSampler: albedo.png\n  normalSampler: normal.png\n"),
    "brick.mat": ("uniformsVec4:\n  material.albedo: [0.8, 0.45, 0.35, 1]\n"
                  "samplers:\n  baseSampler: albedo.png\n"),
    "paint.mat": "uniformsVec4:\n  material.albedo: [0.2, 0.3, 0.85, 1]\n"
                 "uniformsFloat:\n  material.roughness: 0.3\n",
    "metal.mat": "uniformsVec4:\n  material.albedo: [0.95, 0.8, 0.5, 1]\n"
                 "uniformsFloat:\n  material.metallic: 1.0\n  material.roughness: 0.25\n",
    "leaves.mat": ("renderQueue: Masked\nuniformsVec4:\n  material.albedo: [0.5, 0.8, 0.35, 1]\n"
                   "uniformsFloat:\n  material.alphaCutoff: 0.5\n"
                   "samplers:\n  baseSampler: stripes.png\n"),
    "glass.mat": "renderQueue: Transparent\nuniformsVec4:\n  material.albedo: [0.6, 0.8, 1, 0.4]\n",
    "rubber.mat": "uniformsVec4:\n  material.albedo: [0.1, 0.1, 0.1, 1]\n"
                  "uniformsFloat:\n  material.roughness: 0.95\n",
    "emissive.mat": "uniformsVec4:\n  material.albedo: [0.7, 0.7, 0.6, 1]\n"
                    "  material.emission: [2.0, 1.2, 0.4, 0]\n",
}
EDITED = list(MATERIAL_FILES).index("paint.mat")  # the hot-reloaded material's id
EDITED_ALBEDO = ("[0.2, 0.3, 0.85, 1]", "[0.1, 0.9, 0.15, 1]")  # its albedo turns green


def material_folder(folder, map_size):
    """Writes MATERIAL_FILES and their PNGs (procedural_test_maps(0)'s albedo
    and normal maps, and the albedo with 0/1 alpha stripes) into
    ``folder``; returns the .mat paths (list index = material_id)."""
    import numpy as np

    from sailor_tpu_torch.scenes import procedural_test_maps

    maps = procedural_test_maps(0, map_size)
    with open(os.path.join(folder, "albedo.png"), "wb") as f:
        f.write(map_png(maps[0]))
    with open(os.path.join(folder, "normal.png"), "wb") as f:
        f.write(map_png(maps[1]))
    stripes = np.round(maps[0] * 255).astype(np.uint8)
    stripes[..., 3] = np.where((np.arange(map_size) // 8) % 2 == 0, 255, 0)[:, None]
    with open(os.path.join(folder, "stripes.png"), "wb") as f:
        f.write(rgba_png(stripes))
    paths = []
    for name, text in MATERIAL_FILES.items():
        paths.append(os.path.join(folder, name))
        with open(paths[-1], "w") as f:
            f.write(text)
    return paths


def material_world_doc(num_lights, num_objects, aspect, orbit=True):
    """flagship_world_doc with object i's material_id = i % 8 (the ground
    0); ``orbit`` False stops the camera."""
    from sailor_tpu_torch.scenes import flagship_world_doc

    doc = flagship_world_doc(num_lights, num_objects, aspect=aspect)
    k = 0
    for o in doc["gameObjects"]:
        for c in o["components"]:
            if c["typename"] == "MeshRendererComponent":
                c["material_id"] = k % len(MATERIAL_FILES)
                k += 1
            if c["typename"] == "TestComponent" and not orbit:
                c["orbit_speed"] = 0.0
    return doc


def edit_material(path):
    """Rewrites the edited .mat's albedo and moves its time stamp on, so the
    registry's next hot-reload poll re-imports it."""
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace(*EDITED_ALBEDO))
    t = time.time() + 5
    os.utime(path, (t, t))


def material_loop(folder, width, height, num_lights, num_objects, config, device,
                  map_size=256, orbit=True):
    """An EngineLoop over material_world_doc with a MaterialLibrary of
    MATERIAL_FILES (texture_size map_size, mips) as World.materials.
    Returns (loop, library, registry, .mat paths, library build ms)."""
    from sailor_tpu_torch.assets.materials import MaterialLibrary
    from sailor_tpu_torch.assets.registry import AssetRegistry

    paths = material_folder(folder, map_size)
    reg = AssetRegistry(folder)
    reg.scan_content_folder()
    t0 = time.perf_counter()
    lib = MaterialLibrary(reg, paths, texture_size=map_size, mips=True, device=device)
    build_ms = (time.perf_counter() - t0) * 1e3
    loop = _engine_loop(material_world_doc(num_lights, num_objects, width / height, orbit),
                        width, height, config, device)
    loop.world.materials = lib
    return loop, lib, reg, paths, build_ms


def edited_pixels(world, tid, mid):
    """The pixels whose raster triangle's source uses material ``mid``."""
    src_mat = world.meshes.geometry.material_id
    src = tid.clamp(min=0).long() // 2  # the near clipper's two slots a source triangle
    return (tid >= 0) & (src_mat[src] == mid)


def run_engine_materials(card):
    """engine-material-world: EngineLoop over material_world_doc(1000, 96)
    (the camera held still) with a MaterialLibrary of 8 .mat files (three
    with a 256x256 PNG albedo or normal map, one Masked with striped alpha,
    one Transparent) as World.materials, FULL_CONFIG at 1920x1088: 1
    warm-up + 5 frames (frame ms, synchronising calls, B1-B3 launches
    checked), then paint.mat's albedo rewritten, ``check_hot_reload``
    (the library's rebuild timed) and frame 7: the library's version went
    up, its table row changed, and in Main as RenderTransparent leaves it
    (before sun shafts and bloom spread the edit to its neighbours) the
    edited material's pixels changed and the pixels more than 8 px from
    them (the quarter-resolution ambient blends nearer ones) hold frame
    6's within 1e-4 relative on >= 99.5% (Main after the post passes
    printed too); then the per-node ms of one more frame and a profiled
    frame. Returns the launches of frames 1-7."""
    import tempfile

    import torch

    from sailor_tpu_torch.kernels import cuda_lib

    width, height, n_lights, n_objects = FLAGSHIP
    total, rows = {}, []
    with tempfile.TemporaryDirectory() as folder:
        t0 = time.perf_counter()
        loop, lib, reg, paths, build_ms = material_loop(folder, width, height, n_lights,
                                                        n_objects, FULL_CONFIG, "cuda",
                                                        orbit=False)
        load_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rebuild_ms = version = None
        frames = []
        for i in range(7):
            if i == 6:
                old_row = lib.table.albedo[EDITED].cpu()
                version = lib.version
                edit_material(paths[EDITED])
                t0 = synced_ms()
                reloaded = reg.check_hot_reload()
                rebuild_ms = synced_ms() - t0
                check(len(reloaded) == 1 and lib.version == version + 1,
                      "engine-material-world: the edit did not rebuild the library")
            cuda_lib.LAUNCHES.clear()
            shaded = []  # frames 6 and 7: Main as RenderTransparent leaves it
            with sync_counter() as syncs, (captured_node("RenderTransparent", ("Main",), shaded)
                                           if i >= 5 else contextlib.nullcontext()):
                t0 = synced_ms()
                targets = loop.process_cpu_frame(1 / 60)
                ms = synced_ms() - t0
                n_syncs = syncs()
            launches = {k: cuda_lib.LAUNCHES.get(k, 0) for k in PATH_KERNELS}
            for k, v in cuda_lib.LAUNCHES.items():
                total[k] = total.get(k, 0) + v
            for k in PATH_KERNELS:
                check(launches[k] > 0, f"engine-material-world frame {i + 1} launched no {k}")
            rows.append({"frame": i + 1, "frame_ms": round(ms, 3), "syncs": n_syncs,
                         "launches": launches})
            if i >= 5:
                frames.append({"Main": targets["Main"].cpu(), "TriId": targets["TriId"].cpu(),
                               "shaded": shaded[0][1]["Main"]})
        peak = torch.cuda.max_memory_allocated()
        new_row = lib.table.albedo[EDITED].cpu()
        check(not torch.equal(old_row, new_row), "engine-material-world: the table row kept")
        before, after = frames
        edited = edited_pixels(loop.world, targets["TriId"], EDITED).cpu()
        # RenderScene's ambient and shadow factor run at a quarter of the
        # resolution and are upsampled: a pixel within 8 px of the edited
        # material blends its albedo, so the others lie outside that band
        near = torch.nn.functional.max_pool2d(edited[None, None].float(), 17, 1, 8)[0, 0] > 0
        others = (~near) & (after["TriId"] == before["TriId"])
        figures = {}
        for key in ("shaded", "Main"):
            d = (after[key] - before[key]).abs()
            rel = (d / before[key].abs().clamp(min=1e-3)).amax(-1)
            figures[key] = ((d.amax(-1) > 1e-3)[edited].float().mean().item(),
                            (rel[others] <= 1e-4).float().mean().item())
        print(f"engine-material-world {width}x{height}: load_ms={load_ms:.3f} "
              f"library_build_ms={build_ms:.3f} rebuild_ms={rebuild_ms:.3f} "
              f"version={version}->{lib.version} albedo_row {old_row.tolist()}->{new_row.tolist()} "
              f"edited_pixels={int(edited.sum())} shaded_edited_changed={figures['shaded'][0]:.4f} "
              f"shaded_others_held_within_1e-4={figures['shaded'][1]:.5f} "
              f"main_edited_changed={figures['Main'][0]:.4f} "
              f"main_others_held_within_1e-4={figures['Main'][1]:.5f} (after sun shafts and "
              f"bloom) peak_mem_bytes={peak} on {card}")
        for r in rows:
            print("engine-material-world frame " + json.dumps(r))
        check(edited.float().mean().item() > 1e-4 and figures["shaded"][0] > 0.9,
              "engine-material-world: the edited material's pixels did not change")
        check(figures["shaded"][1] >= 0.995,
              "engine-material-world: pixels of other materials changed")
        world = loop.world
        world.tick(1 / 60)
        scene = world.scene_view(sky=loop.sky, prev_frame=loop._prev_frame)
        fg, state = loop.renderer.frame_graph, loop.renderer.state
        fg.prepare(scene, state)
        print("engine-material-world per_node_ms " + json.dumps(
            {k: round(v, 3) for k, v in fg.process_debug(scene, state)[2].items()}))
        profile(lambda: loop.process_cpu_frame(1 / 60), card, "profile_engine_materials")
        loop.renderer.wait_idle()
    return total


def check_small_engine_materials():
    """material_world_doc(24, 6) with the library (64-px maps) through
    EngineLoop at 256x128 on the card against the CPU path: two frames,
    the edit and the hot reload, a third frame; each held as
    check_small_full_frame holds its frame (full_frame_agreement)."""
    import tempfile

    out = {}
    for dev in ("cuda", "cpu"):
        with tempfile.TemporaryDirectory() as folder:
            loop, lib, reg, paths, _ = material_loop(
                folder, 256, 128, 24, 6, dict(FULL_CONFIG, shadow_resolution=128), dev,
                map_size=64)
            out[dev] = []
            for i in range(3):
                if i == 2:
                    edit_material(paths[EDITED])
                    check(len(reg.check_hot_reload()) == 1 and lib.version == 2,
                          "small engine-material-world: no hot reload")
                t = loop.process_cpu_frame(1 / 60)
                out[dev].append({k: t[k].cpu() for k in FULL_FRAME_KEYS})
    for i, (g, r) in enumerate(zip(out["cuda"], out["cpu"])):
        ok, line = full_frame_agreement(g, r)
        print(f"small engine-material-world frame {i + 1} card vs cpu: {line}")
        check(ok, "the card's material world disagrees with the CPU path")



# --- the examples, the editor and the host runtime ----------------------------------

EXAMPLE_FRAME = (1920, 1088, 1000, 5)  # width, height, point lights, timed frames
EXAMPLE_TRACE = (512, 16, 4)  # size, spp, bounces
EXAMPLE_TRACE_SPP_CUT = 4  # spp of the --gltf and --sky runs
FRAME_KERNEL_NAMES = {"raster_worklist": "raster_runs_kernel",
                      "resolve_worklist": "resolve_worklist_kernel",
                      "shade_forward_plus": "shade_kernel"}


@contextlib.contextmanager
def captured_stdout():
    """Yields a list that holds, after the block, what the block printed;
    the text is printed again as it was."""
    import io

    buf, out = io.StringIO(), []
    try:
        with contextlib.redirect_stdout(buf):
            yield out
    finally:
        out.append(buf.getvalue())
        print(out[0], end="")


def _launch_delta(before):
    from sailor_tpu_torch.kernels import cuda_lib

    return {k: v - before.get(k, 0) for k, v in cuda_lib.LAUNCHES.items()
            if v - before.get(k, 0)}


def run_example_frame(card):
    """example-frame: ``python -m sailor_tpu_torch.examples.render_frame
    --width 1920 --height 1088 --lights 1000 --frames 5`` in process (the
    example's scene at the flagship frame's width and light count, B3
    shading on the card): the example's own lines, then each frame's ms to
    a synchronise, BinOverflow, B1-B3 launches (each checked > 0) and
    synchronising calls (``FrameGraph.process`` wrapped for the run, each
    call in ``profile_scope(sync=True)``; ``end_frame()`` printed), the
    peak memory and the PNG checked. The example runs one frame beyond the
    timed ones, its last, with every B1-B3 launch held to its twin
    (``twin_checked``; that frame's ms include the twins). Then one more
    frame under
    ``profiler.device_trace``, whose Chrome trace must name the B1-B3
    kernels, and a profiled frame (idle share). Returns the launches of
    the example's frames."""
    import tempfile

    import numpy as np
    import torch

    from sailor_tpu_torch.examples import render_frame
    from sailor_tpu_torch.framegraph import FrameGraph
    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.utils import profiler
    from sailor_tpu_torch.utils.png import decode_png

    width, height, n_lights, n_frames = EXAMPLE_FRAME
    inner, rows, last, record = FrameGraph.process, [], [], {}

    def process(self, scene, state):
        before = dict(cuda_lib.LAUNCHES)
        held = len(rows) == 1 + n_frames  # the last frame: every launch held to its twin
        with contextlib.ExitStack() as stack:
            if held:
                stack.enter_context(twin_checked(record))
            syncs = stack.enter_context(sync_counter())
            stack.enter_context(profiler.profile_scope("render_frame.process", sync=True))
            t0 = time.perf_counter()
            out = inner(self, scene, state)
            n = syncs()
        torch.cuda.synchronize()
        launches = _launch_delta(before)
        rows.append({"frame": len(rows) + 1,
                     "frame_ms": round((time.perf_counter() - t0) * 1e3, 3),
                     "overflow": int(out[0].get("BinOverflow", 0)), "syncs": n,
                     "launches": {k: launches.get(k, 0) for k in PATH_KERNELS},
                     "held_to_twins": held})
        last[:] = [self, scene, out[1]]
        return out

    profiler.end_frame()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FrameGraph.process = process
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "frame.png")
            before = dict(cuda_lib.LAUNCHES)
            t0 = time.perf_counter()
            rc = render_frame.main(["--width", str(width), "--height", str(height),
                                    "--lights", str(n_lights), "--frames", str(n_frames + 1),
                                    "--out", out])
            wall = time.perf_counter() - t0
            launches = _launch_delta(before)
            with open(out, "rb") as f:
                img = decode_png(f.read())
    finally:
        FrameGraph.process = inner
    peak = torch.cuda.max_memory_allocated()
    zones = profiler.end_frame()
    spread = float(np.asarray(img, np.float32).std())
    print(f"example-frame {width}x{height} lights={n_lights}: rc={rc} wall_s={wall:.3f} "
          f"png={img.shape} spread={spread:.3f} peak_mem_bytes={peak} "
          f"launches {json.dumps(launches)} on {card}")
    for r in rows:
        print("example-frame frame " + json.dumps(r))
    print("example-frame end_frame " + json.dumps(
        {k: [c, round(t, 3), round(m, 3)] for k, (c, t, m) in zones.items()}))
    check(rc == 0 and img.shape == (height, width, 3) and spread > 0,
          "example-frame: the example wrote no frame")
    check(len(rows) == 2 + n_frames and zones["render_frame.process"][0] == 2 + n_frames,
          "example-frame: the frames were not all seen")
    for r in rows:
        for k in PATH_KERNELS:
            check(r["launches"][k] > 0, f"example-frame frame {r['frame']} launched no {k}")
    print(f"example-frame twin_checked_frames=1 (frame {rows[-1]['frame']}) launches_held "
          + json.dumps({k: len(v) for k, v in record.items()})
          + " max_abs_err " + json.dumps({k: max(v) for k, v in record.items()}) + f" on {card}")
    for k in PATH_KERNELS:
        check(len(record.get(k, ())) == rows[-1]["launches"][k],
              f"example-frame: {k} was not held to its twin on every launch of the last frame")
    fg, scene, state = last
    with tempfile.TemporaryDirectory() as log_dir:
        with profiler.device_trace(log_dir):
            fg.process(scene, state)
        with open(os.path.join(log_dir, "trace.json")) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    found = {k: sum(v in n for n in names) > 0 for k, v in FRAME_KERNEL_NAMES.items()}
    print(f"example-frame device_trace: {len(names)} event names, kernels found "
          f"{json.dumps(found)}")
    check(all(found.values()), "example-frame: the device trace lacks a B1-B3 kernel")
    profile(lambda: fg.process(scene, state), card, "profile_example_frame")
    return launches


def check_small_example_frame():
    """The example's scene at 256x128 with 16 lights through its graph and
    config (``pallas_shading`` on both: the CPU dispatch runs B3's plain
    twin), the first frame and a timed one, on the card against the CPU
    path: full_frame_agreement on each."""
    import dataclasses

    from sailor_tpu_torch.examples import render_frame
    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset

    out = {}
    for dev in ("cuda", "cpu"):
        scene = render_frame.build_scene(256, 128, 16, dev)
        fg = FrameGraph(FrameGraphAsset.load(RENDERER), 256, 128,
                        dict(render_frame.CONFIG, pallas_shading=True), device=dev)
        state = fg.initial_state()
        fg.prepare(scene, state)
        out[dev] = []
        for i in range(2):
            s = scene if i == 0 else dataclasses.replace(scene, frame=dataclasses.replace(
                scene.frame, delta_time=scene.frame.delta_time + 1e-6))
            t, state = fg.process(s, state)
            out[dev].append({k: t[k].cpu() for k in FULL_FRAME_KEYS})
    for i, (g, r) in enumerate(zip(out["cuda"], out["cpu"])):
        ok, line = full_frame_agreement(g, r)
        print(f"small example-frame {i + 1} card vs cpu: {line}")
        check(ok, "the card's example frame disagrees with the CPU path")


def run_example_trace(card):
    """example-trace: ``python -m sailor_tpu_torch.examples.trace --size 512
    --spp 16 --bounces 4`` in process (the example's scene, sweep route),
    then ``--gltf`` on ``balls_glb`` written at run time and ``--sky``, at
    4 spp: each run's lines, launches by route (B4/B5 or BVH8 by the
    reference's routing, checked), render ms and Mrays/s, peak memory, the
    PNG checked. Returns the launches of the three runs."""
    import re
    import tempfile

    import numpy as np
    import torch

    from sailor_tpu_torch.examples import trace
    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.scenes import procedural_test_maps
    from sailor_tpu_torch.utils.png import decode_png

    size, spp, bounces = EXAMPLE_TRACE
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        glb = os.path.join(tmp, "balls.glb")
        with open(glb, "wb") as f:
            f.write(balls_glb(procedural_test_maps(0, 256)))
        runs = {"balls": ["--spp", str(spp)],
                "gltf": ["--spp", str(EXAMPLE_TRACE_SPP_CUT), "--gltf", glb],
                "sky": ["--spp", str(EXAMPLE_TRACE_SPP_CUT), "--sky"]}
        for label, extra in runs.items():
            out = os.path.join(tmp, f"{label}.png")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = dict(cuda_lib.LAUNCHES)
            with captured_stdout() as text:
                rc = trace.main(["--size", str(size), "--bounces", str(bounces),
                                 "--out", out, *extra])
            launches = _launch_delta(before)
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            peak = torch.cuda.max_memory_allocated()
            with open(out, "rb") as f:
                img = decode_png(f.read())
            m = re.search(r"render: ([0-9.]+)s .* -> ([0-9.]+) Mrays/s", text[0])
            print(f"example-trace[{label}] {size}x{size} {extra[1]} spp {bounces} bounces: "
                  f"rc={rc} render_s={m and m.group(1)} mrays_per_s={m and m.group(2)} "
                  f"peak_mem_bytes={peak} png={img.shape} "
                  f"spread={float(np.asarray(img, np.float32).std()):.3f} "
                  f"launches {json.dumps(launches)} on {card}")
            check(rc == 0 and m is not None and img.shape == (size, size, 3),
                  f"example-trace[{label}] wrote no image")
            routed = launches.get("sweep", 0) + launches.get("bvh8_intersect", 0)
            check(routed > 0 and launches.get("sweep", 0) == launches.get("slab_entry", 0),
                  f"example-trace[{label}]: launches {launches}")
    return total


def example_trace_scene(device):
    """The trace example's scene and camera (its default arguments)."""
    from sailor_tpu_torch.examples import trace

    args = trace.parse_args([])
    return (trace.build_scene(args, device), *trace.camera(args, device))


def _editor_request(port, method, path, body=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def _wait_frames(app, n, limit_s):
    """Waits until the editor's loop has encoded ``n`` frames; returns the
    PNG bytes and the ms waited."""
    t0 = time.perf_counter()
    while app.frame_png()[0] < n:
        check(time.perf_counter() - t0 < limit_s, f"the editor rendered no frame {n}")
        time.sleep(0.01)
    return app.frame_png()[1], (time.perf_counter() - t0) * 1e3


EDITOR_SIZE = (1920, 1088)


def editor_setup(folder, width, height, num_lights, num_objects, map_size, device):
    """An EditorServer over material_world_doc (camera still) with the
    MaterialLibrary of MATERIAL_FILES and balls_glb in ``folder`` as its
    registry's content, started on a Renderer with editor_web's config.
    Returns (editor, library, .mat paths)."""
    from sailor_tpu_torch.__main__ import SUN_DIRECTION
    from sailor_tpu_torch.assets.materials import MaterialLibrary
    from sailor_tpu_torch.assets.registry import AssetRegistry
    from sailor_tpu_torch.engine import World
    from sailor_tpu_torch.engine.app import Renderer
    from sailor_tpu_torch.engine.editor_server import EditorServer
    from sailor_tpu_torch.engine.editor_web import EDITOR_CONFIG
    from sailor_tpu_torch.kernels.sky import SkyParams
    from sailor_tpu_torch.scenes import procedural_test_maps

    paths = material_folder(folder, map_size)
    with open(os.path.join(folder, "balls.glb"), "wb") as f:
        f.write(balls_glb(procedural_test_maps(0, map_size), 12, 24))
    reg = AssetRegistry(folder)
    reg.scan_content_folder()
    lib = MaterialLibrary(reg, paths, texture_size=map_size, mips=True, device=device)
    editor = EditorServer()
    editor.world = World.deserialize(
        material_world_doc(num_lights, num_objects, width / height, orbit=False), device=device)
    editor.world.materials = lib
    editor.registry = reg
    editor.start(Renderer(RENDERER, width, height, config=dict(EDITOR_CONFIG), device=device),
                 sky=SkyParams.default(sun_direction=SUN_DIRECTION))
    return editor, lib, paths


def run_editor_material_edit(card, width=EDITOR_SIZE[0], height=EDITOR_SIZE[1],
                             device="cuda"):
    """editor-material-edit: an EditorServer over the material world
    (material_world_doc(1000, 96), the camera still, 8 .mat files in a
    MaterialLibrary) on a Renderer at 1920x1088 with editor_web's config,
    served by EditorWebApp on 127.0.0.1:0 with its render loop: GET /,
    /api/world, /api/content and /api/asset (a PNG map, the GLB, a .mat),
    POST /api/update (an object moved), then POST /api/asset/update
    (paint.mat's albedo turned green) and /api/frame.png polled until a
    frame rendered after the edit: the edited material's pixels (by the
    frame's TriId, as ``edited_pixels``) changed, decoded with the port's
    decoder. Ticks, ms a tick, ms from the edit to the frame; the loop
    and server stopped; no failed tick; then one more tick with every B1
    and B2 launch (the alpha peels' too) held to its twin
    (``twin_checked``); a profiled tick on the card. Returns the launches,
    the held tick's included."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from sailor_tpu_torch.engine.editor_web import EditorWebApp
    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.utils.png import decode_png

    n_lights, n_objects = FLAGSHIP[2], FLAGSHIP[3]
    with tempfile.TemporaryDirectory() as folder:
        editor, lib, paths = editor_setup(folder, width, height, n_lights, n_objects, 256,
                                          device)
        editor.get_messages(1 << 20)
        ticks, last_tid = [], []
        inner = editor.tick

        def tick(dt):
            t0 = time.perf_counter()
            out = inner(dt)
            if device == "cuda":
                torch.cuda.synchronize()
            ticks.append((time.perf_counter() - t0) * 1e3)
            last_tid[:] = [out["TriId"]]
            return out

        editor.tick = tick
        app = EditorWebApp(editor)
        server = app.make_server("127.0.0.1", 0)
        port = server.server_address[1]
        serving = threading.Thread(target=server.serve_forever, daemon=True)
        before = dict(cuda_lib.LAUNCHES)
        serving.start()
        app.start_loop()
        try:
            _wait_frames(app, 1, 600)
            replies = {}
            for label, path in (("page", "/"), ("world", "/api/world"),
                                ("content", "/api/content"),
                                ("texture", f"/api/asset?path={folder}/albedo.png"),
                                ("model", f"/api/asset?path={folder}/balls.glb"),
                                ("material", f"/api/asset?path={paths[EDITED]}")):
                status, ctype, body = _editor_request(port, "GET", path)
                replies[label] = [status, ctype, len(body)]
                check(status == 200, f"editor: GET {path} answered {status}")
            world = json.loads(_editor_request(port, "GET", "/api/world")[2])
            moved = next(o for o in world["objects"] if o["name"].startswith("Object"))
            status, _, body = _editor_request(port, "POST",
                                              f"/api/update?id={moved['instance_id']}",
                                              b"position: [0.0, 3.0, 0.0]\n")
            check(status == 200 and json.loads(body)["ok"], "editor: /api/update failed")
            png_before, _ = _wait_frames(app, app.frame_png()[0] + 2, 600)
            n_before = app.frame_png()[0]
            t_edit = time.perf_counter()
            status, _, body = _editor_request(
                port, "POST", f"/api/asset/update?path={paths[EDITED]}",
                f"uniformsVec4:\n  material.albedo: {EDITED_ALBEDO[1]}\n".encode())
            edit_ms = (time.perf_counter() - t_edit) * 1e3
            check(status == 200 and json.loads(body)["ok"] and lib.version == 2,
                  "editor: /api/asset/update did not rebuild the library")
            n_after = app.frame_png()[0] + 2  # a frame in its encode may predate the edit
            while True:
                status, _, png_after = _editor_request(port, "GET", "/api/frame.png")
                if app.frame_png()[0] >= n_after:
                    status, _, png_after = _editor_request(port, "GET", "/api/frame.png")
                    break
                check((time.perf_counter() - t_edit) < 600, "editor: no frame after the edit")
                time.sleep(0.01)
            to_frame_ms = (time.perf_counter() - t_edit) * 1e3
        finally:
            app.stop_loop()
            server.shutdown()
            server.server_close()
            serving.join(60)
        record, b0 = {}, dict(cuda_lib.LAUNCHES)
        with twin_checked(record):
            inner(0.1)
            if device == "cuda":
                torch.cuda.synchronize()
        held = _launch_delta(b0)
        launches = _launch_delta(before)
        failed = [m for m in editor.get_messages(1 << 20) if "EditorWeb: tick failed" in m]
        check(not serving.is_alive(), "editor: the server thread did not stop")
        check(not failed, f"editor: {failed[:3]}")
        a, b = (decode_png(p).astype(np.int32) for p in (png_before, png_after))
        edited = edited_pixels(editor.world, last_tid[0], EDITED).cpu().numpy()
        changed = np.abs(b - a).max(-1) > 0
        share = float(changed[edited].mean()) if edited.any() else 0.0
        steady = ticks[1:] or ticks
        print(f"editor-material-edit {width}x{height}: ticks={len(ticks)} "
              f"ms_a_tick_first={ticks[0]:.3f} ms_a_tick_median={float(np.median(steady)):.3f} "
              f"edit_request_ms={edit_ms:.3f} edit_to_frame_ms={to_frame_ms:.3f} "
              f"frames_before_edit={n_before} edited_pixels={int(edited.sum())} "
              f"edited_changed={share:.4f} png={b.shape} launches {json.dumps(launches)} "
              f"on {card}")
        print("editor-material-edit replies " + json.dumps(replies))
        print("editor-material-edit twin_checked_ticks=1 launches " + json.dumps(held)
              + " launches_held " + json.dumps({k: len(v) for k, v in record.items()})
              + " max_abs_err " + json.dumps({k: max(v) for k, v in record.items()})
              + f" on {card}")
        for k in ("raster_worklist", "resolve_worklist"):
            check(held.get(k, 0) > 0 and len(record.get(k, ())) == held[k],
                  f"editor-material-edit: {k} was not held to its twin on every launch")
        check(held.get("resolve_worklist_alpha", 0) > 0,
              "editor-material-edit: the held tick ran no alpha peel")
        check(b.shape == (height, width, 3), "editor: the frame PNG has another size")
        check(edited.mean() > 1e-4 and share > 0.9,
              "editor-material-edit: the edit did not reach the next frame")
        for k in ("raster_worklist", "resolve_worklist"):  # the config shades plainly
            check(launches.get(k, 0) >= len(ticks),
                  f"editor-material-edit: {k} launched {launches.get(k, 0)} times")
        if device == "cuda":
            profile(lambda: inner(0.1), card, "profile_editor_tick")
        editor.shutdown()
    return launches


def assets_equal(a, b) -> bool:
    """Two loaded assets equal: arrays element for element, dicts, lists
    and objects (by their attributes) recursively, the rest by ==."""
    import numpy as np

    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(assets_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(assets_equal(x, y) for x, y in zip(a, b))
    if hasattr(a, "__dict__"):
        return assets_equal(vars(a), vars(b))
    return a == b


def run_host_runtime(card):
    """host-runtime: the five ``<suite>.benchmark`` console commands on the
    card (all PASSED; bvh launches the BVH8 kernel), ``stats.memory`` with
    the native multipool line, then the GLB, its PNG maps and the 8 .mat
    files loaded with ``load_async`` (all submitted, then waited) beside
    the synchronous loads on a second registry: equal outputs, host ms
    both ways. Returns the launches."""
    import tempfile

    from sailor_tpu_torch.assets.registry import AssetRegistry, load_async
    from sailor_tpu_torch.engine import World
    from sailor_tpu_torch.engine.console import Console
    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.scenes import procedural_test_maps
    from sailor_tpu_torch.utils import benchmarks

    console = Console(world=World(device="cuda"))
    before = dict(cuda_lib.LAUNCHES)
    for name in benchmarks.ALL:
        b0 = dict(cuda_lib.LAUNCHES)
        line = console.execute(f"{name}.benchmark")
        print(f"host-runtime {line} launches {json.dumps(_launch_delta(b0))}")
        check(f"{name}.benchmark PASSED" in line, f"host-runtime: {line}")
    launches = _launch_delta(before)
    check(launches.get("bvh8_intersect", 0) > 0, "bvh.benchmark launched no BVH8 kernel")
    mem = console.execute("stats.memory")
    print("host-runtime stats.memory: " + " | ".join(mem.splitlines()))
    check(mem.startswith(str(console.world.device)) and "native multipool:" in mem,
          "stats.memory lacks a line")

    with tempfile.TemporaryDirectory() as folder:
        paths = material_folder(folder, 256)
        with open(os.path.join(folder, "balls.glb"), "wb") as f:
            f.write(balls_glb(procedural_test_maps(0, 256)))
        files = [os.path.join(folder, n) for n in ("balls.glb", "albedo.png", "normal.png",
                                                   "stripes.png")] + paths
        regs = [AssetRegistry(folder), AssetRegistry(folder)]
        for r in regs:
            r.scan_content_folder()
        t0 = time.perf_counter()
        sync = [regs[0].load(p) for p in files]
        sync_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        handles = [load_async(regs[1], p) for p in files]
        asyn = [h.wait(300) for h in handles]
        async_ms = (time.perf_counter() - t0) * 1e3
        equal = [assets_equal(a, b) for a, b in zip(sync, asyn)]
        print(f"host-runtime load_async: {len(files)} files sync_ms={sync_ms:.3f} "
              f"async_ms={async_ms:.3f} equal={sum(equal)}/{len(files)} on {card}")
        check(all(equal), "load_async gave another asset than load")
    return launches


# --- phase 19: multi-device rendering (sailor_tpu_torch.parallel) -----------------

SHARDED = (1920, 1088, 2)  # width, height, shards of process_sharded and the forward frame
SHARDED_FRAMES = 3  # timed sharded frames after the warm-up
SHARDED_TRACE = (512, 512, 4, 4, 2)  # width, height, shards, spp, bounces


@contextlib.contextmanager
def shard_threads(names, seen):
    """While open, every call of the wrappers ``names`` ((module, attr)
    pairs) adds the calling thread's name to ``seen[attr]``."""
    import threading

    saved = []
    for mod, attr in names:
        inner = getattr(mod, attr)

        def call(*a, _inner=inner, _attr=attr, **kw):
            seen.setdefault(_attr, set()).add(threading.current_thread().name)
            return _inner(*a, **kw)

        saved.append((mod, attr, inner))
        setattr(mod, attr, call)
    try:
        yield seen
    finally:
        for mod, attr, inner in saved:
            setattr(mod, attr, inner)


def run_sharded_frames(scene, card):
    """sharded[full]: the flagship scene through all of
    DefaultRenderer.renderer (``FULL_CONFIG``) split over 2 row shards of
    one card (``make_mesh(2)``: both on cuda:0, each shard in its thread on
    its own stream), 1 warm-up + 3 frames with the state threaded through:
    frame ms, launches per frame (B1 3 a shard on the dirty warm-up, its
    depth and its 2 cascades, 1 cached; B2 and B3 once a shard). One more
    dirty frame with every B1, B2 and B3 launch of both shards held to its
    plain twin (``twin_checked``; shard 1's B1 on its row-shifted setup),
    its Main and Final against the unsharded frame of the same state on
    the card (Final within 2/255, Main within 1e-3 * (1 + |unsharded|);
    the differences printed); peak memory. Returns the launches of the
    warm-up and the 3 frames."""
    import torch

    from sailor_tpu_torch.kernels import cuda_lib, pbr_kernel
    from sailor_tpu_torch.parallel import make_mesh
    from sailor_tpu_torch.raster import tile_raster as tr

    width, height, n = SHARDED
    mesh = make_mesh(n)
    print(f"sharded mesh: {n} shards on {mesh.placement()} (device_count="
          f"{torch.cuda.device_count()})")
    fg = _full_graph(width, height)
    state = fg.initial_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, per_frame, total = [], [], {}
    for i in range(1 + SHARDED_FRAMES):
        cuda_lib.LAUNCHES.clear()

        def frame():
            fg.prepare(scene, state)
            return fg.process_sharded(scene, state, mesh)

        ms, (targets, state) = _wall_ms(frame)
        launches = dict(cuda_lib.LAUNCHES)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        times.append(ms)
        per_frame.append(launches)
    peak = torch.cuda.max_memory_allocated()
    for i, launches in enumerate(per_frame):
        for name in PATH_KERNELS:
            want = n * (3 if (i == 0 and name == "raster_worklist") else 1)
            check(launches.get(name, 0) == want,
                  f"sharded[full] frame {i} launched {name} {launches.get(name, 0)} times, "
                  f"not {want}")
    final = targets["Final"]
    check(tuple(final.shape) == (height, width, 3), f"sharded[full]: Final has shape {final.shape}")
    check(bool(torch.isfinite(final).all()) and final.min().item() >= 0.0
          and final.max().item() <= 1.0, "sharded[full]: Final is not finite in [0, 1]")

    # one dirty frame (a fresh state) with every kernel launch held to its twin
    fresh = fg.initial_state()
    fg.prepare(scene, fresh)
    record, seen = {}, {}
    wrappers = ((tr, "rasterize_worklist_cuda"), (tr, "resolve_worklist_cuda"),
                (pbr_kernel, "shade_tiles_cuda"))
    with twin_checked(record), shard_threads(wrappers, seen):
        checked, _ = fg.process_sharded(scene, dict(fresh), mesh)
    for name in PATH_KERNELS:
        check(len(record.get(name, [])) >= n, f"sharded[full]: {name} was not twin-checked "
              "on every shard")
    for _, attr in wrappers:
        check(seen.get(attr) == {f"shard-{i}" for i in range(n)},
              f"sharded[full]: {attr} ran on {sorted(seen.get(attr, ()))}")
    fg1 = _full_graph(width, height)
    st1 = fg1.initial_state()
    fg1.prepare(scene, st1)
    single, _ = fg1.process(scene, st1)
    d_main = (checked["Main"] - single["Main"]).abs()
    d_final = (checked["Final"] - single["Final"]).abs()
    main_ok = bool((d_main <= 1e-3 * (1 + single["Main"].abs())).all())
    print(f"sharded[full] {width}x{height} x{n}: warmup_dirty_ms={times[0]:.3f} "
          f"cached_frame_ms={[round(m, 3) for m in times[1:]]} "
          f"cached_mean_ms={sum(times[1:]) / SHARDED_FRAMES:.3f} peak_mem_bytes={peak} on {card}")
    print("sharded[full] launches_per_frame " + json.dumps(per_frame))
    print("sharded[full] twin_max_abs_err " + json.dumps(
        {k: max(v) for k, v in record.items()}) + " launches_checked "
        + json.dumps({k: len(v) for k, v in record.items()}))
    print(f"sharded[full] vs unsharded on the card: main_max_abs={d_main.max().item():.3g} "
          f"main_pixels_differ={int((d_main.amax(-1) > 0).sum())} "
          f"final_max_abs={d_final.max().item():.3g} "
          f"final_pixels_differ={int((d_final.amax(-1) > 0).sum())}")
    check(main_ok and d_final.max().item() <= 2 / 255,
          "sharded[full]: the sharded frame disagrees with the unsharded one")
    return total


def run_sharded_forward(scene, card):
    """sharded-forward: ``sharded_forward_frame`` at 1920x1088 over 2
    shards of the card (bin capacity 256, one round), B9 a pass a shard:
    frame ms of 3 frames after a warm-up, BinOverflow a shard, every B9
    launch of one frame held bit-equal to its twin, and the frame against
    the same function over 1 shard (printed with its BinOverflow; the
    slices' tile rows start at other rows, so the two drop other
    candidates where they overflow; Final within 2/255 where neither
    overflowed). Returns the launches of the 4 frames."""
    import torch

    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.parallel import make_mesh, sharded_forward_frame
    from sailor_tpu_torch.raster import tile_raster as tr

    width, height, n = SHARDED
    mesh = make_mesh(n)
    times, total, stats = [], {}, {}
    for _ in range(4):
        cuda_lib.LAUNCHES.clear()
        ms, ldr = _wall_ms(lambda: sharded_forward_frame(scene, width=width, height=height,
                                                         mesh=mesh, stats=stats))
        times.append(ms)
        for k, v in cuda_lib.LAUNCHES.items():
            total[k] = total.get(k, 0) + v
    check(total.get("raster_dense", 0) >= 4 * n, "sharded-forward: B9 was not launched a shard")
    errs, seen = [], {}
    inner = tr.rasterize_tiles_cuda

    def held(*a, **kw):
        out = inner(*a, **kw)
        plain = tr.rasterize_tiles_plain(*a, **kw)
        same = all(bool(torch.equal(x, y)) for x, y in zip(out, plain))
        check(same, "sharded-forward: B9 disagrees with its plain version")
        errs.append((out[0] - plain[0]).abs().max().item())
        return out

    tr.rasterize_tiles_cuda = held
    try:
        with shard_threads(((tr, "rasterize_tiles_cuda"),), seen):
            sharded_forward_frame(scene, width=width, height=height, mesh=mesh)
    finally:
        tr.rasterize_tiles_cuda = inner
    check(seen.get("rasterize_tiles_cuda") == {f"shard-{i}" for i in range(n)},
          "sharded-forward: B9 did not run on every shard")
    one_stats = {}
    one = sharded_forward_frame(scene, width=width, height=height, mesh=make_mesh(1),
                                stats=one_stats)
    diff = (ldr - one).abs()
    check(tuple(ldr.shape) == (height, width, 3) and bool(torch.isfinite(ldr).all()),
          "sharded-forward: the frame is not finite")
    print(f"sharded-forward {width}x{height} x{n}: frame_ms={[round(m, 3) for m in times]} "
          f"bin_overflow={stats['bin_overflow']} bin_overflow_1_shard="
          f"{one_stats['bin_overflow']} b9_launches_checked={len(errs)} "
          f"b9_twin_max_abs_err={max(errs)} vs_1_shard_max_abs={diff.max().item():.3g} "
          f"pixels_differ={int((diff.amax(-1) > 0).sum())} on {card}")
    if sum(stats["bin_overflow"]) == 0:
        check(diff.max().item() <= 2 / 255, "sharded-forward: 2 shards disagree with 1")
    return total


def run_sharded_trace(card):
    """sharded-trace: ``sharded_path_trace`` of the bench tracer scene
    (the sweep: B4 and B5) at 512x512 over 4 shards of the card, 4 spp, 2
    bounces, caller uniforms: ms of 2 runs after a warm-up, and the image
    bit-equal to ``trace_rays`` on all the rays with the same uniforms
    (timed too). Returns the launches of the 3 sharded runs."""
    import torch

    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.parallel import make_mesh, mesh as mesh_mod
    from sailor_tpu_torch.raytracing import path_tracer
    from sailor_tpu_torch.scenes import tracer_scene

    w, h, n, spp, bounces = SHARDED_TRACE
    scene, cam, view, proj = tracer_scene(tracer="sweep")
    u = torch.rand((spp, 5 * bounces, w * h), generator=torch.Generator().manual_seed(11)).cuda()
    mesh = make_mesh(n)
    times, total = [], {}
    for _ in range(3):
        cuda_lib.LAUNCHES.clear()
        ms, img = _wall_ms(lambda: mesh_mod.sharded_path_trace(
            scene, cam, view, proj, width=w, height=h, mesh=mesh, spp=spp,
            max_bounces=bounces, uniforms=u))
        times.append(ms)
        for k, v in cuda_lib.LAUNCHES.items():
            total[k] = total.get(k, 0) + v
    for name in ("slab_entry", "sweep"):
        check(total.get(name, 0) >= 3 * n, f"sharded-trace: {name} was not launched a shard")
    o, d = mesh_mod.global_rows_rays(cam, view, proj, width=w, rows=range(h), height=h)
    ms1, (ref, _) = _wall_ms(lambda: path_tracer.trace_rays(scene, o, d, spp=spp,
                                                            max_bounces=bounces, uniforms=u))
    ref = ref.reshape(h, w, 3)
    diff = (img - ref).abs()
    print(f"sharded-trace {w}x{h} x{n} spp={spp} bounces={bounces}: "
          f"sharded_ms={[round(m, 3) for m in times]} unsharded_ms={ms1:.3f} "
          f"bit_equal={bool(torch.equal(img, ref))} max_abs={diff.max().item():.3g} "
          f"pixels_differ={int((diff.amax(-1) > 0).sum())} launches={json.dumps(total)} on {card}")
    check(bool(torch.isfinite(img).all()) and img.mean().item() > 0.0,
          "sharded-trace: the image is empty or not finite")
    check(bool(torch.equal(img, ref)), "sharded-trace: the sharded image differs from trace_rays")
    return total


def check_small_sharded_frame():
    """A 128x256 DefaultRenderer frame (``FULL_CONFIG``, shadow_resolution
    128) over 8 shards of the card against the same 8-shard frame on the
    CPU path (which the CPU tests hold to the JAX package's process_sharded),
    one dirty frame (the card's phase above threads the state): Depth and
    TriId exact, the CSM maps exact, Main within 1e-4 relative (to
    max(|cpu|, 1e-3)) on >= 99.5% of pixels, Final within 2/255 on every
    pixel."""
    import torch

    from sailor_tpu_torch.parallel import make_mesh
    from sailor_tpu_torch.scenes import flagship_scene

    out = {}
    for dev in ("cuda", "cpu"):
        scene = flagship_scene(128, 256, 24, 10, device=dev)
        fg = _full_graph(128, 256, dev, dict(FULL_CONFIG, shadow_resolution=128))
        mesh = make_mesh(8, device=dev)
        state = fg.initial_state()
        fg.prepare(scene, state)
        t, state = fg.process_sharded(scene, state, mesh, extra_outputs=("Depth", "TriId"))
        out[dev] = {**{k: t[k].cpu() for k in ("Main", "Final", "Depth", "TriId")},
                    "csm": state["csm/maps"].cpu()}
    g, r = out["cuda"], out["cpu"]
    exact = {k: bool(torch.equal(g[k], r[k])) for k in ("Depth", "TriId", "csm")}
    rel = ((g["Main"] - r["Main"]).abs() / r["Main"].abs().clamp(min=1e-3)).amax(-1)
    main = (rel <= 1e-4).float().mean().item()
    final = (g["Final"] - r["Final"]).abs().max().item()
    print("small sharded[full] x8 card vs cpu: "
          + " ".join(f"{k}_equal={v}" for k, v in exact.items())
          + f" main_within_1e-4={main:.5f} final_max_err={final:.3g}")
    check(all(exact.values()) and main >= 0.995 and final <= 2 / 255,
          "card sharded frame disagrees with the CPU path")


def run_tools(card):
    """tools: ``sailor_tpu_torch.tools.time_sweep --size 256 --k 5`` and
    ``profile_trace --small`` on the card (B4 and B5), ``time_hiz`` at
    1920x1088 with TH_CUBES=200, TH_LIGHTS=100, TH_FRAMES=1 and
    ``profile_frame --small --frames 2`` (B1-B3), in process (their
    ``main``; the CPU tests run them as ``python -m``), their lines
    printed; each must return 0."""
    import io

    from sailor_tpu_torch.tools import profile_frame, profile_trace, time_hiz, time_sweep

    small_hiz = {"TH_CUBES": "200", "TH_LIGHTS": "100", "TH_FRAMES": "1"}
    for mod, args, env in ((time_sweep, ["--size", "256", "--k", "5"], {}),
                           (profile_trace, ["--small"], {}),
                           (time_hiz, [], small_hiz),
                           (profile_frame, ["--small", "--frames", "2"], {})):
        t0 = time.perf_counter()
        out, err = io.StringIO(), io.StringIO()
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = mod.main(args)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        check(rc == 0, f"{mod.__name__} returned {rc}: {err.getvalue()[-2000:]}")
        print(f"{mod.__name__} {' '.join(args)} ({time.perf_counter() - t0:.1f} s, {card}):")
        for line in err.getvalue().strip().splitlines()[-1:] + out.getvalue().strip().splitlines():
            print("  " + line)


def check_image_decoders():
    """decoders: a BMP (BI_RLE8 and 32-bit bit fields with alpha), a TGA
    (RLE true colour, 16-bit A1R5G5B5 with a top-left origin), a Radiance
    HDR (new RLE scanlines), a GIF (local palette, interlaced, a
    transparency index, the deferred clear) and an Adam7 RGBA PNG written
    by this script (tests/torch_image_files.py, torch_asset_files.py),
    read back through ``textures.imread`` and held to the arrays they were
    written from, exactly; and a JPEG of ``jpeg_bytes`` (37x53) whose C++
    decode is held to the plain Python decoder's, bit for bit."""
    import tempfile

    import numpy as np

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_asset_files
    import torch_image_files as files

    from sailor_tpu_torch.assets import textures
    from sailor_tpu_torch.utils import jpeg

    rng = np.random.default_rng(19)
    h, w = 24, 40
    idx = rng.integers(0, 60, (h, w)).astype(np.uint8)
    idx[5, 3:30] = 7
    pal = rng.integers(0, 256, (60, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    px16 = rng.integers(0, 1 << 16, (h, w), dtype=np.uint16)
    le16 = np.stack([px16 & 255, px16 >> 8], -1).astype(np.uint8)
    c5 = lambda v: ((v & 31) * 255 // 31).astype(np.uint8)  # noqa: E731
    want16 = np.stack([c5(px16 >> 10), c5(px16 >> 5), c5(px16),
                       np.where(px16 & 0x8000, 0, 255).astype(np.uint8)], -1)
    rgb = (rng.uniform(0, 1, (h, w, 3)) ** 3 * np.array([30.0, 2.0, 0.1])).astype(np.float32)
    rgbe = files.rgbe(rgb)
    e = rgbe[..., 3].astype(np.int32)
    want_hdr = (rgbe[..., :3].astype(np.float32)
                * np.where(e > 0, np.ldexp(np.float32(1), e - 136), 0).astype(np.float32)[..., None])
    cases = {
        "rle8.bmp": (files.bmp(files.rle8(idx), w, h, 8, palette=pal, compression=1), pal[idx]),
        "bgra32.bmp": (files.bmp(files.bmp_rows(rgba[..., [2, 1, 0, 3]], 32), w, h, 32,
                                 compression=3, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                                 header=56), rgba),
        "rle32.tga": (files.tga(files.tga_rle(rgba[::-1, :, [2, 1, 0, 3]].reshape(-1, 4), w),
                                w, h, 32, 10), rgba),
        "top16.tga": (files.tga(le16.tobytes(), w, h, 16, 2, descriptor=0x20), want16),
        "sky.hdr": (files.hdr(rgbe, rle=True), want_hdr),
        "local.gif": (files.gif([{"indices": idx, "palette": pal[:64], "interlace": True}], w, h,
                                global_palette=pal[::-1][:64], transparency=7,
                                clear_when_full=False), pal[:64][idx]),
        "adam7.png": (torch_asset_files.png_bytes(rgba, 6, 8, filters=(0, 1, 2, 3, 4),
                                                  interlace=1), rgba),
    }
    with tempfile.TemporaryDirectory() as tmp:
        for name, (data, want) in cases.items():
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(data)
            got = textures.imread(path)
            check(got.dtype == want.dtype and got.shape == want.shape
                  and np.array_equal(got, want), f"decoders: {name} decodes wrongly")
            print(f"decoders: {name} {got.dtype} {got.shape} equal")
    data = jpeg_bytes(rng.integers(0, 256, (37, 53, 3), dtype=np.uint8))
    t0 = time.perf_counter()
    native = jpeg.decode_jpeg(data)
    t1 = time.perf_counter()
    plain = jpeg.decode_jpeg(data, plain=True)
    t2 = time.perf_counter()
    check(native.shape == (37, 53, 3) and np.array_equal(native, plain),
          "decoders: the C++ JPEG decode differs from the plain one")
    print(f"decoders: jpeg 37x53 C++ ({(t1 - t0) * 1e3:.3f} ms) equal to plain "
          f"({(t2 - t1) * 1e3:.3f} ms)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.scenes import dense_tracer_scene, flagship_queue_scene, flagship_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    parent_build = start_thread_per_ray_build()  # nvcc beside the port's
    cuda_lib.load()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for line in cuda_lib.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())
    thread_per_ray = thread_per_ray_kernel(parent_build)

    width, height, n_lights, n_objects = FLAGSHIP
    scene = flagship_scene(width, height, n_lights, n_objects)
    print(f"scene: {scene.geometry.indices.shape[0]} triangles, "
          f"{scene.lights.num} lights, {width}x{height}")
    t_kernels = time.perf_counter()
    kernels = check_kernels(scene, width, height, card)
    variants = check_variant_kernels(scene, width, height, card)
    config_launches = run_raster_configs(scene, width, height, card)
    run_rasterize(scene, width, height, card)
    print(f"kernels and raster configs: {time.perf_counter() - t_kernels:.1f} s")
    t_heights = time.perf_counter()
    height_rows, height_launches = run_raster_tile_heights(scene, width, height, card)
    print(f"raster-tile-heights: {time.perf_counter() - t_heights:.1f} s")
    t_frames = time.perf_counter()
    launches = run_frames(scene, width, height, card)  # profiles last: later frames run slower
    check_shadow_kernels(scene, width, height, card)
    shadow_launches = run_shadow_hiz_frames(scene, width, height, card)
    for name in ("raster_worklist", "resolve_worklist", "shade_forward_plus"):
        check(shadow_launches.get(name, 0) > 0, f"{name} was not launched on the shadow path")
    full_launches = run_full_frames(scene, width, height, card)
    for name in ("raster_worklist", "resolve_worklist", "shade_forward_plus"):
        check(full_launches.get(name, 0) > 0, f"{name} was not launched on the full frame")
    qscene = flagship_queue_scene(width, height, n_lights, n_objects)[0]
    queue_kernels = check_queue_kernels(qscene, width, height, card)
    queue_launches, grid_launches = run_queue_frames(qscene, width, height, card)
    for name in ("raster_worklist", "resolve_worklist", "resolve_worklist_alpha",
                 "shade_forward_plus"):
        check(queue_launches.get(name, 0) > 0, f"{name} was not launched on the queue frame")
    del qscene
    queue_path = {"raster_worklist[two_sided_peel]":
                  queue_launches["raster_worklist[two_sided_peel]"],
                  "resolve_worklist[49]": (queue_launches["resolve_worklist"]
                                           - queue_launches["resolve_worklist_alpha"]),
                  "resolve_worklist[alpha]": queue_launches["resolve_worklist_alpha"],
                  "resolve_stream[49]": grid_launches.get("resolve_stream", 0)}
    for k in queue_kernels:
        k["launches"] = queue_path[k["name"]]
    for k in kernels:  # the launches of the frame, content and material paths
        k["launches"] = launches.get(k["name"], 0)
    for k in variants:
        config = {"raster_stream": "stream", "raster_stream_mxu": "stream_mxu",
                  "raster_dma": "dma", "raster_dense": "dense",
                  "resolve_stream": "stream"}[k["name"]]
        k["launches"] = config_launches[config].get(k["name"], 0)
    kernels += variants + queue_kernels
    for k in kernels:  # B1, B2, B7-B10 at the other tile heights
        if k["name"] in height_rows:
            k["tileheights"] = height_rows[k["name"]]
            k["launches"] += height_launches.get(k["name"], 0)
    main_frame = kernels[:3]
    check_small_frame()
    for change in RASTER_CONFIGS.values():
        check_small_frame(change)
    check_small_shadow_frame()
    check_culled_frame()
    check_small_full_frame()
    check_small_queue_frame()
    print(f"frames and queues: {time.perf_counter() - t_frames:.1f} s")
    del scene
    t_engine = time.perf_counter()
    run_engine_editor(card)
    run_engine_flagship(card)
    check_small_engine()
    check_engine_lost_device(card)
    print(f"engine: {time.perf_counter() - t_engine:.1f} s")
    t_night = time.perf_counter()
    night_launches = run_engine_night(card)
    for name in PATH_KERNELS:
        check(night_launches.get(name, 0) > 0, f"{name} was not launched on the night frame")
    print("engine-night-hud launches_frames_1_6 " + json.dumps(
        {k: night_launches.get(k, 0) for k in PATH_KERNELS}))
    check_small_night()
    print(f"night: {time.perf_counter() - t_night:.1f} s")
    t_content = time.perf_counter()
    content_launches = run_content_glb(card)
    material_launches = run_engine_materials(card)
    for name in PATH_KERNELS:
        check(content_launches.get(name, 0) > 0 and material_launches.get(name, 0) > 0,
              f"{name} was not launched on the content and material paths")
    check_small_content()
    check_small_engine_materials()
    print(f"content: {time.perf_counter() - t_content:.1f} s")
    t_jpeg = time.perf_counter()
    jpeg_launches = run_content_jpeg(card)
    check_small_content_jpeg()
    hiz_launches = run_hiz_heavy(card)
    for name in PATH_KERNELS:
        check(jpeg_launches.get(name, 0) > 0 and hiz_launches.get(name, 0) > 0,
              f"{name} was not launched on the JPEG content and hiz-heavy paths")
    print(f"content-jpeg-full and hiz-heavy: {time.perf_counter() - t_jpeg:.1f} s")
    t_codings = time.perf_counter()
    coding_launches = run_content_jpeg_codings(card)
    for name in PATH_KERNELS:
        check(coding_launches.get(name, 0) > 0,
              f"{name} was not launched on the content-jpeg-codings path")
    print(f"content-jpeg-codings: {time.perf_counter() - t_codings:.1f} s")
    t_examples = time.perf_counter()
    example_launches = run_example_frame(card)
    check_small_example_frame()
    editor_launches = run_editor_material_edit(card)
    print(f"example-frame and editor: {time.perf_counter() - t_examples:.1f} s")
    for k in main_frame:  # B1-B3 rows: the frame's launches and the later paths'
        k["launches"] += sum(p.get(k["name"], 0) for p in (
            content_launches, material_launches, jpeg_launches, hiz_launches, coding_launches,
            example_launches, editor_launches))
    t_tracer = time.perf_counter()
    tracer_kernels = check_tracer_kernels(card)
    launches, tracer_peak = run_tracer(card)
    check_small_trace()
    glb_launches = run_content_trace(card)
    for name in ("slab_entry", "sweep"):
        launches[name] = launches.get(name, 0) + glb_launches.get(name, 0)
    check_small_trace(small_glb_trace, "content_glb_trace")
    jpeg_trace_launches = run_content_jpeg_trace(card)
    for name in ("slab_entry", "sweep"):
        launches[name] = launches.get(name, 0) + jpeg_trace_launches.get(name, 0)
    launches["sweep_grid"] = run_tracer_grid(card).get("sweep_grid", 0)  # B6's main path
    run_material_balls(card)
    check_small_trace(textured_sky_balls, "balls_textured_sky")
    check_small_trace(label="tracer_grid", grid=True)
    bvh8_row, bvh8_launches = run_bvh8_cells(card, tracer_peak, thread_per_ray)
    bvh8_kernels = [bvh8_row]
    launches["bvh8_intersect"] = bvh8_launches.get("bvh8_intersect", 0)
    check_small_trace(dense_tracer_scene, "tracer_dense_bvh8")
    print(f"tracer: {time.perf_counter() - t_tracer:.1f} s")
    t_clusters = time.perf_counter()
    cluster_rows, cluster_launches = run_sweep_clusters(card)
    for name in ("slab_entry", "sweep"):
        launches[name] = launches.get(name, 0) + cluster_launches.get(name, 0)
    for k in tracer_kernels:  # B4-B6 at each cluster size
        k["clusters"] = cluster_rows[k["name"]]
    print(f"sweep-clusters: {time.perf_counter() - t_clusters:.1f} s")
    t_rayblocks = time.perf_counter()
    rayblock_rows, rayblock_launches = run_sweep_rayblocks(card)
    for name in ("slab_entry", "sweep"):
        launches[name] = launches.get(name, 0) + rayblock_launches.get(name, 0)
    for k in tracer_kernels:  # B4-B6 at each (RAY_BLOCK, SUB) pair
        k["rayblocks"] = rayblock_rows[k["name"]]
    print(f"sweep-rayblocks: {time.perf_counter() - t_rayblocks:.1f} s")
    t_host = time.perf_counter()
    example_trace_launches = run_example_trace(card)
    check_small_trace(example_trace_scene, "example_trace")
    host_launches = run_host_runtime(card)
    print(f"example-trace and host-runtime: {time.perf_counter() - t_host:.1f} s")
    t_sharded = time.perf_counter()
    scene = flagship_scene(width, height, n_lights, n_objects)
    sharded_launches = run_sharded_frames(scene, card)
    forward_launches = run_sharded_forward(scene, card)
    del scene
    sharded_trace_launches = run_sharded_trace(card)
    check_small_sharded_frame()
    for k in main_frame:
        k["launches"] += sharded_launches.get(k["name"], 0)
    for k in variants:
        k["launches"] += forward_launches.get(k["name"], 0)
    print(f"sharded: {time.perf_counter() - t_sharded:.1f} s")
    t_tools = time.perf_counter()
    run_tools(card)
    check_image_decoders()
    print(f"tools and decoders: {time.perf_counter() - t_tools:.1f} s")
    for name in ("slab_entry", "sweep", "bvh8_intersect"):
        launches[name] = (launches.get(name, 0) + example_trace_launches.get(name, 0)
                          + host_launches.get(name, 0) + sharded_trace_launches.get(name, 0))
    for k in tracer_kernels + bvh8_kernels:
        k["launches"] = launches.get(k["name"], 0)
        check(k["launches"] > 0, f"{k['name']} was not launched on its main path")
    kernels += tracer_kernels + bvh8_kernels
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(f"card: {card}")
    print(json.dumps({"kernels": [{k: r[k] for k in keys + ("clusters", "rayblocks", "tileheights")
                                   if k in r}
                                  for r in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
