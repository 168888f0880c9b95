"""Frame-graph nodes (counterpart of sailor_tpu/framegraph/nodes.py): those
of the visibility Forward+ frame, every entry of
content/DefaultRenderer.renderer (DepthPrepass with the HiZ cull,
LinearizeDepth, LightCulling, ShadowPrepass, Sky, Environment, DepthHighZ,
PostProcess (HBAO, HBAO_Blur, SunShafts, MotionBlur, ChromaticAberration,
Debug), RenderScene with the IBL ambient, RenderTransparent, DebugDraw,
Bloom, EyeAdaptation and RenderOverlay), and Clear, Blit,
CopyTextureToRam and Particles, which no shipped `.renderer` uses.

Data flows through the ``targets`` dict: "Depth", "TriId", "TriSetup",
"BinOverflow", "HiZCulledCount", "StreamBins" (the raster's bin windows,
consumed by RenderScene's fused resolve), "LinearDepth",
"LightIndices"/"LightCounts", "ShadowMaps", "LightMatrices", "EvsmMaps",
"EvsmMap", "Sky", "AO", "HiZ/mip1".."HiZ/mip4", "Main", "Final",
"readback" (CopyTextureToRam's list), and temporal state via "state_out"
(avg luminance, the CSM cache "csm/*", the sky cache "sky/*", the HiZ
pyramid "hiz/mip*", the particles' "particles/*"); the Environment node's
bake is published into the state in ``prepare`` ("env/*").

In a row shard (``RenderContext.sharded``, ``FrameGraph.process_sharded``)
the nodes work in the slice's rows and read across slices through
``ctx.comm``: DepthPrepass and RenderTransparent shift their setups into
the slice (``setup.shift_viewport_rows``), ShadowPrepass splits the
cascades over the shards and sums the tables, HBAO, its vertical blur,
MotionBlur, SunShafts, Bloom and EyeAdaptation exchange rows, tables or
histograms, and the upsamples are boundary-exact (``ctx.upsample``).
"""

from __future__ import annotations

import dataclasses

import torch

from sailor_tpu_torch import config as cfg
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.framegraph.graph import BaseNode, node
from sailor_tpu_torch.kernels import bloom as bloom_k
from sailor_tpu_torch.kernels import blur as blur_k
from sailor_tpu_torch.kernels import cubemap as cm
from sailor_tpu_torch.kernels import histogram as hist_k
from sailor_tpu_torch.kernels import ibl as ibl_k
from sailor_tpu_torch.kernels import light_culling, pbr, pbr_kernel, sampling
from sailor_tpu_torch.kernels import postprocess as pp
from sailor_tpu_torch.kernels import shadow as shadow_k
from sailor_tpu_torch.kernels import sky as sky_k
from sailor_tpu_torch.kernels import tonemap as tm
from sailor_tpu_torch.kernels.common import round_up
from sailor_tpu_torch.raster import hiz_cull, interpolate, pipeline
from sailor_tpu_torch.raster import setup as rsetup
from sailor_tpu_torch.raster import tile_raster


def inverse_view_projection(frame):
    """inv(projection @ view), the resolve's unprojection matrix, rounded
    as the reference's (``math3d.inverse``: the matrix is copied back to
    the host)."""
    return m3.inverse(frame.view_projection)


def _inv_vp(ctx):
    """The frame's inverse view-projection, computed once a frame and
    shared by the nodes that unproject (Sky, RenderScene, MotionBlur)."""
    if ctx._inv_vp is None:
        ctx._inv_vp = inverse_view_projection(ctx.scene.frame)
    return ctx._inv_vp


def light_matrices(scene, config):
    """The sun's cascade view-projections (C, 4, 4) on the scene's device,
    fitted on the host (``shadow.cascade_matrices``: the view and
    projection are copied back, a synchronise)."""
    frame = scene.frame
    mats = shadow_k.cascade_matrices(
        frame.view.cpu(), frame.projection.cpu(), scene.sky.sun_direction,
        float(config.get("z_near", 0.1)), float(config.get("z_far", 100.0)))
    return mats.to(frame.view.device)


def _make_raster(tri, valid, aabb, tiles_y, tiles_x, config, *, capacity,
                 rounds=1, attrs=None):
    """Build ``raster(z_bounds) -> (depth, tid)`` for the configured
    backend; returns (raster, overflow scalar (candidates a backend
    drops), stream_bins).

    ``raster_mode``:
      - "stream" (default): bin_sorted's ragged segments, through the
        work-list raster B1 (``raster_worklist``, default; no cap) or the
        grid-k raster B7 (each tile's first kmax windows of ``chunk``
        rows, kmax = ceil(capacity * rounds / chunk); ``raster_mxu``
        selects its MXU plane form);
      - "dma": bin_sorted's segments, each tile walking its exact window
        span (B8, no cap);
      - "dense": bin_all's fixed-capacity passes through B9 and the depth
        merge.
    ``attrs``: packed per-raster-triangle attributes; stream mode then
    builds ONE row table shared by the raster and the fused resolve and
    returns its bins for resolve_gbuffer_stream as ``stream_bins`` (None
    otherwise)."""
    tw, th = tile_raster.TILE_W, tile_raster.check_tile_h()
    mode = config.get("raster_mode", "stream")
    if mode == "dma":
        rb = rsetup.bin_sorted(valid, aabb, tiles_x=tiles_x, tiles_y=tiles_y,
                               tile_w=tw, tile_h=th)

        def raster(z_bounds=None):
            d, t, _ = tile_raster.rasterize_dma(
                tri, aabb, *rb[:5], tiles_y=tiles_y, tiles_x=tiles_x,
                z_bounds=z_bounds, dchunk=int(config.get("stream_chunk", 128)))
            return d, t

        return raster, rb[5], None  # no per-tile cap: only the big list drops
    if mode == "stream":
        worklist = bool(config.get("raster_worklist", True))
        chunk = int(config.get("stream_chunk", 128 if worklist else 256))
        # the resolve walks the same rows in bigger windows; pad to the lcm
        rchunk = int(config.get("resolve_chunk", max(chunk, 256)))
        if rchunk % chunk:
            raise ValueError("resolve_chunk must be a multiple of stream_chunk")
        kmax = max(1, -(-(capacity * rounds) // chunk))
        rb = rsetup.bin_sorted(valid, aabb, tiles_x=tiles_x, tiles_y=tiles_y,
                               tile_w=tw, tile_h=th)
        overflow = rb[5]
        if not worklist:
            overflow = overflow + tile_raster.stream_windows(rb[1], rb[2], chunk, kmax)[2]
        prebuilt = None
        if attrs is not None:
            rows, big_rows, na = tile_raster.build_stream_rows(
                tri, aabb, rb[0], rb[3], attrs=attrs,
                chunk=rchunk if worklist else chunk)
            prebuilt = (rows, big_rows)

        def raster(z_bounds=None):
            if worklist:
                d, t, _ = tile_raster.rasterize_worklist(
                    tri, aabb, *rb[:5], tiles_y=tiles_y, tiles_x=tiles_x,
                    z_bounds=z_bounds, chunk=chunk, prebuilt=prebuilt)
            else:
                d, t, _ = tile_raster.rasterize_stream(
                    tri, aabb, *rb[:5], tiles_y=tiles_y, tiles_x=tiles_x,
                    z_bounds=z_bounds, chunk=chunk, kmax=kmax,
                    prebuilt=prebuilt, mxu=bool(config.get("raster_mxu", False)))
            return d, t

        stream_bins = None
        if attrs is not None:
            stream_bins = {
                "rows": rows, "big_rows": big_rows, "starts": rb[1],
                "counts": rb[2], "n_big": rb[4], "na": na,
                "chunk": rchunk if worklist else chunk, "kmax": kmax,
                "worklist": worklist,
            }
        return raster, overflow, stream_bins

    passes, overflow = rsetup.bin_all(
        valid, aabb, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tw, tile_h=th,
        capacity=capacity, rounds=rounds)

    def raster(z_bounds=None):
        return pipeline.raster_merge(tri, passes, tiles_y, tiles_x,
                                     z_bounds=z_bounds, screen_aabb=aabb)

    return raster, overflow, None


def _queue_of_raster_tris(scene, tri):
    """Per-raster-triangle render queue (0 Opaque, 1 Masked, 2
    Transparent), or None when the scene has the opaque queue alone."""
    mats = scene.materials
    if mats is None or not (mats.has_masked or mats.has_transparent):
        return None
    return mats.queue[scene.geometry.material_id[tri.src_id.long()].long()]


def _packed_attrs(scene, tri, config):
    """The fused resolve's per-raster-triangle attributes (37 columns, 49
    with materials) on the fused stream path, else None: the scene's
    packed source table gathered by ``src_id``, packed here when the table
    is missing or of the other width."""
    if not (config.get("fused_resolve", True)
            and config.get("raster_mode", "stream") == "stream"):
        return None
    want = tile_raster.A_MAT if scene.materials is not None else tile_raster.A_BASE
    if scene.attrs_packed is not None and scene.attrs_packed.shape[1] == want:
        return scene.attrs_packed[tri.src_id.long()]
    return interpolate.pack_triangle_attributes(scene.geometry, tri.src_id, scene.materials)


def _into_slice(ctx, tri, aabb):
    """A setup against the whole viewport shifted into the shard's rows,
    with the triangles that miss the slice dropped, and its AABB in local
    rows (the identity on one device)."""
    if not ctx.sharded:
        return tri, aabb
    xmin, xmax, ymin, ymax = aabb
    h = ctx.height
    in_slice = (ymax >= ctx.row0) & (ymin < ctx.row0 + h)
    tri = dataclasses.replace(rsetup.shift_viewport_rows(tri, ctx.row0),
                              valid=tri.valid & in_slice)
    return tri, (xmin, xmax, ymin - ctx.row0, ymax - ctx.row0)


def _tiles(ctx):
    tw, th = tile_raster.TILE_W, tile_raster.check_tile_h()
    return round_up(ctx.height, th) // th, round_up(ctx.width, tw) // tw


@node("DepthPrepass")
class DepthPrepassNode(BaseNode):
    """Visibility raster: depth + triangle id (DepthPrepassNode.cpp) through
    the configured raster backend (``_make_raster``). With ``hiz_culling``
    (the default) and a pyramid in the state, opaque triangles that the
    previous frame's HiZ pyramid hides are dropped before the raster
    ("HiZCulledCount"). On the fused stream path the raster's bin windows
    and the combined row table are handed on to RenderScene's fused
    resolve ("StreamBins"); otherwise RenderScene gathers from "TriSetup".

    With a material table the opaque queue rasters first; the Masked queue
    then peels up to ``masked_layers`` (default 3) alpha-tested layers
    (Standard.shader's discard): each layer is the nearest masked fragment
    behind the last one peeled and in front of the depth so far, alpha-
    tested against its cutoff (``resolve_alpha_stream``, or
    ``resolve_alpha`` on the gather path), and the pixels that fail peel
    on. Where the reference skips a layer with ``lax.cond``, the port reads
    whether any pixel is undecided on the host, once a layer from the
    second on; a skipped layer would change nothing. "MaskedPeelLayers":
    the layers that ran; the masked queue's bins join "StreamBins".

    In a row shard the setup is made against the whole viewport, culled
    against the (full-height) pyramid in global rows, then shifted into
    the slice with the triangles that miss it dropped."""

    def process(self, ctx, targets):
        scene = ctx.scene
        geo = scene.geometry
        w, h = ctx.width, ctx.height
        tiles_y, tiles_x = _tiles(ctx)
        capacity = int(ctx.config.get("bin_capacity", 512))
        rounds = int(ctx.config.get("bin_rounds", 2))
        dense = ctx.config.get("raster_mode", "stream") not in ("stream", "dma")
        tri, aabb = rsetup.triangle_setup(
            geo, scene.frame.view_projection, width=w, height=ctx.fh, cull="back",
            zplane_rounding="standalone" if dense else "frame")
        aabb_full = aabb
        tri, aabb = _into_slice(ctx, tri, aabb)
        queue_of = _queue_of_raster_tris(scene, tri)
        valid = tri.valid if queue_of is None else tri.valid & (queue_of == 0)
        state = ctx.state or {}
        if ctx.config.get("hiz_culling", True) and "hiz/mip0" in state:
            # the reference's key order: sorted names
            mips = [state[k] for k in sorted(state) if k.startswith("hiz/mip")]
            flat, offsets, shapes = hiz_cull.build_flat_pyramid(mips)
            culled = hiz_cull.occlusion_cull(
                valid, aabb_full, tri.zmax, flat, offsets=offsets, shapes=shapes,
                base_w=w, base_h=ctx.fh)
            targets["HiZCulledCount"] = (valid & ~culled).sum(dtype=torch.int32)
            valid = culled
        attrs = _packed_attrs(scene, tri, ctx.config)
        raster, overflow, stream_bins = _make_raster(
            tri, valid, aabb, tiles_y, tiles_x, ctx.config,
            capacity=capacity, rounds=rounds, attrs=attrs)
        if stream_bins is not None:
            targets["StreamBins"] = [stream_bins]
        targets["BinOverflow"] = overflow
        depth, tid = raster()
        depth, tid = depth[:h, :w], tid[:h, :w]
        if queue_of is not None and scene.materials.has_masked:
            depth, tid = self._masked_peel(ctx, targets, tri, aabb, queue_of, attrs,
                                           depth, tid)
        targets["Depth"] = depth
        targets["TriId"] = tid
        targets["TriSetup"] = tri
        targets["TriAABB"] = aabb
        return targets

    @staticmethod
    def _masked_peel(ctx, targets, tri, aabb, queue_of, attrs, depth, tid):
        scene = ctx.scene
        mats = scene.materials
        w, h = ctx.width, ctx.height
        tiles_y, tiles_x = _tiles(ctx)
        raster_m, _, sb_m = _make_raster(
            tri, tri.valid & (queue_of == 1), aabb, tiles_y, tiles_x, ctx.config,
            capacity=int(ctx.config.get("bin_capacity", 512)), attrs=attrs)
        if sb_m is not None:
            targets["StreamBins"].append(sb_m)
        inv_vp = _inv_vp(ctx)
        cam = scene.frame.camera_position
        zhi = torch.full((h, w), 2.0, device=depth.device)
        undecided = torch.ones((h, w), dtype=torch.bool, device=depth.device)
        ran = 0
        for layer in range(int(ctx.config.get("masked_layers", 3))):
            if layer > 0 and not bool(undecided.any()):  # the host read
                break
            d_k, t_k = raster_m((depth, zhi))
            d_k, t_k = d_k[:h, :w], t_k[:h, :w]
            if sb_m is not None:
                alpha, cutoff = interpolate.resolve_alpha_stream(
                    sb_m, t_k, inv_vp, cam, mats, width=w, height=h, tiles_y=tiles_y,
                    tiles_x=tiles_x, full_height=ctx.full_height, row0=ctx.row0)
            else:
                alpha, cutoff = interpolate.resolve_alpha(
                    scene.geometry, tri, t_k, inv_vp, cam, mats, ctx.row0,
                    ctx.full_height)
            hit = t_k >= 0
            passed = hit & (alpha >= cutoff) & undecided
            depth = torch.where(passed, d_k, depth)
            tid = torch.where(passed, t_k, tid)
            zhi = torch.where(hit, d_k, 0.0)
            undecided = undecided & hit & ~passed
            ran += 1
        targets["MaskedPeelLayers"] = ran
        return depth, tid


@node("LinearizeDepth")
class LinearizeDepthNode(BaseNode):
    def process(self, ctx, targets):
        znf = ctx.scene.frame.camera_z_near_far
        targets["LinearDepth"] = pp.linearize_depth(targets["Depth"], znf[0], znf[1])
        return targets


@node("LightCulling")
class LightCullingNode(BaseNode):
    """Tiled light culling (LightCullingNode.cpp -> kernels/light_culling)."""

    def process(self, ctx, targets):
        w, h = ctx.width, ctx.height
        t = cfg.LIGHTS_CULLING_TILE_SIZE
        lin = targets["LinearDepth"]
        ph, pw = round_up(h, t), round_up(w, t)
        if (ph, pw) != tuple(lin.shape):
            lin = torch.nn.functional.pad(lin, (0, pw - w, 0, ph - h), value=1e4)
        idx, counts = light_culling.cull_lights(
            ctx.scene.lights, ctx.scene.frame.view, ctx.scene.frame.inv_projection,
            lin, tiles_y=ph // t, tiles_x=pw // t, viewport=(w, ctx.fh),
            max_per_tile=int(ctx.config.get("max_lights_per_tile", cfg.LIGHTS_PER_TILE)),
            row0=ctx.row0,
            coarse_capacity=int(ctx.config.get("light_coarse_capacity", 256)))
        targets["LightIndices"] = idx
        targets["LightCounts"] = counts
        return targets


@node("ShadowPrepass")
class ShadowPrepassNode(BaseNode):
    """Cascaded shadow maps with EVSM moments for every cascade
    (ShadowPrepassNode.cpp). Each cascade rasters the scene's depth through
    the frame's raster backend (``triangle_setup(cull="none", clip=False)``,
    ``shadow_bin_capacity`` a tile); the moments of each map are blurred
    along both axes (``Shadow.EvsmBlurRadius``).

    With ``csm_cache`` (the default) the maps are reused while the cascade
    matrices and the geometry signature are unchanged since the last frame
    (LightingECS CSMLightState::Equals): one host read of the dirty flag a
    frame, a synchronise, decides whether the four rasters run at all.

    In a row shard the cascades are split over the shards: shard i
    renders cascades (i * k + j) % C, j < k = ceil(C / n), each weighted by
    1 / (the number of shards that render it), and one ``psum`` a table
    reassembles the maps and the moments. Every shard reads the same
    dirty flag on the host, so all take the same branch; the cached
    branch reuses the (replicated) state and needs no sum."""

    def process(self, ctx, targets):
        scene = ctx.scene
        mats = light_matrices(scene, ctx.config)
        s = int(ctx.config.get("shadow_resolution", 1024))
        tiles_x = round_up(s, tile_raster.TILE_W) // tile_raster.TILE_W
        th = tile_raster.check_tile_h()
        tiles_y = round_up(s, th) // th
        capacity = int(ctx.config.get("shadow_bin_capacity", 512))
        radius = int(ctx.value("Shadow.EvsmBlurRadius", 4))
        dense = ctx.config.get("raster_mode", "stream") not in ("stream", "dma")

        def one_cascade(c):
            tri, aabb = rsetup.triangle_setup(
                scene.geometry, mats[c], width=s, height=s, cull="none", clip=False,
                zplane_rounding="standalone" if dense else "frame")
            raster, _, _ = _make_raster(tri, tri.valid, aabb, tiles_y, tiles_x,
                                        ctx.config, capacity=capacity)
            return raster()[0][:s, :s]

        def evsm_of(maps):
            moments = shadow_k.evsm_warp(maps)  # (C, S, S, 4)
            return blur_k.blur_1d(blur_k.blur_1d(moments, radius, 1), radius, 2)

        def render_all():
            maps = torch.stack([one_cascade(c) for c in range(cfg.NUM_CSM_CASCADES)])
            return maps, evsm_of(maps)

        def render_shards():
            n, c_all = ctx.mesh_size, cfg.NUM_CSM_CASCADES
            k = -(-c_all // n)
            counts = [0] * c_all
            for i in range(n):
                for j in range(k):
                    counts[(i * k + j) % c_all] += 1
            dev = mats.device
            maps = torch.zeros(c_all, s, s, device=dev)
            moments = torch.zeros(c_all, s, s, 4, device=dev)
            for j in range(k):
                c = (ctx.comm.index * k + j) % c_all
                m = one_cascade(c)
                w_c = 1.0 / counts[c]
                maps[c] = m * w_c
                moments[c] = evsm_of(m[None])[0] * w_c
            return ctx.comm.psum(maps), ctx.comm.psum(moments)

        render = render_shards if ctx.sharded and ctx.mesh_size > 1 else render_all

        state = ctx.state or {}
        if ctx.config.get("csm_cache", True) and "csm/maps" in state:
            # the signature changes under any rigid motion of any object:
            # fixed pseudo-random per-vertex weights catch rotations about
            # the centroid, which sum(p) and sum(p * p) miss
            pos = scene.geometry.position
            widx = torch.arange(pos.shape[0], dtype=torch.float32, device=pos.device)[:, None]
            phase = torch.arange(3, dtype=torch.float32, device=pos.device)[None, :] * 78.233
            wgt = torch.sin(widx * 12.9898 + phase)
            geo_sig = torch.stack([
                (pos * 0.37331).sum(), (pos * wgt).sum() * 0.11217,
                torch.tensor(float(scene.geometry.indices.shape[0]), device=pos.device)])
            key = torch.cat([mats.reshape(-1), geo_sig])
            if bool(((key - state["csm/key"]).abs() > 0.0).any()):  # the host read
                maps, moments = render()
            else:
                maps, moments = state["csm/maps"], state["csm/evsm"]
            out = targets.setdefault("state_out", {})
            out["csm/maps"], out["csm/evsm"], out["csm/key"] = maps, moments, key
        else:
            maps, moments = render()
        targets["ShadowMaps"] = maps
        targets["LightMatrices"] = mats
        targets["EvsmMaps"] = moments
        targets["EvsmMap"] = moments[0]
        return targets


@node("Sky")
class SkyNode(BaseNode):
    """Procedural sky for the background pixels (SkyNode.cpp), rendered at
    1/``sky_downsample`` resolution (default 2) with the clouds marched at
    a further 1/``cloud_stride`` (default 2), each upsampled bilinearly.

    With ``sky_cache`` (the default) the buffer is a change snapshot, as
    the CSM cache: the sky depends only on the ray directions, the sun and
    the cloud time, so the key is the four corner rays of a 2x2 grid (they
    pin the projective ray grid) rounded to 1e-5, the sun, and the cloud
    time floored at ``sky_cache_hz``. One host read of the dirty flag a
    frame (a synchronise) decides whether the sky is rendered at all; a
    translating camera reuses the buffer. The scene's stars are drawn when
    it has any; as in the reference, they are not in the key."""

    def process(self, ctx, targets):
        scene = ctx.scene
        use_stars = scene.star_dirs.shape[0] > 0
        w, h = ctx.width, ctx.height
        q = max(1, int(ctx.config.get("sky_downsample", 2)))
        hq, wq = -(-h // q), -(-w // q)
        inv_vp = _inv_vp(ctx)
        cam = scene.frame.camera_position
        with_clouds = bool(ctx.config.get("sky_clouds", True))
        cs = int(ctx.config.get("cloud_stride", 2))
        time_ = scene.frame.current_time

        def render_sky():
            # the reference's frame rounds the sky's rays unfused
            d = interpolate.pixel_rays_strided(inv_vp, cam, h, w, q, ctx.row0,
                                               ctx.full_height, fused=False)
            cloud_override = None
            if with_clouds and cs > 1:
                d_c = interpolate.pixel_rays_strided(inv_vp, cam, h, w, q * cs, ctx.row0,
                                                     ctx.full_height, fused=False)
                cl_q, ct_q = sky_k.clouds(d_c, scene.sky, time_)
                cloud_override = (ctx.upsample(cl_q, (hq, wq)),
                                  ctx.upsample(ct_q[..., None], (hq, wq))[..., 0])
            color = sky_k.sky_radiance(d, scene.sky, time_, scene.star_dirs, scene.star_colors,
                                       with_clouds=with_clouds, with_stars=use_stars,
                                       cloud_override=cloud_override)
            return ctx.upsample(color, (h, w)) if q > 1 else color

        state = ctx.state or {}
        if ctx.config.get("sky_cache", True) and "sky/buf" in state:
            p_ = scene.sky.on(cam.device)
            # row0 = 0: every slice of a frame computes the same key
            corners = torch.round(interpolate.pixel_rays_strided(
                inv_vp, cam, 2, 2, 1, 0, ctx.full_height).reshape(-1) * 1e5)
            hz = float(ctx.config.get("sky_cache_hz", 4.0))
            tq = torch.floor(time_ * hz) if with_clouds else torch.zeros((), device=cam.device)
            key = torch.cat([corners, p_["sun_direction"], torch.stack([
                p_["sun_intensity"], p_["clouds_coverage"], tq.to(torch.float32)])])
            if bool(((key - state["sky/key"]).abs() > 0.0).any()):  # the host read
                color = render_sky()
            else:
                color = state["sky/buf"][ctx.row0:ctx.row0 + h]
            out = targets.setdefault("state_out", {})
            out["sky/buf"], out["sky/key"] = color, key
        else:
            color = render_sky()
        targets["Sky"] = color
        return targets


@node("Environment")
class EnvironmentNode(BaseNode):
    """IBL bake of the sky without clouds (EnvironmentNode.cpp): the
    environment cube at ``env_resolution`` (default 64), its irradiance
    cube, four prefiltered specular mips (also packed at the cube's
    resolution, "env/spec_stack"), the split-sum BRDF LUT and the SH9
    projection, published into the state ("env/*").

    The bake runs in ``prepare`` and is cached per node instance on a host
    key of the sky (the SkyParams leaves are host numpy: no device read).
    With ``env_incremental`` (the default) a changed sky re-renders one
    cube face per ``prepare`` into the cached cube; the derived maps are
    rebuilt when a sweep of six faces has held the same key
    (SkyNode.h m_updateEnvCubemapPattern)."""

    _cache_key = None
    _cache = None
    _next_face = 0
    _pending_key = None

    @staticmethod
    def _derive(env, res):
        """Irradiance, specular mips, LUT and SH9 from an environment cube."""
        mips = ibl_k.prefiltered_env_mips(env, num_mips=4, samples=32)
        return {
            "env/cube": env,
            "env/irradiance": ibl_k.irradiance_map(env, resolution=16, samples=128),
            "env/sh9": ibl_k.sh9_project(env),
            "env/brdf_lut": ibl_k.brdf_lut(resolution=64, samples=128, device=env.device),
            "env/spec_stack": torch.stack([cm.upsample_cubemap(m, res) for m in mips]),
            **{f"env/mip{i}": m for i, m in enumerate(mips)},
        }

    def prepare(self, ctx):
        p = ctx.scene.sky
        res = int(ctx.config.get("env_resolution", 64))
        key = (res,) + tuple(round(float(v), 4) for v in (
            p.sun_direction[0], p.sun_direction[1], p.sun_direction[2], p.sun_intensity,
            p.clouds_coverage))
        if key == self._cache_key:
            ctx.state.update(self._cache)
            return
        dev = ctx.scene.frame.view.device

        def radiance(d):
            return sky_k.sky_radiance(d, p, 0.0, with_clouds=False)

        if self._cache is not None and ctx.config.get("env_incremental", True):
            if key != self._pending_key:
                self._pending_key = key
                self._next_face = 0
            face = self._next_face
            env = self._cache["env/cube"].clone()
            env[face] = radiance(cm.face_directions(res, dev)[face])
            self._next_face += 1
            if self._next_face >= 6 and key == self._pending_key:
                # clean only when the key held for the whole sweep
                self._cache = self._derive(env, res)
                self._cache_key = key
                self._pending_key = None
                self._next_face = 0
            else:
                self._cache = dict(self._cache, **{"env/cube": env})
            ctx.state.update(self._cache)
            return
        self._cache = self._derive(cm.render_cubemap(radiance, res, dev), res)
        self._cache_key = key
        ctx.state.update(self._cache)

    def process(self, ctx, targets):
        return targets  # the maps are in the state already


@node("DepthHighZ")
class DepthHighZNode(BaseNode):
    """HiZ min pyramid of the frame's depth (ComputeDepthHighZ.shader):
    "HiZ/mip1".."HiZ/mip4", and with ``hiz_culling`` the culling levels
    ``mips[2:]`` (texels of 4 px and up) into the state for the next
    frame's DepthPrepass. ``levels`` (default 8) must reach coarse texels:
    a triangle is tested only at a level where it spans at most 2x2
    texels."""

    def process(self, ctx, targets):
        mips = sampling.build_min_pyramid(targets["Depth"], int(self.p("levels", 8)))
        for i, m in enumerate(mips[1:5], 1):
            targets[f"HiZ/mip{i}"] = m
        if ctx.config.get("hiz_culling", True):
            out = targets.setdefault("state_out", {})
            for i, m in enumerate(mips[2:]):
                out[f"hiz/mip{i}"] = m
        return targets


@node("PostProcess")
class PostProcessNode(BaseNode):
    """Fullscreen pass selected by ``shader`` (PostProcessNode.cpp): HBAO
    (at 1/``ao_stride``, default 2, upsampled), HBAO_Blur (``direction``
    V or H), MotionBlur (4 samples against the scene's previous frame),
    SunShafts, ChromaticAberration and Debug (``mode``: none, ao,
    light_tiles, cascades)."""

    def process(self, ctx, targets):
        shader = self.p("shader", "")
        scene = ctx.scene
        if shader == "HBAO":
            q = int(ctx.config.get("ao_stride", 2))
            ld = targets["LinearDepth"]
            if q > 1:
                ld = pp.window_sum(ld, q) * (1.0 / (q * q))
            hq, wq = ctx.height // q, ctx.width // q
            kw = dict(radius=float(ctx.value("AO.Radius", 0.5)),
                      power=float(ctx.value("AO.Power", 1.5)))
            if ctx.sharded and q > 1:
                # the reduced depth is small: gather it, run the whole
                # frame's pass and take the slice's rows (a 17-row halo
                # could exceed a thin slice)
                ao_full = pp.hbao(ctx.comm.all_gather(ld), scene.frame.inv_projection,
                                  height=ctx.fh // q, width=wq, **kw)
                ao_q = ao_full[ctx.row0 // q:ctx.row0 // q + hq]
            elif ctx.sharded:
                ao_q = pp.hbao_sharded(ld, scene.frame.inv_projection, height=hq, width=wq,
                                       comm=ctx.comm, row0=ctx.row0, full_height=ctx.fh, **kw)
            else:
                ao_q = pp.hbao(ld, scene.frame.inv_projection, height=hq, width=wq, **kw)
            targets["AO"] = (ctx.upsample(ao_q[..., None], (ctx.height, ctx.width))[..., 0]
                             if q > 1 else ao_q)
        elif shader == "HBAO_Blur":
            axis = 0 if self.p("direction", "V") == "V" else 1
            if ctx.sharded and axis == 0:
                targets["AO"] = blur_k.blur_rows_sharded(targets["AO"], 4, ctx.comm)
            else:
                targets["AO"] = blur_k.blur_1d(targets["AO"], 4, axis)
        elif shader == "MotionBlur":
            quarter_full = None
            if ctx.sharded:
                quarter_full = ctx.comm.all_gather(pp.downsample_quarter(targets["Main"]))
            targets["Main"] = pp.motion_blur(
                targets["Main"], targets["Depth"], scene.prev_frame.view_projection,
                _inv_vp(ctx),
                intensity=float(ctx.value("MotionBlur.Intensity", 1.0)), num_samples=4,
                row0=ctx.row0, full_height=ctx.full_height, quarter_full=quarter_full,
                comm=ctx.comm)
        elif shader == "SunShafts":
            p_ = scene.sky.on(targets["Main"].device)
            tint = torch.tensor([1.0, 0.9, 0.75], device=targets["Main"].device)
            targets["Main"] = pp.sun_shafts(
                targets["Main"], targets["Depth"], scene.frame.view_projection,
                p_["sun_direction"], p_["sun_intensity"] * tint,
                intensity=float(ctx.value("SunShafts.Intensity", 0.45)),
                num_samples=int(ctx.value("SunShafts.Distance", 24)),
                row0=ctx.row0, full_height=ctx.full_height, comm=ctx.comm)
        elif shader == "ChromaticAberration":
            targets["Main"] = pp.chromatic_aberration(
                targets["Main"], float(ctx.value("CA.Strength", 0.003)))
        elif shader == "Debug":
            self._debug(ctx, targets)
        else:
            raise KeyError(f"unknown PostProcess shader '{shader}'")
        return targets

    def _debug(self, ctx, targets):
        """Debug.shader's AO, LIGHT_TILES and CASCADES views over the LDR
        frame (Final, else Main); "none" passes through."""
        mode = self.p("mode", "none")
        dst = "Final" if "Final" in targets else "Main"
        z_far = float(ctx.config.get("z_far", 150.0))
        if mode == "ao" and "AO" in targets:
            targets[dst] = targets["AO"][..., None].expand(-1, -1, 3).clone()
        elif mode == "light_tiles" and "LightCounts" in targets:
            t = cfg.LIGHTS_CULLING_TILE_SIZE
            base = targets["LinearDepth"] / z_far
            heat = targets["LightCounts"].to(torch.float32).repeat_interleave(t, 0) \
                .repeat_interleave(t, 1)[:ctx.height, :ctx.width] * 0.05
            targets[dst] = torch.stack([base + heat, base + heat, base], dim=-1)
        elif mode == "cascades" and "ShadowMaps" in targets:
            levels = cfg.SHADOW_CASCADE_LEVELS
            lin = targets["LinearDepth"]
            layer = torch.full(lin.shape, len(levels), dtype=torch.int64, device=lin.device)
            for i in reversed(range(len(levels))):
                layer = torch.where(lin < z_far * levels[i], i, layer)
            palette = torch.tensor([[0, 1, 0], [1, 1, 0], [0, 1, 1], [1, 0, 0], [1, 1, 1]],
                                   dtype=torch.float32, device=lin.device)
            luma = torch.clamp(targets[dst].mean(-1, keepdim=True), 0.15, 1.0)
            targets[dst] = palette[torch.clamp(layer, max=4)] * luma


def _pool(x, q: int, w):
    """Coverage-weighted mean of q x q blocks (partial blocks at the far
    edges dropped): sum(x * w) / max(sum(w), 1e-6), each sum in the
    reference's ``reduce_window`` order (``postprocess.window_sum``)."""
    xs = x * (w if x.ndim == 2 else w[..., None])
    sw = torch.clamp(pp.window_sum(w, q), min=1e-6)
    return pp.window_sum(xs, q) / (sw if x.ndim == 2 else sw[..., None])


@node("RenderScene")
class RenderSceneNode(BaseNode):
    """Forward+ shading of the visibility buffer (RenderSceneNode.cpp): the
    fused resolve (B2 or B10) or the gather resolve builds the G-buffer
    (with the scene's materials: their maps and normal mapping),
    the shade kernel (B3) lights it, with the sun's shadow factor and,
    when the Environment node has baked, the IBL ambient added after it;
    background pixels take the Sky."""

    def process(self, ctx, targets):
        scene = ctx.scene
        inv_vp = _inv_vp(ctx)
        if "StreamBins" in targets:
            # fused path: winner rows from the raster's own bin windows (the
            # opaque and the masked queue's); pop, so the row tables do not
            # outlive the resolve
            tiles_y, tiles_x = _tiles(ctx)
            gbuffer, _uv, _mat_id = interpolate.resolve_gbuffer_stream(
                targets.pop("StreamBins"), targets["TriId"], inv_vp,
                scene.frame.camera_position, materials=scene.materials,
                width=ctx.width, height=ctx.height, tiles_y=tiles_y, tiles_x=tiles_x,
                full_height=ctx.full_height, row0=ctx.row0)
        else:
            gbuffer, _uv, _mat_id = interpolate.resolve_gbuffer(
                scene.geometry, targets["TriSetup"], targets["TriId"], inv_vp,
                scene.frame.camera_position, materials=scene.materials,
                full_height=ctx.full_height, row0=ctx.row0)
        if "AO" in targets:
            gbuffer.ao = targets["AO"]
        shadow = self._shadow(ctx, targets, gbuffer)
        ibl_ambient = self._ibl_ambient(ctx, gbuffer)

        t = cfg.LIGHTS_CULLING_TILE_SIZE
        ph, pw = round_up(ctx.height, t), round_up(ctx.width, t)
        gb_p = gbuffer
        if (ph, pw) != (ctx.height, ctx.width):
            def pad2(x):
                pad = [0, 0] * (x.ndim - 2) + [0, pw - ctx.width, 0, ph - ctx.height]
                return torch.nn.functional.pad(x, pad)

            gb_p = gbuffer.map(pad2)
            shadow = pad2(shadow) if shadow is not None else None
            ibl_ambient = pad2(ibl_ambient) if ibl_ambient is not None else None
        if ctx.config.get("pallas_shading", False):
            hdr = pbr_kernel.shade_forward_plus_kernel(
                gb_p, scene.lights, targets["LightIndices"],
                scene.frame.camera_position, shadow_factors=shadow,
                ibl_ambient=ibl_ambient, tile_light_counts=targets.get("LightCounts"))
        else:
            hdr = pbr.shade_forward_plus(gb_p, scene.lights, targets["LightIndices"],
                                         scene.frame.camera_position,
                                         shadow_factors=shadow, ibl_ambient=ibl_ambient)
        hdr = hdr[:ctx.height, :ctx.width]
        if "Sky" in targets:
            covered = gbuffer.coverage[..., None]
            hdr = hdr * covered + targets["Sky"] * (1.0 - covered)
        targets["Main"] = hdr
        return targets

    @staticmethod
    def _ibl_ambient(ctx, gbuffer):
        """The IBL ambient at 1/``ibl_stride`` resolution (default 4) from
        the coverage-weighted pooled G-buffer, upsampled and masked by the
        coverage; None without the Environment node's bake. The packed
        stack (SH9 diffuse, analytic BRDF) when the bake has it, else the
        list of mips with the LUT."""
        state = ctx.state or {}
        if "env/irradiance" not in state:
            return None
        q = int(ctx.config.get("ibl_stride", 4))
        cov = gbuffer.coverage
        wpos_q = _pool(gbuffer.world_position, q, cov)
        n_q = m3.normalize(_pool(gbuffer.normal, q, cov))
        view_q = m3.normalize(wpos_q - ctx.scene.frame.camera_position)
        args = (_pool(gbuffer.albedo, q, cov), _pool(gbuffer.metallic, q, cov),
                _pool(gbuffer.roughness, q, cov), _pool(gbuffer.ao, q, cov), n_q, view_q)
        if "env/spec_stack" in state:
            amb_q = ibl_k.ambient_ibl_packed(*args, state["env/irradiance"],
                                             state["env/spec_stack"],
                                             irradiance_sh=state.get("env/sh9"))
        else:
            mips = [state[k] for k in sorted(state) if k.startswith("env/mip")]
            amb_q = ibl_k.ambient_ibl(*args, state["env/irradiance"], mips,
                                      state["env/brdf_lut"])
        return ctx.upsample(amb_q, (ctx.height, ctx.width)) * cov[..., None]

    @staticmethod
    def _shadow(ctx, targets, gbuffer):
        """The sun's CSM factor at 1/``shadow_stride`` resolution from the
        coverage-weighted pooled position and normal, upsampled to the
        frame; None without a shadow input. EVSM moments of every cascade
        when ShadowPrepass gave them, else PCF with EVSM on cascade 0."""
        if "EvsmMaps" not in targets and "ShadowMaps" not in targets:
            return None
        scene = ctx.scene
        q = int(ctx.config.get("shadow_stride", 4))
        cov = gbuffer.coverage
        wpos_q = _pool(gbuffer.world_position, q, cov)
        n_q = m3.normalize(_pool(gbuffer.normal, q, cov))
        z_far = float(ctx.config.get("z_far", 100.0))
        if "EvsmMaps" in targets:
            shadow_q = shadow_k.csm_shadow_factor_evsm(
                wpos_q, n_q, scene.frame.view, scene.sky.sun_direction,
                targets["LightMatrices"], targets["EvsmMaps"], z_far=z_far)
        else:
            shadow_q = shadow_k.csm_shadow_factor(
                wpos_q, n_q, scene.frame.view, scene.sky.sun_direction,
                targets["LightMatrices"], targets["ShadowMaps"], targets.get("EvsmMap"),
                z_far=z_far, use_evsm=True)
        return ctx.upsample(shadow_q, (ctx.height, ctx.width))


def transparent_raster(ctx):
    """RenderTransparent's peel raster: the two-sided setup (``cull="none"``,
    you see a glass sphere's inside through its front), the Transparent
    queue's triangles alone, and their own packed rows. Returns (tri, aabb,
    raster, stream_bins or None). The setup rounds its depth plane as
    DepthPrepass's does (ROADMAP C 2); in a row shard it is shifted into the
    slice."""
    scene = ctx.scene
    tiles_y, tiles_x = _tiles(ctx)
    dense = ctx.config.get("raster_mode", "stream") not in ("stream", "dma")
    tri, aabb = _into_slice(ctx, *rsetup.triangle_setup(
        scene.geometry, scene.frame.view_projection, width=ctx.width, height=ctx.fh,
        cull="none", zplane_rounding="standalone" if dense else "frame"))
    tvalid = tri.valid & (_queue_of_raster_tris(scene, tri) == 2)
    raster, _, sb = _make_raster(tri, tvalid, aabb, tiles_y, tiles_x, ctx.config,
                                 capacity=int(ctx.config.get("bin_capacity", 512)),
                                 attrs=_packed_attrs(scene, tri, ctx.config))
    return tri, aabb, raster, sb


@node("RenderTransparent")
class RenderTransparentNode(BaseNode):
    """The Transparent queue: a K-layer depth peel and a back-to-front blend
    over Main (the reference blends its Transparent-tagged materials after
    the opaque scene; a visibility buffer cannot blend in raster order).
    The nearest ``transparent_layers`` (default 3) transparent layers in
    front of Depth are peeled with the z-bounded raster (B1 on the
    two-sided setup), each resolved with its materials (B2's 29 planes),
    shaded by the plain Forward+ function ``pbr.shade_forward_plus`` as the
    reference shades them (not its shade kernel), and blended by albedo
    alpha x opacity x coverage. A scene without transparent materials
    passes through."""

    def process(self, ctx, targets):
        scene = ctx.scene
        mats = scene.materials
        if mats is None or not mats.has_transparent:
            return targets
        w, h = ctx.width, ctx.height
        tiles_y, tiles_x = _tiles(ctx)
        tri, _, raster_t, sb_t = transparent_raster(ctx)
        zlo = targets["Depth"]
        zhi = torch.full((h, w), 2.0, device=zlo.device)
        layers = []
        for _ in range(int(ctx.config.get("transparent_layers", 3))):
            d_k, t_k = raster_t((zlo, zhi))
            d_k, t_k = d_k[:h, :w], t_k[:h, :w]
            layers.append(t_k)
            zhi = torch.where(t_k >= 0, d_k, 0.0)
        inv_vp = _inv_vp(ctx)
        cam = scene.frame.camera_position
        t = cfg.LIGHTS_CULLING_TILE_SIZE
        ph, pw = round_up(h, t), round_up(w, t)
        color = targets["Main"]
        for t_k in reversed(layers):
            if sb_t is not None:
                gb, _, _, extras = interpolate.resolve_gbuffer_stream(
                    sb_t, t_k, inv_vp, cam, materials=mats, width=w, height=h,
                    tiles_y=tiles_y, tiles_x=tiles_x, full_height=ctx.full_height,
                    row0=ctx.row0, return_extras=True)
                opacity = extras["opacity"]
            else:
                gb, _, mat_id = interpolate.resolve_gbuffer(
                    scene.geometry, tri, t_k, inv_vp, cam, materials=mats,
                    full_height=ctx.full_height, row0=ctx.row0)
                opacity = mats.opacity[mat_id.long()]
            gb_p = gb.map(lambda x: torch.nn.functional.pad(
                x, [0, 0] * (x.ndim - 2) + [0, pw - w, 0, ph - h]))
            hdr = pbr.shade_forward_plus(gb_p, scene.lights, targets["LightIndices"],
                                         cam)[:h, :w]
            a = (gb.albedo[..., 3] * opacity * gb.coverage)[..., None]
            color = color * (1.0 - a) + hdr * a
        targets["Main"] = color
        return targets


@node("Bloom")
class BloomNode(BaseNode):
    """Bloom added to Main (BloomNode.cpp), with the procedural lens dirt
    when ``Bloom.DirtIntensity`` > 0 (made once per resolution and device
    and kept by the node). The mip chain spans the whole frame, so a row
    shard gathers Main, blooms it whole and keeps its rows."""

    _dirt = None

    def process(self, ctx, targets):
        kw = dict(threshold=float(ctx.value("Bloom.Threshold", 1.0)),
                  knee=float(ctx.value("Bloom.Knee", 0.5)),
                  intensity=float(ctx.value("Bloom.Intensity", 0.35)))
        dirt_i = float(ctx.value("Bloom.DirtIntensity", 0.0))
        main = targets["Main"]
        if dirt_i > 0.0:
            key = (ctx.fh, ctx.width, main.device)
            if self._dirt is None or self._dirt[0] != key:
                self._dirt = (key, torch.from_numpy(bloom_k.lens_dirt(ctx.fh, ctx.width))
                              .to(main.device))
            kw["dirt"], kw["dirt_intensity"] = self._dirt[1], dirt_i
        if ctx.sharded:
            full = ctx.comm.all_gather(main)
            bloomed = full + bloom_k.bloom(full, **kw)
            targets["Main"] = bloomed[ctx.row0:ctx.row0 + ctx.height]
        else:
            targets["Main"] = main + bloom_k.bloom(main, **kw)
        return targets


@node("EyeAdaptation")
class EyeAdaptationNode(BaseNode):
    """Histogram exposure + temporal adaptation + tonemap
    (EyeAdaptationNode.cpp + Tonemapping.shader); a row shard adds every
    slice's histogram (``psum``) first."""

    def process(self, ctx, targets):
        hdr = targets["Main"]
        h, w = hdr.shape[:2]
        # exposure statistics from a quarter-res average
        q = 4
        he, we = (h // q) * q, (w // q) * q
        hdr_q = hdr[:he, :we].reshape(he // q, q, we // q, q, 3).sum(dim=(1, 3)) * (
            1.0 / (q * q))
        hist = hist_k.luminance_histogram(hdr_q)
        if ctx.sharded:
            hist = ctx.comm.psum(hist)
        prev = (ctx.state or {}).get("avg_luminance")
        if prev is None:
            prev = torch.tensor(0.18, dtype=torch.float32, device=hdr.device)
        avg = hist_k.adapt_average_luminance(
            hist, prev, float((w // q) * (ctx.fh // q)),
            ctx.scene.frame.delta_time + 0.25,
            tau=float(ctx.value("EyeAdaptation.Tau", 1.1)))
        ldr = tm.tonemap(hdr, avg, mode=str(ctx.config.get("tonemap", "aces")))
        srgb = m3.linear_to_srgb(ldr)
        if ctx.config.get("ldr_dither", True):
            # +-0.5/255 blue-noise on the sRGB output breaks 8-bit banding;
            # the 64x64 mask tiles with the row phase of the slice
            from sailor_tpu_torch.raytracing.bluenoise import blue_noise_mask

            bn = torch.from_numpy(blue_noise_mask(64)).to(hdr.device)
            tiled = bn.tile(-(-h // 64) + 1, -(-w // 64))
            r0 = int(ctx.row0) % 64
            tiled = tiled[r0:r0 + h, :w]
            srgb = srgb + (tiled[..., None] - 0.5) * (1.0 / 255.0)
        targets["Final"] = torch.clamp(srgb, 0.0, 1.0)
        targets.setdefault("state_out", {})["avg_luminance"] = avg
        return targets


@node("DebugDraw")
class DebugDrawNode(BaseNode):
    """Debug lines over Main (DebugDrawNode.cpp): the lines of
    ``config["debug_context"]`` (rhi.debug_context.DebugContext) splatted
    with the frame's view-projection. Without a context, or one with no
    lines, it passes through."""

    def process(self, ctx, targets):
        dbg = ctx.config.get("debug_context")
        if dbg is None or not dbg.has_lines:
            return targets
        targets["Main"] = dbg.rasterize_over(targets["Main"], ctx.scene.frame.view_projection)
        return targets


@node("RenderOverlay")
class RenderOverlayNode(BaseNode):
    """The HUD canvas over Final (RenderImGuiNode.cpp + ImGuiUI.shader):
    the state's "overlay/canvas", an (h, w, 4) straight-alpha float32
    image (engine.overlay.OverlayContext), blended over Final at the
    params ``x``, ``y`` (pixels). The canvas is cut to Final's size; the
    patch is Final sliced as Python slices it, and the write's start is
    clamped so that the blend fits, as the reference's
    ``dynamic_update_slice``; where the slice and the canvas do not
    broadcast, the blend raises as the reference's does. Without a canvas,
    or without Final, it passes through."""

    def process(self, ctx, targets):
        canvas = (ctx.state or {}).get("overlay/canvas")
        if canvas is None or "Final" not in targets:
            return targets
        final = targets["Final"]
        h, w = final.shape[:2]
        ch, cw = min(canvas.shape[0], h), min(canvas.shape[1], w)
        x0, y0 = int(self.p("x", 0)), int(self.p("y", 0))
        patch = final[y0:y0 + ch, x0:x0 + cw]
        a = canvas[:ch, :cw, 3:4]
        blended = patch * (1.0 - a) + canvas[:ch, :cw, :3] * a
        bh, bw = blended.shape[:2]
        y, x = min(max(y0, 0), h - bh), min(max(x0, 0), w - bw)
        out = final.clone()
        out[y:y + bh, x:x + bw] = blended
        targets["Final"] = out
        return targets


@node("Clear")
class ClearNode(BaseNode):
    """Clear a render target to ``clearValue`` (ClearNode.cpp); a target
    not in the dict is left alone."""

    def process(self, ctx, targets):
        name = self.p("target", "Main")
        if name in targets:
            targets[name] = torch.full_like(targets[name], self.p("clearValue", 0.0))
        return targets


@node("Blit")
class BlitNode(BaseNode):
    """Resize-copy ``src`` into ``dst`` (BlitNode.cpp): to dst's size when
    the target exists (a declared target does), else to the viewport."""

    def process(self, ctx, targets):
        src = targets[self.p("src", "Sky")]
        dst_name = self.p("dst", "Main")
        if dst_name in targets:
            dst_hw = tuple(targets[dst_name].shape[:2])
        else:
            dst_hw = (ctx.height, ctx.width)
        targets[dst_name] = sampling.blit(src, dst_hw)
        return targets


@node("CopyTextureToRam")
class CopyTextureToRamNode(BaseNode):
    """Device -> host readback marker (CopyTextureToRamNode.cpp, used for
    editor thumbnails): ``process`` lists the target under "readback";
    after the frame, ``fetch(targets)`` copies the listed targets to numpy
    (one synchronising copy each)."""

    def process(self, ctx, targets):
        targets.setdefault("readback", []).append(self.p("target", "Final"))
        return targets

    @staticmethod
    def fetch(targets):
        return {name: targets[name].detach().cpu().numpy()
                for name in targets.get("readback", []) if name in targets}


@node("Particles")
class ParticlesNode(BaseNode):
    """Particle playback (the reference's experimental ParticlesNode.cpp).

    Two sources, as the reference's:
    - a baked animation: the param ``asset: path.particles`` loads the
      ParticleInfo YAML and ParticleData binary once, in ``prepare``, and
      copies the records to the scene's device; playback interpolates the
      frame records there (``assets.particles.sample_baked``);
    - a live simulation: ``particles/pos|vel|life`` in the state integrate
      Euler steps with the param ``gravity`` (default -2) each frame; live
      particles take the param ``color`` (+ alpha 1) and ``size``.

    The splat is ``kernels.particles.splat_particles`` (``capacity`` slots
    a tile) with the reverse-Z soft depth test, added to Main; with a
    trace decay (the asset's, or the param ``traceDecay``) the motion
    trail is an exponentially decayed splat carried in the state as
    "particles/trail"; in a row shard the state's trail is full height
    (``FrameGraph.process_sharded`` gathers it) and the shard takes its
    rows.
    """

    def prepare(self, ctx):
        path = self.p("asset")
        if path and getattr(self, "_asset_path", None) != path:
            from sailor_tpu_torch.assets.particles import ParticlesAsset

            self._asset = ParticlesAsset.load(path)
            self._asset_path = path
            self._baked = torch.from_numpy(self._asset.data).to(ctx.scene.frame.view.device)

    def process(self, ctx, targets):
        from sailor_tpu_torch.assets.particles import sample_baked
        from sailor_tpu_torch.kernels import particles as part_k

        state = ctx.state or {}
        out = targets.setdefault("state_out", {})
        asset = getattr(self, "_asset", None)
        frame = ctx.scene.frame
        if asset is not None:
            pos, radii, colors = sample_baked(self._baked.to(frame.view.device),
                                              frame.current_time, asset.fps, asset.frames)
            trace_decay = asset.trace_decay
        elif "particles/pos" in state:
            dt = frame.delta_time
            gravity = torch.tensor([0.0, float(self.p("gravity", -2.0)), 0.0],
                                   device=dt.device)
            vel = state["particles/vel"] + gravity * dt
            # fused as the reference compiles it (within an ulp: ROADMAP C 2)
            pos = m3.fma(vel, dt, state["particles/pos"])
            life = state["particles/life"] - dt
            out["particles/pos"] = pos
            out["particles/vel"] = vel
            out["particles/life"] = life
            base = torch.tensor(list(self.p("color", [4.0, 2.5, 1.0])) + [1.0],
                                device=dt.device)
            colors = torch.where((life > 0.0)[:, None], base[None, :], torch.zeros_like(base))
            radii = torch.full(pos.shape[:1], float(self.p("size", 0.08)), device=dt.device)
            trace_decay = float(self.p("traceDecay", 0.0))
        else:
            return targets
        main = targets.get("Main")
        if main is None:
            return targets
        splat = part_k.splat_particles(
            pos, radii, colors, frame.view_projection, frame.projection, targets["Depth"],
            width=ctx.width, height=ctx.height, full_height=ctx.full_height, row0=ctx.row0,
            capacity=int(self.p("capacity", 64)))
        if trace_decay > 0.0:
            # the motion trail (PushConstants m_traceDecay/m_traceFrames): an
            # exponentially decayed splat history in the state
            trail = state.get("particles/trail")
            if trail is not None and ctx.sharded and trail.shape[0] != splat.shape[0]:
                trail = trail[ctx.row0:ctx.row0 + splat.shape[0]]
            if trail is None or trail.shape != splat.shape:
                trail = torch.zeros_like(splat)
            trail = m3.fma(trail, torch.tensor(trace_decay, device=trail.device), splat)
            out["particles/trail"] = trail
            splat = trail
        targets["Main"] = main + splat
        return targets
