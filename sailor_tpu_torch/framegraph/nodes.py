"""Frame-graph nodes of the shadowed, HiZ-culled visibility Forward+ frame
(counterpart of sailor_tpu/framegraph/nodes.py): DepthPrepass (with the
HiZ cull), LinearizeDepth, LightCulling, ShadowPrepass, DepthHighZ,
RenderScene and EyeAdaptation.

Data flows through the ``targets`` dict: "Depth", "TriId", "TriSetup",
"BinOverflow", "HiZCulledCount", "StreamBins" (the raster's bin windows,
consumed by RenderScene's fused resolve), "LinearDepth",
"LightIndices"/"LightCounts", "ShadowMaps", "LightMatrices", "EvsmMaps",
"EvsmMap", "HiZ/mip1".."HiZ/mip4", "Main", "Final", and temporal state via
"state_out" (avg luminance, the CSM cache "csm/*", the HiZ pyramid
"hiz/mip*").
"""

from __future__ import annotations

import torch

from sailor_tpu_torch import config as cfg
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.framegraph.graph import BaseNode, node
from sailor_tpu_torch.kernels import blur as blur_k
from sailor_tpu_torch.kernels import histogram as hist_k
from sailor_tpu_torch.kernels import light_culling, pbr, pbr_kernel, sampling
from sailor_tpu_torch.kernels import postprocess as pp
from sailor_tpu_torch.kernels import shadow as shadow_k
from sailor_tpu_torch.kernels import tonemap as tm
from sailor_tpu_torch.kernels.common import round_up
from sailor_tpu_torch.raster import hiz_cull, interpolate, pipeline
from sailor_tpu_torch.raster import setup as rsetup
from sailor_tpu_torch.raster import tile_raster


def inverse_view_projection(frame):
    """inv(projection @ view), the resolve's unprojection matrix, rounded
    as the reference's (``math3d.inverse``)."""
    return m3.inverse(frame.view_projection)


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
    tw, th = tile_raster.TILE_W, tile_raster.TILE_H
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


@node("DepthPrepass")
class DepthPrepassNode(BaseNode):
    """Visibility raster: depth + triangle id (DepthPrepassNode.cpp), opaque
    queue, through the configured raster backend (``_make_raster``). With
    ``hiz_culling`` (the default) and a pyramid in the state, triangles
    that the previous frame's HiZ pyramid hides are dropped before the
    raster ("HiZCulledCount"). On the fused stream path the raster's bin
    windows and the combined row table are handed on to RenderScene's fused
    resolve ("StreamBins"); otherwise RenderScene gathers from
    "TriSetup"."""

    def process(self, ctx, targets):
        scene = ctx.scene
        geo = scene.geometry
        w, h = ctx.width, ctx.height
        tw, th = tile_raster.TILE_W, tile_raster.TILE_H
        tiles_x, tiles_y = round_up(w, tw) // tw, round_up(h, th) // th
        capacity = int(ctx.config.get("bin_capacity", 512))
        rounds = int(ctx.config.get("bin_rounds", 2))
        dense = ctx.config.get("raster_mode", "stream") not in ("stream", "dma")
        tri, aabb = rsetup.triangle_setup(
            geo, scene.frame.view_projection, width=w, height=ctx.fh, cull="back",
            zplane_rounding="standalone" if dense else "frame")
        valid = tri.valid
        state = ctx.state or {}
        if ctx.config.get("hiz_culling", True) and "hiz/mip0" in state:
            # the reference's key order: sorted names
            mips = [state[k] for k in sorted(state) if k.startswith("hiz/mip")]
            flat, offsets, shapes = hiz_cull.build_flat_pyramid(mips)
            culled = hiz_cull.occlusion_cull(
                valid, aabb, tri.zmax, flat, offsets=offsets, shapes=shapes,
                base_w=w, base_h=ctx.fh)
            targets["HiZCulledCount"] = (valid & ~culled).sum(dtype=torch.int32)
            valid = culled
        attrs = None
        if (ctx.config.get("fused_resolve", True)
                and ctx.config.get("raster_mode", "stream") == "stream"):
            if (scene.attrs_packed is not None
                    and scene.attrs_packed.shape[1] == tile_raster.A_BASE):
                attrs = scene.attrs_packed[tri.src_id.long()]
            else:
                attrs = interpolate.pack_triangle_attributes(geo, tri.src_id)
        raster, overflow, stream_bins = _make_raster(
            tri, valid, aabb, tiles_y, tiles_x, ctx.config,
            capacity=capacity, rounds=rounds, attrs=attrs)
        if stream_bins is not None:
            targets["StreamBins"] = [stream_bins]
        targets["BinOverflow"] = overflow
        depth, tid = raster()
        targets["Depth"] = depth[:h, :w]
        targets["TriId"] = tid[:h, :w]
        targets["TriSetup"] = tri
        targets["TriAABB"] = aabb
        return targets


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
    frame, a synchronise, decides whether the four rasters run at all."""

    def process(self, ctx, targets):
        scene = ctx.scene
        mats = light_matrices(scene, ctx.config)
        s = int(ctx.config.get("shadow_resolution", 1024))
        tiles_x = round_up(s, tile_raster.TILE_W) // tile_raster.TILE_W
        tiles_y = round_up(s, tile_raster.TILE_H) // tile_raster.TILE_H
        capacity = int(ctx.config.get("shadow_bin_capacity", 512))
        radius = int(ctx.value("Shadow.EvsmBlurRadius", 4))
        dense = ctx.config.get("raster_mode", "stream") not in ("stream", "dma")

        def render_all():
            maps = []
            for c in range(cfg.NUM_CSM_CASCADES):
                tri, aabb = rsetup.triangle_setup(
                    scene.geometry, mats[c], width=s, height=s, cull="none", clip=False,
                    zplane_rounding="standalone" if dense else "frame")
                raster, _, _ = _make_raster(tri, tri.valid, aabb, tiles_y, tiles_x,
                                            ctx.config, capacity=capacity)
                maps.append(raster()[0][:s, :s])
            maps = torch.stack(maps)
            moments = shadow_k.evsm_warp(maps)  # (C, S, S, 4)
            return maps, blur_k.blur_1d(blur_k.blur_1d(moments, radius, 1), radius, 2)

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
                maps, moments = render_all()
            else:
                maps, moments = state["csm/maps"], state["csm/evsm"]
            out = targets.setdefault("state_out", {})
            out["csm/maps"], out["csm/evsm"], out["csm/key"] = maps, moments, key
        else:
            maps, moments = render_all()
        targets["ShadowMaps"] = maps
        targets["LightMatrices"] = mats
        targets["EvsmMaps"] = moments
        targets["EvsmMap"] = moments[0]
        return targets


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


def _pool(x, q: int, w):
    """Coverage-weighted mean of q x q blocks (partial blocks at the far
    edges dropped): sum(x * w) / max(sum(w), 1e-6)."""
    h, wd = (x.shape[0] // q) * q, (x.shape[1] // q) * q

    def block_sum(v):
        v = v[:h, :wd]
        return v.reshape((h // q, q, wd // q, q) + tuple(v.shape[2:])).sum(dim=(1, 3))

    xs = x * (w if x.ndim == 2 else w[..., None])
    sw = torch.clamp(block_sum(w), min=1e-6)
    return block_sum(xs) / (sw if x.ndim == 2 else sw[..., None])


@node("RenderScene")
class RenderSceneNode(BaseNode):
    """Forward+ shading of the visibility buffer (RenderSceneNode.cpp): the
    fused resolve (B2 or B10) or the gather resolve builds the G-buffer,
    the shade kernel (B3) lights it."""

    def process(self, ctx, targets):
        scene = ctx.scene
        state = ctx.state or {}
        if "env/irradiance" in state:
            raise NotImplementedError("the IBL input is not ported yet")
        inv_vp = inverse_view_projection(scene.frame)
        if "StreamBins" in targets:
            # fused path: winner rows from the raster's own bin windows;
            # pop, so the row table does not outlive the resolve
            tw, th = tile_raster.TILE_W, tile_raster.TILE_H
            gbuffer, _uv, _mat_id = interpolate.resolve_gbuffer_stream(
                targets.pop("StreamBins"), targets["TriId"], inv_vp,
                scene.frame.camera_position, width=ctx.width, height=ctx.height,
                tiles_y=round_up(ctx.height, th) // th,
                tiles_x=round_up(ctx.width, tw) // tw,
                full_height=ctx.full_height, row0=ctx.row0)
        else:
            gbuffer, _uv, _mat_id = interpolate.resolve_gbuffer(
                scene.geometry, targets["TriSetup"], targets["TriId"], inv_vp,
                scene.frame.camera_position, full_height=ctx.full_height,
                row0=ctx.row0)
        if "AO" in targets:
            gbuffer.ao = targets["AO"]
        shadow = self._shadow(ctx, targets, gbuffer)

        t = cfg.LIGHTS_CULLING_TILE_SIZE
        ph, pw = round_up(ctx.height, t), round_up(ctx.width, t)
        gb_p = gbuffer
        if (ph, pw) != (ctx.height, ctx.width):
            def pad2(x):
                pad = [0, 0] * (x.ndim - 2) + [0, pw - ctx.width, 0, ph - ctx.height]
                return torch.nn.functional.pad(x, pad)

            gb_p = gbuffer.map(pad2)
            shadow = pad2(shadow) if shadow is not None else None
        if ctx.config.get("pallas_shading", False):
            hdr = pbr_kernel.shade_forward_plus_kernel(
                gb_p, scene.lights, targets["LightIndices"],
                scene.frame.camera_position, shadow_factors=shadow,
                tile_light_counts=targets.get("LightCounts"))
        else:
            hdr = pbr.shade_forward_plus(gb_p, scene.lights, targets["LightIndices"],
                                         scene.frame.camera_position,
                                         shadow_factors=shadow)
        hdr = hdr[:ctx.height, :ctx.width]
        if "Sky" in targets:
            covered = gbuffer.coverage[..., None]
            hdr = hdr * covered + targets["Sky"] * (1.0 - covered)
        targets["Main"] = hdr
        return targets

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


@node("EyeAdaptation")
class EyeAdaptationNode(BaseNode):
    """Histogram exposure + temporal adaptation + tonemap
    (EyeAdaptationNode.cpp + Tonemapping.shader)."""

    def process(self, ctx, targets):
        hdr = targets["Main"]
        h, w = hdr.shape[:2]
        # exposure statistics from a quarter-res average
        q = 4
        he, we = (h // q) * q, (w // q) * q
        hdr_q = hdr[:he, :we].reshape(he // q, q, we // q, q, 3).sum(dim=(1, 3)) * (
            1.0 / (q * q))
        hist = hist_k.luminance_histogram(hdr_q)
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
