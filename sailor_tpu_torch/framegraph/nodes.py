"""Frame-graph nodes of the visibility Forward+ slice (counterpart of
sailor_tpu/framegraph/nodes.py): DepthPrepass, LinearizeDepth,
LightCulling, RenderScene and EyeAdaptation.

Data flows through the ``targets`` dict: "Depth", "TriId", "TriSetup",
"StreamBins" (the raster's bin windows, consumed by RenderScene's fused
resolve), "LinearDepth", "LightIndices"/"LightCounts", "Main", "Final", and
temporal state via "state_out" (avg luminance).
"""

from __future__ import annotations

import torch

from sailor_tpu_torch import config as cfg
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.framegraph.graph import BaseNode, node
from sailor_tpu_torch.kernels import histogram as hist_k
from sailor_tpu_torch.kernels import light_culling, pbr, pbr_kernel
from sailor_tpu_torch.kernels import postprocess as pp
from sailor_tpu_torch.kernels import tonemap as tm
from sailor_tpu_torch.kernels.common import round_up
from sailor_tpu_torch.raster import interpolate
from sailor_tpu_torch.raster import setup as rsetup
from sailor_tpu_torch.raster import tile_raster


def inverse_view_projection(frame):
    """inv(projection @ view), the resolve's unprojection matrix."""
    return torch.linalg.inv(frame.view_projection)


@node("DepthPrepass")
class DepthPrepassNode(BaseNode):
    """Visibility raster: depth + triangle id (DepthPrepassNode.cpp), opaque
    queue, work-list stream raster (B1). The raster's bin windows and the
    combined row table are handed on to RenderScene's fused resolve."""

    def process(self, ctx, targets):
        scene = ctx.scene
        geo = scene.geometry
        w, h = ctx.width, ctx.height
        tw, th = tile_raster.TILE_W, tile_raster.TILE_H
        tiles_x, tiles_y = round_up(w, tw) // tw, round_up(h, th) // th
        tri, aabb = rsetup.triangle_setup(geo, scene.frame.view_projection,
                                          width=w, height=ctx.fh, cull="back")
        if scene.attrs_packed is not None and scene.attrs_packed.shape[1] == tile_raster.A_BASE:
            attrs = scene.attrs_packed[tri.src_id.long()]
        else:
            attrs = interpolate.pack_triangle_attributes(geo, tri.src_id)

        chunk = int(ctx.config.get("stream_chunk", 128))
        # the resolve walks the same rows in bigger windows; pad to the lcm
        rchunk = int(ctx.config.get("resolve_chunk", max(chunk, 256)))
        if rchunk % chunk:
            raise ValueError("resolve_chunk must be a multiple of stream_chunk")
        order, starts, counts, big_ids, n_big, overflow = rsetup.bin_sorted(
            tri.valid, aabb, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tw, tile_h=th)
        rows, big_rows, na = tile_raster.build_stream_rows(
            tri, aabb, order, big_ids, attrs=attrs, chunk=rchunk)
        depth, tid, _ = tile_raster.rasterize_worklist(
            tri, aabb, order, starts, counts, big_ids, n_big, tiles_y=tiles_y,
            tiles_x=tiles_x, chunk=chunk, prebuilt=(rows, big_rows))
        targets["StreamBins"] = [{
            "rows": rows, "big_rows": big_rows, "starts": starts,
            "counts": counts, "n_big": n_big, "na": na, "chunk": rchunk,
        }]
        targets["BinOverflow"] = overflow
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


@node("RenderScene")
class RenderSceneNode(BaseNode):
    """Forward+ shading of the visibility buffer (RenderSceneNode.cpp): the
    fused resolve (B2) builds the G-buffer, the shade kernel (B3) lights it."""

    def process(self, ctx, targets):
        scene = ctx.scene
        state = ctx.state or {}
        if any(k in targets for k in ("EvsmMaps", "ShadowMaps")) or "env/irradiance" in state:
            raise NotImplementedError("shadow and IBL inputs are not ported yet")
        inv_vp = inverse_view_projection(scene.frame)
        tw, th = tile_raster.TILE_W, tile_raster.TILE_H
        gbuffer, _uv, _mat_id = interpolate.resolve_gbuffer_stream(
            targets.pop("StreamBins"), targets["TriId"], inv_vp,
            scene.frame.camera_position, width=ctx.width, height=ctx.height,
            tiles_y=round_up(ctx.height, th) // th,
            tiles_x=round_up(ctx.width, tw) // tw,
            full_height=ctx.full_height, row0=ctx.row0)
        if "AO" in targets:
            gbuffer.ao = targets["AO"]

        t = cfg.LIGHTS_CULLING_TILE_SIZE
        ph, pw = round_up(ctx.height, t), round_up(ctx.width, t)
        gb_p = gbuffer
        if (ph, pw) != (ctx.height, ctx.width):
            def pad2(x):
                pad = [0, 0] * (x.ndim - 2) + [0, pw - ctx.width, 0, ph - ctx.height]
                return torch.nn.functional.pad(x, pad)

            gb_p = gbuffer.map(pad2)
        if ctx.config.get("pallas_shading", False):
            hdr = pbr_kernel.shade_forward_plus_kernel(
                gb_p, scene.lights, targets["LightIndices"],
                scene.frame.camera_position,
                tile_light_counts=targets.get("LightCounts"))
        else:
            hdr = pbr.shade_forward_plus(gb_p, scene.lights, targets["LightIndices"],
                                         scene.frame.camera_position)
        hdr = hdr[:ctx.height, :ctx.width]
        if "Sky" in targets:
            covered = gbuffer.coverage[..., None]
            hdr = hdr * covered + targets["Sky"] * (1.0 - covered)
        targets["Main"] = hdr
        return targets


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
