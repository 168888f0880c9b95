"""Whether a frame of the queue scene is correct, stage by stage.

The frame judged is one the window rendered (its index drawn from the
seed); the driver keeps what its stages produced. Each number compares a
stage's output with the plain reference's:

- ``raster_px_off``: share of pixels where the program's Depth and TriId
  (its triangle setup's source ids) and the reference raster, made from
  the scene's arrays alone, disagree on coverage, or on depth by more
  than 1e-3 of it plus four times the float32 rounding scale of the
  reference winner's depth plane (the renderer solves each plane at
  absolute screen coordinates, so a small far triangle's depth carries
  errors of some 1e-3 of it). It covers the Opaque queue and the Masked
  queue's peel, alpha-tested as the renderer's texture format and
  sampler define it (``reference/raster.py``).
- ``light_list_off``: share of the program's per-tile light entries that
  differ from the reference culling of its Depth.
- ``gbuffer_pos_off``: share of covered pixels whose G-buffer world
  position lies farther than 2e-3 of the distance to the camera from
  the point of the program's winning triangle (taken from the scene's
  arrays) at the pixel ray's clamped barycentrics; 1 where the
  G-buffer's coverage and TriId disagree.
- ``transparent_layer_off``: share of the pixels that the Transparent
  queue's peel covers on either side where the program's layer G-buffers
  and the reference's two-sided peel of the scene's arrays (in front of
  its own Depth) disagree: each side's surfaces are the camera distances
  of its layers' world positions (the reference's at its winner's
  clamped barycentrics), nearest first, a layer within the tolerance of
  the one before merged into it; a pixel is off where a surface's
  distance differs by more than 2e-3 of it plus four times the depth
  plane's rounding scale, or where one side holds a surface fewer and
  had a layer to spare for it. The renderer's coverage margin admits
  both triangles of a shared edge, and its peel takes the second as a
  layer of its own (on some 17% of the first layer's pixels at the
  cell's size), so which pixels hold such a duplicate follows the depth
  planes' rounding; a side whose duplicate took one of its layers, every
  layer covered, may hold a surface fewer.
- ``shade_gap``: the widest gap of the opaque shade (B3) from the plain
  shade of the same G-buffer, light lists, shadow and ambient terms,
  |program - reference| / (|reference| + 0.01).
- ``transparent_px_off``: share of pixels of Main after the transparent
  layers (each shaded plainly from its G-buffer and blended back to
  front) whose gap, as ``shade_gap`` measures it, passes 1e-3 or is not
  a number. The glass is smooth (roughness 0.1), so its highlights turn
  a last-bit difference of a dot product into gaps of some 3e-3.
- ``final_gap``: the widest gap of Final from the exposure and tonemap
  of Main as EyeAdaptation received it.

The G-buffers, the shadow factor, the IBL ambient and the Main handed to
a stage are the program's own state: the reference follows the program
stage by stage from there, and checks Depth, TriId, the opaque
G-buffer's positions and the transparent layers' coverage and positions
by themselves.

``control`` puts the reference computed in bfloat16 in the program's
place.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import light_cull, raster, shade, tonemap

# each limit between the sound runs' largest reading over 12 seeds and the
# bfloat16 control's smallest over 3, on the card at the cell's size
# (PERF.md, section 4)
LIMITS = {
    "raster_px_off": 1e-3,          # sound 1.04e-4, control 0.530
    "light_list_off": 1e-3,         # sound 0, control 0.628
    "gbuffer_pos_off": 2e-3,        # sound 6.83e-6, control 0.993
    "transparent_layer_off": 1e-2,  # sound 2.16e-3, control 0.714
    "shade_gap": 2e-3,              # sound 1.04e-4, control 1.67
    "transparent_px_off": 1e-3,     # sound 1.25e-5, control 0.948
    "final_gap": 1e-4,              # sound 0, control 0.0129
}


# the multiple of a depth plane's float32 rounding scale that a depth may
# differ by: the largest sound gap on the CPU at 480x272 was 2.7 of it
DEPTH_ROUNDING = 4.0


def _gb(obj, dtype):
    return {k: getattr(obj, k).to(dtype) for k in shade.FIELDS}


def _lights(h, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in h["lights"].items()}


def _gaps(p, r):
    """Relative gaps; a NaN output reads as an infinite gap."""
    g = (p.float() - r.float()).abs() / (r.float().abs() + 0.01)
    return torch.nan_to_num(g, nan=float("inf"))


def _stages(cap, h, dtype, device, settings):
    """The reference's outputs of every stage, in ``dtype``."""
    width, height = h["width"], h["height"]
    out = {}
    out["depth"], out["src"], out["depth_cond"] = raster.rasterize(
        h, dtype, device, int(settings.get("masked_layers", 3)))
    lin = light_cull.linearize(cap["depth"].to(dtype), h["z_near"], h["z_far"])
    view = torch.from_numpy(h["view"]).to(device, dtype)
    inv_proj = torch.from_numpy(np.linalg.inv(h["proj"].astype(np.float64)).astype(
        np.float32)).to(device, dtype)
    lights = _lights(h, device)
    t = light_cull.TILE
    out["light_idx"], _ = light_cull.cull(
        lights, view, inv_proj, lin, tiles_y=height // t, tiles_x=width // t,
        viewport=(width, height), max_per_tile=int(settings["max_lights_per_tile"]),
        coarse_capacity=int(settings["light_coarse_capacity"]))
    cam = torch.from_numpy(h["eye"]).to(device, dtype)
    tid = cap["tid"]
    out["wpos"] = raster.position(
        h, torch.where(tid >= 0, cap["src"].long()[tid.clamp(min=0).long()], -1), dtype, device)
    out["t_layers"] = [(src >= 0, raster.position(h, src, dtype, device), rel)
                       for src, rel in raster.transparent_layers(
                           h, out["depth"], int(settings.get("transparent_layers", 3)),
                           dtype, device)]
    gb, idx, shadow, ibl = cap["b3"]
    out["b3"] = shade.shade(_gb(gb, dtype), lights, idx, cam,
                            None if shadow is None else shadow.to(dtype),
                            None if ibl is None else ibl.to(dtype))
    color = cap["main_in_t"].to(dtype)
    for gb_t, opacity in cap["t_layers"]:
        g = _gb(gb_t, dtype)
        hdr = shade.shade(g, lights, cap["light_idx"], cam)[:height, :width]
        a = (g["albedo"][:height, :width, 3] * opacity.to(dtype)
             * g["coverage"][:height, :width])[..., None]
        color = color * (1.0 - a) + hdr * a
    out["main_t"] = color
    hdr = cap["main_in_ea"].to(dtype)
    avg = tonemap.average_luminance(hdr, cap["prev_avg"].to(dtype), cap["dt"], cap["tau"])
    out["final"] = tonemap.final(hdr, avg)
    return out


def _surfaces(layers, cam, tol):
    """The camera distances of a pixel's peeled surfaces, nearest first,
    with a layer that lies within ``tol`` (relative) of the one before it
    merged into it (the coverage margin admits both triangles of a shared
    edge, and the peel takes the second as a layer of its own): (distances
    (3, H, W), +inf past the last, count (H, W), whether a merged
    duplicate took one of the layers that the configuration peels, every
    one of them being covered)."""
    cov = torch.stack([c for c, _, _ in layers])
    d = torch.stack([torch.linalg.vector_norm(p.float() - cam, dim=-1) for _, p, _ in layers])
    dup = torch.zeros_like(cov)
    dup[1:] = cov[1:] & cov[:-1] & ((d[1:] - d[:-1]).abs() <= tol * d[:-1])
    keep = cov & ~dup
    order = torch.argsort((~keep).to(torch.int8), dim=0, stable=True)
    d = torch.where(keep, d, torch.inf).gather(0, order)
    return d, keep.sum(0), dup.any(0) & cov.all(0)


def _layer_numbers(got_layers, ref_layers, cam):
    """(pixels where the transparent peels disagree, pixels either covers):
    a surface (duplicates merged) whose camera distance differs by more than
    2e-3 of it plus the depth plane's rounding, or a surface fewer on a side
    that had no layer to spare for it (a duplicate takes one of the
    configuration's layers, so a side that merged one and covered every
    layer may hold a surface fewer; a side with a layer left empty has
    peeled every surface in front of Depth)."""
    rel = torch.stack([r for _, _, r in ref_layers]).amax(0)
    tol = 2e-3 + DEPTH_ROUNDING * rel
    dp, n_p, dup_p = _surfaces(got_layers, cam, tol)
    dr, n_r, dup_r = _surfaces(ref_layers, cam, tol)
    both = torch.arange(dp.shape[0], device=dp.device)[:, None, None] < torch.minimum(n_p, n_r)
    far = (both & ((dp - dr).abs() > tol * dr)).any(0)
    fewer = ((n_p < n_r) & ~dup_p) | ((n_r < n_p) & ~dup_r)
    return int((far | fewer).sum()), int(((n_p > 0) | (n_r > 0)).sum())


def _numbers(got, ref, cap, h):
    """The seven numbers, ``got`` standing for the program's outputs."""
    cov_p, cov_r = got["src"] >= 0, ref["src"] >= 0
    dp, dr = got["depth"].float(), ref["depth"].float()
    tol = 1e-3 * dr.abs() + DEPTH_ROUNDING * ref["depth_cond"] + 1e-7
    off = (cov_p != cov_r) | (cov_p & cov_r & ((dp - dr).abs() > tol))
    li_p, li_r = got["light_idx"].long(), ref["light_idx"].long()
    live = int((li_p >= 0).sum()) or 1
    cam = torch.from_numpy(h["eye"]).to(ref["wpos"].device)
    cov = cap["tid"] >= 0
    dist = torch.linalg.vector_norm(ref["wpos"].float() - cam, dim=-1).clamp(min=1e-6)
    pos_off = (torch.linalg.vector_norm(got["wpos"].float() - ref["wpos"].float(), dim=-1)
               > 2e-3 * dist)[cov]
    gb_cov = cap["b3"][0].coverage[:h["height"], :h["width"]] > 0.5
    t_off, t_all = _layer_numbers(got["t_layers"], ref["t_layers"], cam)
    return {
        "raster_px_off": float(off.float().mean()),
        "light_list_off": float((li_p != li_r).sum()) / live,
        "gbuffer_pos_off": 1.0 if bool((gb_cov != cov).any())
        else float(pos_off.float().mean()) if pos_off.numel() else 0.0,
        "transparent_layer_off": t_off / max(t_all, 1),
        "shade_gap": float(_gaps(got["b3"], ref["b3"]).max()),
        "transparent_px_off": float((_gaps(got["main_t"], ref["main_t"]) > 1e-3).any(-1)
                                    .float().mean()),
        "final_gap": float((got["final"].float() - ref["final"].float()).abs().max()),
    }


def program_outputs(cap):
    tid = cap["tid"]
    src = torch.where(tid >= 0, cap["src"].long()[tid.clamp(min=0).long()], -1)
    gb = cap["b3"][0]
    h, w = tid.shape
    # RenderTransparent shades its layers farthest first
    layers = [(g.coverage[:h, :w] > 0.5, g.world_position[:h, :w], None)
              for g, _ in reversed(cap["t_layers"])]
    return {"depth": cap["depth"], "src": src, "light_idx": cap["light_idx"],
            "wpos": gb.world_position[:h, :w], "t_layers": layers, "b3": cap["b3_out"],
            "main_t": cap["main_out_t"], "final": cap["final"]}


def judge(cap, h, device, settings) -> dict:
    ref = _stages(cap, h, torch.float32, device, settings)
    return _numbers(program_outputs(cap), ref, cap, h)


def control(cap, h, device, settings, dtype=torch.bfloat16) -> dict:
    """The numbers with the reference in ``dtype`` in the program's place."""
    ref = _stages(cap, h, torch.float32, device, settings)
    low = _stages(cap, h, dtype, device, settings)
    return _numbers(low, ref, cap, h)
