"""HiZ occlusion culling against the previous frame's min pyramid
(counterpart of sailor_tpu/raster/hiz_cull.py; ComputeMeshCulling.shader).

A raster triangle is occluded when its nearest reverse-Z (``zmax``, the
largest vertex depth: z is affine in screen space) is strictly farther than
the farthest stored depth over its footprint: the min of the pyramid texels
covering its screen AABB at the first level where that AABB spans at most
2x2 texels. Pixels never covered hold 0 and never cull; a triangle that
fits no level is not tested.
"""

from __future__ import annotations

import numpy as np
import torch


def build_flat_pyramid(mips):
    """(flat values, offsets, shapes) of a list of (Hm, Wm) min mips."""
    offsets, shapes = [], []
    off = 0
    for m in mips:
        offsets.append(off)
        shapes.append(tuple(m.shape))
        off += m.shape[0] * m.shape[1]
    flat = torch.cat([m.reshape(-1) for m in mips])
    return flat, tuple(offsets), tuple(shapes)


def occlusion_cull(valid, screen_aabb, zmax, flat_pyramid, *, offsets: tuple,
                   shapes: tuple, base_w: int, base_h: int):
    """``valid & ~occluded`` for the raster triangles.

    The level is chosen arithmetically and the footprint's min fetched once
    from a shifted-min copy of the pyramid: texel (y, x) of each level
    becomes min(p[y:y+2, x:x+2]), clamped at the border, so a footprint of
    at most 2x2 texels needs one fetch at (ty0, tx0). Texel spans are
    floor(x * (wm / base_w)) in float32, the scale rounded to float32
    first, as the reference computes them."""
    xmin, xmax, ymin, ymax = screen_aabb
    dev = valid.device
    xmin_c = torch.clamp(xmin, 0.0, base_w - 1.0)
    xmax_c = torch.clamp(xmax, 0.0, base_w - 1.0)
    ymin_c = torch.clamp(ymin, 0.0, base_h - 1.0)
    ymax_c = torch.clamp(ymax, 0.0, base_h - 1.0)

    def span(v, scale):
        return torch.floor(v * float(np.float32(scale))).to(torch.int32)

    matched = torch.zeros(valid.shape, dtype=torch.bool, device=dev)
    zero = torch.zeros(valid.shape, dtype=torch.int32, device=dev)
    sel_off, sel_wm = zero, torch.ones_like(zero)
    sel_tx0, sel_ty0 = zero, zero
    for off, (hm, wm) in zip(offsets, shapes):
        tx0, tx1 = span(xmin_c, wm / base_w), span(xmax_c, wm / base_w)
        ty0, ty1 = span(ymin_c, hm / base_h), span(ymax_c, hm / base_h)
        sel = (tx1 - tx0 <= 1) & (ty1 - ty0 <= 1) & ~matched
        sel_off = torch.where(sel, off, sel_off)
        sel_wm = torch.where(sel, wm, sel_wm)
        sel_tx0 = torch.where(sel, torch.clamp(tx0, 0, wm - 1), sel_tx0)
        sel_ty0 = torch.where(sel, torch.clamp(ty0, 0, hm - 1), sel_ty0)
        matched = matched | sel

    mins = []
    for off, (hm, wm) in zip(offsets, shapes):
        m = flat_pyramid[off:off + hm * wm].reshape(hm, wm)
        mx = torch.minimum(m, torch.cat([m[:, 1:], m[:, -1:]], dim=1))
        mxy = torch.minimum(mx, torch.cat([mx[1:], mx[-1:]], dim=0))
        mins.append(mxy.reshape(-1))
    hiz_min = torch.cat(mins)[(sel_off + sel_ty0 * sel_wm + sel_tx0).long()]
    return valid & ~(matched & (zmax < hiz_min))
