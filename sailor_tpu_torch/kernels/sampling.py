"""Texture sampling, min pyramids and gather-free upsampling (counterpart of
sailor_tpu/kernels/sampling.py).

What the port has: ``sample_nearest`` (the shadow lookups),
``downsample2x_min`` and ``build_min_pyramid`` (DepthHighZ and the HiZ
cull), and ``upsample_bilinear_pow2`` (RenderScene's reduced-resolution
terms). Plain PyTorch on the input's device; the sharded upsample belongs
to multi-device rendering, which is not ported.
"""

from __future__ import annotations

import torch


def sample_nearest(img, uv):
    """Nearest-texel sample with clamp-to-edge. ``img``: (H, W, C) or
    (H, W); ``uv``: (..., 2) in [0, 1] with (u, v) = (x, y), v = 0 at the
    top row. (The reference's other wrap modes serve textures, which are
    not ported on the raster path.)"""
    h, w = img.shape[0], img.shape[1]
    x = torch.clamp(torch.floor(uv[..., 0] * w).to(torch.int32), 0, w - 1)
    y = torch.clamp(torch.floor(uv[..., 1] * h).to(torch.int32), 0, h - 1)
    flat = img.reshape((h * w,) + tuple(img.shape[2:]))
    return flat[(y * w + x).long()]


def _upsample_axis(x, f: int, axis: int):
    """Bilinear upsample of one axis by the integer factor ``f``: output
    sample f*j + p reads source coordinate j + (p + 0.5)/f - 0.5, a fixed
    blend of pixel j with one edge-clamped neighbour (texel-centre
    convention, as a bilinear blit)."""
    n = x.shape[axis]
    first = x.narrow(axis, 0, 1)
    last = x.narrow(axis, n - 1, 1)
    prev = torch.cat([first, x.narrow(axis, 0, n - 1)], axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), last], axis)
    phases = []
    for p in range(f):
        o = (p + 0.5) / f - 0.5
        if o < 0.0:
            phases.append(x * (1.0 + o) + prev * (-o))
        elif o > 0.0:
            phases.append(x * (1.0 - o) + nxt * o)
        else:
            phases.append(x)
    st = torch.stack(phases, dim=axis + 1)  # (..., n, f, ...)
    return st.reshape(tuple(x.shape[:axis]) + (n * f,) + tuple(x.shape[axis + 1:]))


def upsample_bilinear_pow2(src, dst_hw: tuple[int, int]):
    """Bilinear resize-up of (h, w[, C]) by integer factors to (H, W[, C]):
    f = ceil(H / h) rows a source row (likewise columns), cropped to H x W."""
    H, W = dst_hw
    h, w = src.shape[0], src.shape[1]
    out = _upsample_axis(_upsample_axis(src, -(-H // h), 0), -(-W // w), 1)
    return out[:H, :W]


def downsample2x_min(img):
    """2x2 min reduction (the HiZ mip step; reverse-Z keeps the farthest
    depth). An odd last row or column is dropped."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    x = img[:h2 * 2, :w2 * 2]
    return x.reshape((h2, 2, w2, 2) + tuple(img.shape[2:])).amin(dim=(1, 3))


def build_min_pyramid(depth, levels: int):
    """HiZ pyramid: a list of (H >> i, W >> i) min-depth mips, level 0 the
    input; it stops early once a side is below 2."""
    mips = [depth]
    for _ in range(1, levels):
        if min(mips[-1].shape[0], mips[-1].shape[1]) < 2:
            break
        mips.append(downsample2x_min(mips[-1]))
    return mips
