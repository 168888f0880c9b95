"""Texture sampling, min pyramids and gather-free upsampling (counterpart of
sailor_tpu/kernels/sampling.py).

What the port has: ``sample_nearest`` and ``sample_bilinear`` with the
clamp, repeat and mirror wraps (shadow lookups, cubemaps, the BRDF LUT,
chromatic aberration), ``blit``, ``downsample2x_min`` and
``build_min_pyramid`` (DepthHighZ and the HiZ cull), and
``upsample_bilinear_pow2`` (the reduced-resolution terms) with its
row-sharded form ``upsample_bilinear_pow2_sharded``. Plain PyTorch on the
input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from sailor_tpu_torch.core.math3d import fma, fma_scalar


def _wrap_index(i, n: int, mode: str):
    """Integer texel coordinates wrapped into [0, n): clamp to the edge,
    repeat (``torch.remainder`` takes the divisor's sign, as
    ``jnp.remainder``) or mirror."""
    if mode == "clamp":
        return torch.clamp(i, 0, n - 1)
    if mode == "repeat":
        return torch.remainder(i, n)
    if mode == "mirror":
        period = 2 * n - 2 if n > 1 else 1
        i = torch.remainder(i, period)
        return torch.where(i >= n, period - i, i)
    raise ValueError(f"unknown wrap mode {mode}")


def _fetch(img, y, x):
    """Texels at integer (y, x) through one flat row index."""
    h, w = img.shape[0], img.shape[1]
    flat = img.reshape((h * w,) + tuple(img.shape[2:]))
    return flat[y.long() * w + x.long()]


def sample_nearest(img, uv, wrap: str = "clamp"):
    """Nearest-texel sample. ``img``: (H, W, C) or (H, W); ``uv``: (..., 2)
    in [0, 1] with (u, v) = (x, y), v = 0 at the top row."""
    h, w = img.shape[0], img.shape[1]
    x = _wrap_index(torch.floor(uv[..., 0] * w).to(torch.int32), w, wrap)
    y = _wrap_index(torch.floor(uv[..., 1] * h).to(torch.int32), h, wrap)
    return _fetch(img, y, x)


def sample_bilinear(img, uv, wrap: str = "clamp"):
    """Bilinear sample with the texel-centre convention (uv * size - 0.5)."""
    h, w = img.shape[0], img.shape[1]
    return _bilinear_at(img, uv[..., 0] * w - 0.5, uv[..., 1] * h - 0.5, wrap)


def _bilinear_at(img, fx, fy, wrap: str = "clamp"):
    """Bilinear sample at texel coordinates (fx, fy) (texel centres at
    integers)."""
    h, w = img.shape[0], img.shape[1]
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x0f, fy - y0f
    if img.ndim == 3:
        tx, ty = tx[..., None], ty[..., None]
    x0, y0 = x0f.to(torch.int32), y0f.to(torch.int32)
    x0c, x1c = _wrap_index(x0, w, wrap), _wrap_index(x0 + 1, w, wrap)
    y0c, y1c = _wrap_index(y0, h, wrap), _wrap_index(y0 + 1, h, wrap)
    c00, c10 = _fetch(img, y0c, x0c), _fetch(img, y0c, x1c)
    c01, c11 = _fetch(img, y1c, x0c), _fetch(img, y1c, x1c)
    tx, ty = tx.expand(c00.shape), ty.expand(c00.shape)
    # each lerp one fused multiply-add, as the reference's compiled code
    top = fma(c10 - c00, tx, c00)
    bot = fma(c11 - c01, tx, c01)
    return fma(bot - top, ty, top)


def blit(src, dst_hw: tuple[int, int], *, filter: str = "bilinear"):
    """Resize-copy ``src`` to ``dst_hw`` (BlitNode): the same size returns
    ``src`` itself, a resize samples at the destination's texel centres.
    The bilinear resize takes its texel coordinates as the reference's
    compiled blit folds them: ((i + 0.5) / h) * H - 0.5 becomes
    fma(i + 0.5, float32(H) / float32(h), -0.5), equal for power-of-two
    ratios and the compiled rounding for the others."""
    h, w = dst_hw
    if (src.shape[0], src.shape[1]) == (h, w):
        return src
    dev = src.device
    if filter == "nearest":
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        return sample_nearest(src, torch.stack([xx, yy], dim=-1))

    def coords(n, size):
        scale = float(np.float32(size) / np.float32(n))
        i = torch.arange(n, dtype=torch.float32, device=dev) + 0.5
        return fma(i, torch.tensor(scale, device=dev), torch.tensor(-0.5, device=dev))

    fy, fx = torch.meshgrid(coords(h, src.shape[0]), coords(w, src.shape[1]), indexing="ij")
    return _bilinear_at(src, fx, fy)


def _upsample_axis(x, f: int, axis: int, prev_edge=None, next_edge=None):
    """Bilinear upsample of one axis by the integer factor ``f``: output
    sample f*j + p reads source coordinate j + (p + 0.5)/f - 0.5, a fixed
    blend of pixel j with one edge-clamped neighbour (texel-centre
    convention, as a bilinear blit), rounded as fma(neighbour, weight,
    x * weight) like the reference's compiled pass. ``prev_edge``/``next_edge`` replace
    the clamped neighbours of the first and the last sample."""
    n = x.shape[axis]
    first = x.narrow(axis, 0, 1) if prev_edge is None else prev_edge
    last = x.narrow(axis, n - 1, 1) if next_edge is None else next_edge
    prev = torch.cat([first, x.narrow(axis, 0, n - 1)], axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), last], axis)
    phases = []
    for p in range(f):
        o = (p + 0.5) / f - 0.5
        # fma(neighbour, its weight, x * x's weight), as the reference's
        # compiled upsample rounds the blend
        if o < 0.0:
            phases.append(fma_scalar(prev, -o, x * (1.0 + o)))
        elif o > 0.0:
            phases.append(fma_scalar(nxt, o, x * (1.0 - o)))
        else:
            phases.append(x)
    st = torch.stack(phases, dim=axis + 1)  # (..., n, f, ...)
    return st.reshape(tuple(x.shape[:axis]) + (n * f,) + tuple(x.shape[axis + 1:]))


def upsample_bilinear_pow2(src, dst_hw: tuple[int, int], prev_row=None, next_row=None):
    """Bilinear resize-up of (h, w[, C]) by integer factors to (H, W[, C]):
    f = ceil(H / h) rows a source row (likewise columns), cropped to H x W.
    ``prev_row``/``next_row``: (1, w[, C]) rows above and below ``src``
    (a row slice's neighbours) in place of its clamped edge rows."""
    H, W = dst_hw
    h, w = src.shape[0], src.shape[1]
    out = _upsample_axis(_upsample_axis(src, -(-H // h), 0, prev_row, next_row),
                         -(-W // w), 1)
    return out[:H, :W]


def upsample_bilinear_pow2_sharded(src, dst_hw: tuple[int, int], comm):
    """``upsample_bilinear_pow2`` of one shard's row slice, equal to the
    whole frame's upsample sliced: each shard reads one source row from
    each neighbour (``comm.neighbour_rows``); the first shard keeps the
    clamped top edge, the last the clamped bottom edge."""
    if comm is None or comm.size <= 1:
        return upsample_bilinear_pow2(src, dst_hw)
    top, bot = src[:1], src[-1:]
    prev_row, next_row = comm.neighbour_rows(top, bot)
    return upsample_bilinear_pow2(src, dst_hw,
                                  prev_row=top if prev_row is None else prev_row,
                                  next_row=bot if next_row is None else next_row)


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
