"""Bloom mip chain (counterpart of sailor_tpu/kernels/bloom.py;
ComputeBloomDownscale/Upscale.shader): a 13-tap downsample with the Karis
average and a quadratic threshold on the first mip, then a 3x3 tent
upsample accumulated back up the chain, with lens dirt on the last one.
Every tap is a clamped shift of a whole image; plain PyTorch on its device.
"""

from __future__ import annotations

import numpy as np
import torch


def lens_dirt(height: int, width: int, seed: int = 7):
    """Procedural lens-dirt texture (H, W, 1) float32 numpy: soft smudges
    and bokeh rings from a seeded generator (BloomNode.cpp loads one from
    disk). The Bloom node keeps the one of its resolution."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    d = np.zeros((height, width), np.float32)
    diag = float(np.hypot(height, width))
    for _ in range(60):  # smudges
        cy, cx = rng.uniform(0, height), rng.uniform(0, width)
        r = rng.uniform(0.01, 0.05) * diag
        a = rng.uniform(0.1, 0.5)
        d += a * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r)))
    for _ in range(14):  # bokeh rings
        cy, cx = rng.uniform(0, height), rng.uniform(0, width)
        r0 = rng.uniform(0.02, 0.08) * diag
        t = rng.uniform(0.08, 0.25) * r0
        a = rng.uniform(0.2, 0.7)
        rr = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        d += a * np.exp(-((rr - r0) ** 2) / (2 * t * t))
    d = d / max(d.max(), 1e-6)
    return (d[..., None] ** 1.5).astype(np.float32)


def _luma(rgb):
    return rgb[..., 0] * 0.2126729 + rgb[..., 1] * 0.7151522 + rgb[..., 2] * 0.0721750


def _karis_avg(c):
    return c / (1.0 + _luma(c))[..., None]


def quadratic_threshold(color, threshold: float, knee: float):
    """Soft knee: curve = (threshold - knee, 2 knee, 0.25 / knee)."""
    br = color.amax(-1)
    rq = torch.clamp(br - (threshold - knee), 0.0, 2.0 * knee)
    rq = (0.25 / max(knee, 1e-4)) * rq * rq
    scale = torch.maximum(rq, br - threshold) / torch.clamp(br, min=1e-4)
    return color * scale[..., None]


def _stride2(img):
    """The even texels (rows and columns 0, 2, 4, ...), odd last ones dropped."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    return img[:h2 * 2:2, :w2 * 2:2]


def _sample_at(img, dy: int, dx: int):
    """img shifted by (dy, dx) texels with clamp-to-edge."""
    if dy == 0 and dx == 0:
        return img
    h, w = img.shape[0], img.shape[1]
    rows = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[rows][:, cols]


def downsample_13tap(img, *, use_threshold=False, threshold=1.0, knee=0.5):
    """Half-resolution downsample with the Jimenez14 13-tap partial Karis
    average: (H, W, 3) -> (H // 2, W // 2, 3)."""
    full = _stride2(img)

    def g(dy, dx):
        return _sample_at(full, dy, dx)

    A, B, C = g(-1, -1), g(-1, 0), g(-1, 1)
    F, G, H = g(0, -1), g(0, 0), g(0, 1)
    K, L, M = g(1, -1), g(1, 0), g(1, 1)
    D = (A + B + G + F) * 0.25
    E = (B + C + H + G) * 0.25
    I = (F + G + L + K) * 0.25  # noqa: E741
    J = (G + H + M + L) * 0.25
    c = _karis_avg((D + E + I + J) * 0.125)
    c = c + _karis_avg((A + B + G + F) * 0.03125)
    c = c + _karis_avg((B + C + H + G) * 0.03125)
    c = c + _karis_avg((F + G + L + K) * 0.03125)
    c = c + _karis_avg((G + H + M + L) * 0.03125)
    if use_threshold:
        c = quadratic_threshold(c, threshold, knee)
    return c


def upsample_tent(img, out_hw):
    """3x3 tent filter, then a nearest 2x upscale cropped (or edge-padded)
    to ``out_hw``."""
    h, w = out_hw

    def s(dy, dx):
        return _sample_at(img, dy, dx)

    tent = (s(-1, -1) + 2 * s(-1, 0) + s(-1, 1)
            + 2 * s(0, -1) + 4 * s(0, 0) + 2 * s(0, 1)
            + s(1, -1) + 2 * s(1, 0) + s(1, 1)) * (1.0 / 16.0)
    up = tent.repeat_interleave(2, 0).repeat_interleave(2, 1)
    ph, pw = max(0, h - up.shape[0]), max(0, w - up.shape[1])
    if ph or pw:
        rows = torch.clamp(torch.arange(up.shape[0] + ph, device=up.device), max=up.shape[0] - 1)
        cols = torch.clamp(torch.arange(up.shape[1] + pw, device=up.device), max=up.shape[1] - 1)
        up = up[rows][:, cols]
    return up[:h, :w]


def bloom(img, *, num_mips: int = 6, threshold: float = 1.0, knee: float = 0.5,
          intensity: float = 1.0, dirt=None, dirt_intensity: float = 0.0):
    """The bloom contribution at the input's resolution (BloomNode.cpp):
    threshold and downsample chain, tent-upsample accumulation, optional
    lens dirt on the last upsample. The caller adds it."""
    mips = []
    cur = downsample_13tap(img, use_threshold=True, threshold=threshold, knee=knee)
    mips.append(cur)
    for _ in range(1, num_mips):
        if min(cur.shape[0], cur.shape[1]) < 4:
            break
        cur = downsample_13tap(cur)
        mips.append(cur)
    acc = mips[-1]
    for m in reversed(range(len(mips) - 1)):
        acc = mips[m] + upsample_tent(acc, mips[m].shape[:2]) * intensity
    out = upsample_tent(acc, img.shape[:2]) * intensity
    if dirt is not None and dirt_intensity > 0.0:
        out = out + dirt * (dirt_intensity * out)
    return out
