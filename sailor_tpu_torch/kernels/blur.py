"""Separable Gaussian blurs (counterpart of sailor_tpu/kernels/blur.py;
Blur.shader, HBAO_Blur.shader and the EVSM shadow blur of Lighting.glsl).

The weights are a normalised half-Gaussian (sigma ~ radius / 2) and a pass
is a sum of edge-clamped shifts of the whole image, added in the
reference's order: w[0] first, then each (+i, -i) pair in turn, each by a
fused multiply-add.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sailor_tpu_torch.core.math3d import fma_scalar

MAX_RADIUS = 12  # the reference's stepCount


@functools.cache
def half_gaussian_weights(radius: int) -> tuple[float, ...]:
    """Half-kernel weights w[0..radius-1]; w[0] counts once, the others twice."""
    radius = max(1, min(int(radius), MAX_RADIUS))
    sigma = max(radius / 2.0, 0.75)
    x = np.arange(radius, dtype=np.float64)
    w = np.exp(-0.5 * (x / sigma) ** 2)
    norm = w[0] + 2.0 * w[1:].sum()
    return tuple((w / norm).tolist())


def _shift(img, d: int, axis: int):
    """img shifted by d along ``axis`` with clamp-to-edge: out[i] = img[clamp(i + d)]."""
    if d == 0:
        return img
    n = img.shape[axis]
    idx = torch.clamp(torch.arange(n, device=img.device) + d, 0, n - 1)
    return img.index_select(axis, idx)


def blur_1d(img, radius: int, axis: int):
    """One separable Gaussian pass along ``axis``; each pair's term is
    added by one fused multiply-add, as the reference's compiled pass
    rounds it."""
    w = half_gaussian_weights(radius)
    out = img * w[0]
    for i in range(1, len(w)):
        out = fma_scalar(_shift(img, i, axis) + _shift(img, -i, axis), w[i], out)
    return out


def blur_rows_sharded(img, radius: int, comm):
    """Vertical ``blur_1d`` of one shard's row slice, equal to the whole
    frame's pass sliced: ``radius`` halo rows from each neighbour
    (``postprocess.exchange_row_halo``), the blur of the extended window
    (its edge-clamped reads land in the halo only), the centre cropped."""
    from sailor_tpu_torch.kernels.postprocess import exchange_row_halo

    r = max(1, min(int(radius), MAX_RADIUS))
    ext = exchange_row_halo(img, r, comm)
    return blur_1d(ext, radius, 0)[r:-r]


def gaussian_blur(img, radius: int):
    """Full separable blur: vertical, then horizontal (Blur.shader)."""
    return blur_1d(blur_1d(img, radius, 0), radius, 1)


def evsm_blur(moments, radius_pos: int, radius_neg: int, axis: int):
    """EVSM moment blur with separate radii for the positive (xy) and
    negative (zw) moment pairs of (H, W, 4) moments (GaussianBlur_Evsm)."""
    pos = blur_1d(moments[..., :2], radius_pos, axis)
    neg = blur_1d(moments[..., 2:], radius_neg, axis)
    return torch.cat([pos, neg], dim=-1)
