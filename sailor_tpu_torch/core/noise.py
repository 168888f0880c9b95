"""Procedural value noise and FBM (counterpart of sailor_tpu/core/noise.py):
hash-based, derivative-free, used by the sky's cloud raymarcher."""

from __future__ import annotations

import torch


def _hash3(p):
    """Spatial hash -> [0, 1) of (..., 3) integer-valued lattice coordinates.
    An integer mix: int32 products wrap and ``>>`` is arithmetic, in torch as
    in the reference, so every corner hashes bit for bit alike."""
    i = p.to(torch.int32)
    h = i[..., 0] * 374761393 + i[..., 1] * 668265263 + i[..., 2] * 1103515245
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return (h & 0x7FFFFF).to(p.dtype) * (1.0 / float(0x800000))


def value_noise3(p):
    """Trilinear value noise in [0, 1) of (..., 3) points."""
    i = torch.floor(p)
    f = p - i
    u = f * f * (3.0 - 2.0 * f)  # smoothstep fade

    def corner(dx, dy, dz):
        return _hash3(i + torch.tensor([dx, dy, dz], dtype=p.dtype, device=p.device))

    c000 = corner(0, 0, 0)
    c100 = corner(1, 0, 0)
    c010 = corner(0, 1, 0)
    c110 = corner(1, 1, 0)
    c001 = corner(0, 0, 1)
    c101 = corner(1, 0, 1)
    c011 = corner(0, 1, 1)
    c111 = corner(1, 1, 1)
    x00 = c000 + (c100 - c000) * u[..., 0]
    x10 = c010 + (c110 - c010) * u[..., 0]
    x01 = c001 + (c101 - c001) * u[..., 0]
    x11 = c011 + (c111 - c011) * u[..., 0]
    y0 = x00 + (x10 - x00) * u[..., 1]
    y1 = x01 + (x11 - x01) * u[..., 1]
    return y0 + (y1 - y0) * u[..., 2]


def fbm3(p, octaves: int = 5, gain: float = 0.5, lacunarity: float = 2.0):
    """Fractal Brownian motion over value noise; output ~[0, 1]."""
    amp = 0.5
    acc = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    norm = 0.0
    q = p
    for _ in range(octaves):
        acc = acc + amp * value_noise3(q)
        norm += amp
        amp *= gain
        q = q * lacunarity + 19.19
    return acc / norm
