"""Blue-noise mask (host, numpy) for the LDR dither of EyeAdaptation and
the path tracer's pixel jitter.

A copy of ``sailor_tpu/raytracing/bluenoise.py``: the void-and-cluster
method (Ulichney 1993) generates a toroidal 2-D mask whose rank sequence
has blue spectral distribution (same seed, same mask); the tracer tiles it
as a per-pixel jitter and rotates it per sample (``pixel_jitter``,
``rotate``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_SIGMA = 0.8  # tight kernel: strongest nearest-neighbor repulsion


def _toroidal_energy(size: int) -> np.ndarray:
    """Gaussian energy splat kernel on the torus, centered at (0, 0)."""
    ax = np.arange(size, dtype=np.float64)
    d = np.minimum(ax, size - ax)
    d2 = d[:, None] ** 2 + d[None, :] ** 2
    return np.exp(-d2 / (2.0 * _SIGMA * _SIGMA))


@functools.lru_cache(maxsize=4)
def blue_noise_mask(size: int = 64, seed: int = 17) -> np.ndarray:
    """(size, size) float32 in [0, 1): void-and-cluster rank / n."""
    rng = np.random.default_rng(seed)
    n = size * size
    kernel = _toroidal_energy(size)

    # initial pattern: 10% random ones, relaxed so clusters break up
    binary = np.zeros((size, size), bool)
    ones = rng.choice(n, n // 10, replace=False)
    binary[np.unravel_index(ones, binary.shape)] = True

    def splat(p):
        return np.roll(np.roll(kernel, p[0], axis=0), p[1], axis=1)

    def energy(b):
        return np.real(np.fft.ifft2(np.fft.fft2(b) * np.fft.fft2(kernel)))

    # relax: move tightest-cluster 1 into largest void until stable-ish
    e = energy(binary)
    for _ in range(n):
        cluster = np.unravel_index(np.argmax(np.where(binary, e, -np.inf)), e.shape)
        binary[cluster] = False
        e -= splat(cluster)
        void = np.unravel_index(np.argmin(np.where(binary, np.inf, e)), e.shape)
        if void == cluster:
            binary[cluster] = True
            e += splat(cluster)
            break
        binary[void] = True
        e += splat(void)

    rank = np.zeros((size, size), np.int64)
    work = binary.copy()
    count = int(work.sum())
    # phase 1: remove ones tightest-first -> ranks count-1 .. 0
    e = energy(work)
    for r in range(count - 1, -1, -1):
        p = np.unravel_index(np.argmax(np.where(work, e, -np.inf)), e.shape)
        work[p] = False
        e -= splat(p)
        rank[p] = r
    # phase 2: fill voids -> ranks count .. n-1
    work = binary.copy()
    e = energy(work)
    for r in range(count, n):
        p = np.unravel_index(np.argmin(np.where(work, np.inf, e)), e.shape)
        work[p] = True
        e += splat(p)
        rank[p] = r
    return (rank.astype(np.float32) + 0.5) / n


_PHI2 = 1.32471795724474602596  # plastic constant: 2-D low-discrepancy step
_A1 = 1.0 / _PHI2
_A2 = 1.0 / (_PHI2 * _PHI2)


def pixel_jitter(height: int, width: int, size: int = 64):
    """Two decorrelated (H, W) float32 blue-noise planes (tiled mask; the
    second plane is the first torus-shifted by half the tile)."""
    m = blue_noise_mask(size)
    ty = (np.arange(height) % size)[:, None]
    tx = (np.arange(width) % size)[None, :]
    u = m[ty, tx]
    v = m[(ty + size // 2) % size, (tx + size // 3) % size]
    return u.astype(np.float32), v.astype(np.float32)


def rotate(base, sample_index):
    """Cranley-Patterson rotation by the R2 low-discrepancy sequence:
    sample s of a pixel is frac(base + s * alpha), on torch tensors."""
    s = torch.as_tensor(sample_index, dtype=torch.float32, device=base[0].device)
    return (torch.remainder(base[0] + s * _A1, 1.0),
            torch.remainder(base[1] + s * _A2, 1.0))
