"""The blue-noise mask (void-and-cluster, Ulichney 1993) with the
engine's seed and kernel, on the host: the LDR dither's and the tracer's
pixel jitter's source."""

from __future__ import annotations

import functools

import numpy as np

_SIGMA = 0.8
PHI2 = 1.32471795724474602596  # plastic constant: the R2 sequence's step


@functools.lru_cache(maxsize=2)
def mask(size: int = 64, seed: int = 17) -> np.ndarray:
    """(size, size) float32 in [0, 1): void-and-cluster rank / n."""
    rng = np.random.default_rng(seed)
    n = size * size
    ax = np.arange(size, dtype=np.float64)
    d = np.minimum(ax, size - ax)
    kernel = np.exp(-(d[:, None] ** 2 + d[None, :] ** 2) / (2.0 * _SIGMA * _SIGMA))
    binary = np.zeros((size, size), bool)
    binary[np.unravel_index(rng.choice(n, n // 10, replace=False), binary.shape)] = True

    def splat(p):
        return np.roll(np.roll(kernel, p[0], axis=0), p[1], axis=1)

    def energy(b):
        return np.real(np.fft.ifft2(np.fft.fft2(b) * np.fft.fft2(kernel)))

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
    e = energy(work)
    for r in range(count - 1, -1, -1):
        p = np.unravel_index(np.argmax(np.where(work, e, -np.inf)), e.shape)
        work[p] = False
        e -= splat(p)
        rank[p] = r
    work = binary.copy()
    e = energy(work)
    for r in range(count, n):
        p = np.unravel_index(np.argmin(np.where(work, np.inf, e)), e.shape)
        work[p] = True
        e += splat(p)
        rank[p] = r
    return (rank.astype(np.float32) + 0.5) / n


def pixel_jitter(height: int, width: int, size: int = 64):
    """Two (H, W) planes: the tiled mask, and the mask torus-shifted by
    (size / 2, size / 3)."""
    m = mask(size)
    ty = (np.arange(height) % size)[:, None]
    tx = (np.arange(width) % size)[None, :]
    return (m[ty, tx].astype(np.float32),
            m[(ty + size // 2) % size, (tx + size // 3) % size].astype(np.float32))
