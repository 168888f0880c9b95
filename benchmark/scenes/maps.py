"""Seeded procedural texture maps (host, numpy) for the material scenes:
the albedo, tangent-space normal, ORM and emissive maps that the port's
``scenes.procedural_test_maps`` makes from the same seed."""

from __future__ import annotations

import numpy as np


def procedural_test_maps(seed: int, size: int) -> list:
    """[albedo (tinted checker with noise), normal (a sum of random
    waves), ORM (roughness and metallic in tiles), emissive (a few
    stripes)], each (size, size, 4) float32 with alpha 1."""
    rng = np.random.default_rng(seed)
    y, x = (np.mgrid[0:size, 0:size] + 0.5) / size
    cells = (np.floor(x * 8) + np.floor(y * 8)) % 2
    tint = rng.uniform(0.3, 0.9, (2, 3))
    albedo = np.where(cells[..., None] > 0, tint[0], tint[1])
    albedo = np.clip(albedo * rng.uniform(0.85, 1.15, (size, size, 1)), 0.0, 1.0)
    dh_dx = np.zeros((size, size))
    dh_dy = np.zeros((size, size))
    for _ in range(6):
        k = rng.uniform(-40.0, 40.0, 2)
        a = rng.uniform(0.002, 0.01)
        c = a * np.cos(k[0] * x + k[1] * y + rng.uniform(0, 2 * np.pi))
        dh_dx += c * k[0]
        dh_dy += c * k[1]
    nrm = np.stack([-dh_dx, -dh_dy, np.ones_like(x)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tiles = rng.random((4, 4))
    ti = (np.floor(y * 4).astype(int), np.floor(x * 4).astype(int))
    orm = np.stack([np.ones_like(x), 0.3 + 0.7 * tiles[ti], (tiles[ti] > 0.7) * 1.0], -1)
    emissive = np.zeros((size, size, 3))
    for yy in rng.uniform(0.05, 0.95, 3):
        emissive[np.abs(y - yy) < 0.01] = rng.uniform(0.5, 1.0, 3)
    alpha = np.ones((size, size, 1))
    return [np.concatenate([m, alpha], -1).astype(np.float32)
            for m in (albedo, nrm * 0.5 + 0.5, orm, emissive)]
