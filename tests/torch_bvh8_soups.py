"""Triangle soups and rays for the BVH8 tests (numpy only, so that the card
tests, which run without JAX, share them with the CPU parity tests).

- ``uv``: the UV sphere of the reference's ``tests/test_native.py``;
- ``soup700``: the 700-triangle random soup of ``tests/test_sweep.py``;
- ``tracer``: ``tracer_soup(12, 24, 2)``, a plane and two spheres;
- ``deep``: 600 nested triangles whose sizes grow by 5% each, so the tree
  is deep enough that traversals drop pushes at ``MAX_STACK``;
- ``leaf_root``: 5 triangles, so the root row is a leaf.
"""

import numpy as np

from sailor_tpu_torch.assets import primitives
from sailor_tpu_torch.scenes import tracer_soup

SOUPS = ("uv", "soup700", "tracer", "deep", "leaf_root")


def _corners(positions, indices):
    return positions[indices[:, 0]], positions[indices[:, 1]], positions[indices[:, 2]]


def soup(name: str):
    """(v0, v1, v2) float32 corner arrays of the named soup."""
    if name == "uv":
        m = primitives.uv_sphere(1.0, rings=12, sectors=20)
        return _corners(m.positions, m.indices)
    if name in ("soup700", "leaf_root"):
        rng = np.random.default_rng(1)
        v0 = rng.uniform(-5, 5, (700, 3)).astype(np.float32)
        v1 = v0 + rng.uniform(-1, 1, (700, 3)).astype(np.float32)
        v2 = v0 + rng.uniform(-1, 1, (700, 3)).astype(np.float32)
        return (v0, v1, v2) if name == "soup700" else (v0[:5], v1[:5], v2[:5])
    if name == "tracer":
        s = tracer_soup(12, 24, 2)
        return _corners(s["position"], s["indices"])
    if name == "deep":
        n = 600
        rng = np.random.default_rng(0)
        scale = (1.05 ** np.arange(n))[:, None].astype(np.float32)
        c = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
        return tuple(c + scale * rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3))
    raise KeyError(name)


def rays(n: int = 3000, seed: int = 2, box: float = 8.0):
    """(origin, direction, active): origins in a cube of half-size ``box``,
    unit directions (the first 50 with x = 0, parallel to a slab), 80% of
    the rays active."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-box, box, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:50, 0] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, rng.random(n) > 0.2
