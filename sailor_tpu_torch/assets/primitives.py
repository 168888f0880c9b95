"""Procedural mesh primitives (host, numpy).

A copy of ``sailor_tpu/assets/primitives.py`` restricted to what the port's
scenes use, so that both packages build bit-identical vertex soups from the
same calls. Meshes use GLTF conventions: right-handed, +Y up, CCW front
faces.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray    # (V, 3) f32
    uvs: np.ndarray        # (V, 2) f32
    colors: np.ndarray     # (V, 4) f32
    indices: np.ndarray    # (T, 3) i32

    @property
    def num_vertices(self) -> int:
        return len(self.positions)

    @property
    def num_triangles(self) -> int:
        return len(self.indices)


def _mesh(pos, nrm, uv, idx, color=(1, 1, 1, 1)):
    pos = np.asarray(pos, np.float32)
    return Mesh(
        positions=pos,
        normals=np.asarray(nrm, np.float32),
        uvs=np.asarray(uv, np.float32),
        colors=np.tile(np.asarray(color, np.float32), (len(pos), 1)),
        indices=np.asarray(idx, np.int32),
    )


def plane(size: float = 1.0, y: float = 0.0, uv_scale: float = 1.0) -> Mesh:
    """XZ ground plane facing +Y."""
    s = size * 0.5
    pos = [[-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s]]
    nrm = [[0, 1, 0]] * 4
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]]) * uv_scale
    idx = [[0, 2, 1], [0, 3, 2]]  # CCW seen from +Y
    return _mesh(pos, nrm, uv, idx)


def cube(size: float = 1.0) -> Mesh:
    s = size * 0.5
    faces = [
        # normal, corners (CCW from outside)
        ([0, 0, 1], [[-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]]),
        ([0, 0, -1], [[s, -s, -s], [-s, -s, -s], [-s, s, -s], [s, s, -s]]),
        ([1, 0, 0], [[s, -s, s], [s, -s, -s], [s, s, -s], [s, s, s]]),
        ([-1, 0, 0], [[-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s]]),
        ([0, 1, 0], [[-s, s, s], [s, s, s], [s, s, -s], [-s, s, -s]]),
        ([0, -1, 0], [[-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s]]),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for n, corners in faces:
        base = len(pos)
        pos.extend(corners)
        nrm.extend([n] * 4)
        uv.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
        idx.extend([[base, base + 1, base + 2], [base, base + 2, base + 3]])
    return _mesh(pos, nrm, uv, idx)


def uv_sphere(radius: float = 0.5, rings: int = 16, sectors: int = 32) -> Mesh:
    pos, nrm, uv, idx = [], [], [], []
    for r in range(rings + 1):
        theta = np.pi * r / rings
        for s in range(sectors + 1):
            phi = 2 * np.pi * s / sectors
            n = [
                np.sin(theta) * np.cos(phi),
                np.cos(theta),
                np.sin(theta) * np.sin(phi),
            ]
            pos.append([radius * c for c in n])
            nrm.append(n)
            uv.append([s / sectors, r / rings])
    stride = sectors + 1
    for r in range(rings):
        for s in range(sectors):
            a = r * stride + s
            b = a + stride
            idx.append([a, a + 1, b])
            idx.append([a + 1, b + 1, b])
    return _mesh(pos, nrm, uv, idx)


def cylinder(radius: float = 0.5, height: float = 1.0,
             sectors: int = 24, uv_scale: float = 1.0) -> Mesh:
    """Open-ended vertical cylinder centred at the origin (columns,
    flagpoles)."""
    pos, nrm, uv, idx = [], [], [], []
    for s in range(sectors + 1):
        phi = 2 * np.pi * s / sectors
        n = [np.cos(phi), 0.0, np.sin(phi)]
        for k, y in enumerate((-height / 2, height / 2)):
            pos.append([radius * n[0], y, radius * n[2]])
            nrm.append(n)
            uv.append([uv_scale * s / sectors, uv_scale * k])
    for s in range(sectors):
        a = 2 * s
        idx.append([a, a + 2, a + 1])
        idx.append([a + 1, a + 2, a + 3])
    return _mesh(pos, nrm, uv, idx)


def quad(w: float = 1.0, h: float = 1.0, uv_scale: float = 1.0) -> Mesh:
    """Vertical quad in the XY plane facing +Z (banners, foliage cards)."""
    pos = [[-w / 2, -h / 2, 0], [w / 2, -h / 2, 0],
           [w / 2, h / 2, 0], [-w / 2, h / 2, 0]]
    nrm = [[0, 0, 1]] * 4
    uv = [[0, uv_scale], [uv_scale, uv_scale], [uv_scale, 0], [0, 0]]
    idx = [[0, 1, 2], [0, 2, 3]]
    return _mesh(pos, nrm, uv, idx)


def merge(meshes_and_transforms, material_ids=None):
    """Merge (mesh, model_matrix) pairs into one vertex/index soup."""
    pos, nrm, uv, col, idx, mids = [], [], [], [], [], []
    voffset = 0
    for i, (mesh, model) in enumerate(meshes_and_transforms):
        m = np.asarray(model, np.float32)
        p = mesh.positions @ m[:3, :3].T + m[:3, 3]
        n = mesh.normals @ np.linalg.inv(m[:3, :3]).astype(np.float32)  # inverse-transpose
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        pos.append(p)
        nrm.append(n)
        uv.append(mesh.uvs)
        col.append(mesh.colors)
        idx.append(mesh.indices + voffset)
        mat = material_ids[i] if material_ids is not None else 0
        mids.append(np.full(len(mesh.indices), mat, np.int32))
        voffset += len(p)
    return {
        "position": np.concatenate(pos),
        "normal": np.concatenate(nrm),
        "uv": np.concatenate(uv),
        "color": np.concatenate(col),
        "indices": np.concatenate(idx),
        "material_id": np.concatenate(mids),
    }
