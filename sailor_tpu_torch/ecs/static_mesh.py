"""Static-mesh renderer system (counterpart of sailor_tpu/ecs/static_mesh.py,
Runtime/ECS/StaticMeshRendererECS.cpp).

One local-space vertex soup with a per-vertex instance id, built on the
host when the instance set changes and kept on the device; when a
transform changes, the instances' matrices (and their normal matrices,
the transposed inverses of their 3x3 parts, by LAPACK on the host as the
reference's ``jnp.linalg.inv``) go to the device and ``transform_soup``
moves every vertex there.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.ecs.ecs import System, SystemRegistry
from sailor_tpu_torch.raster.setup import Geometry


def normal_matrices(m3x3: np.ndarray) -> np.ndarray:
    """(I, 3, 3) float32 -> the transposed inverses, each by LU with
    partial pivoting and the triangular solves against the identity
    (getrf/getrs), bit-equal to the reference's batched inverse."""
    eye = np.eye(3, dtype=np.float32)
    inv = [scipy.linalg.lu_solve(scipy.linalg.lu_factor(a), eye) for a in m3x3]
    return np.ascontiguousarray(np.asarray(inv, np.float32).reshape(-1, 3, 3).transpose(0, 2, 1))


def transform_soup(local_pos, local_nrm, inst_of_vertex, matrices, normal_mats):
    """World-space positions and normals of the local soup.

    ``matrices``: (I, 3, 4) (the top rows of the world matrices);
    ``normal_mats``: (I, 3, 3); ``inst_of_vertex``: (V,) int64. Rounds as
    the reference's compiled ``_transform_soup`` on a CPU: each row a chain
    of fused multiply-adds over j = 0..2 (``math3d.dot``), the position's
    translation added after, the normal divided by max(|n|, 1e-12) with
    |n|^2 the same chain. The root is taken in float64 and rounded once:
    PyTorch's float32 sqrt on a CPU is not correctly rounded (~0.6% of
    values differ in the last bit), the reference's is."""
    m = matrices[inst_of_vertex]
    p = m3.dot(m[:, :, :3], local_pos[:, None, :]) + m[:, :, 3]
    n = m3.dot(normal_mats[inst_of_vertex], local_nrm[:, None, :])
    length = torch.sqrt(m3.dot(n, n, keepdims=True).double()).to(torch.float32)
    return p, n / torch.clamp(length, min=1e-12)


@SystemRegistry.register
class StaticMeshSystem(System):
    order = 120
    name = "StaticMesh"

    def __init__(self, world=None):
        super().__init__(world)
        self.instances: dict[int, dict] = {}  # handle -> {mesh, transform, material}
        self._next = 0
        self.geometry: Geometry | None = None
        self._topology_dirty = True
        self._soup = None          # local-space soup on the device
        self._tids = None          # (I,) transform handles
        self._seen_tversion = -1
        self._normal_cache = None  # (3x3 parts, their normal matrices)

    def add(self, mesh, transform: int, material_id: int = 0) -> int:
        h = self._next
        self._next += 1
        self.instances[h] = {"mesh": mesh, "transform": transform, "material": material_id}
        self._topology_dirty = True
        return h

    def remove(self, h: int) -> None:
        self.instances.pop(h, None)
        self._topology_dirty = True

    def _rebuild_soup(self) -> None:
        """Host: concatenate the local geometry once per topology change."""
        pos, nrm, uv, col, idx, mid, iid = [], [], [], [], [], [], []
        voff = 0
        for k, inst in enumerate(self.instances.values()):
            mesh = inst["mesh"]
            pos.append(np.asarray(mesh.positions, np.float32))
            nrm.append(np.asarray(mesh.normals, np.float32))
            uv.append(np.asarray(mesh.uvs, np.float32))
            col.append(np.asarray(mesh.colors, np.float32))
            idx.append(np.asarray(mesh.indices, np.int32) + voff)
            mid.append(np.full(len(mesh.indices), inst["material"], np.int32))
            iid.append(np.full(len(mesh.positions), k, np.int64))
            voff += len(mesh.positions)
        device = self.world.device if self.world else "cpu"
        self._soup = {k: torch.from_numpy(np.concatenate(v)).to(device) for k, v in (
            ("position", pos), ("normal", nrm), ("uv", uv), ("color", col),
            ("indices", idx), ("material_id", mid), ("instance", iid))}
        self._tids = np.asarray([i["transform"] for i in self.instances.values()], np.int32)
        self._normal_cache = None
        self._topology_dirty = False

    def _normal_matrices(self, m3x3: np.ndarray) -> np.ndarray:
        """normal_matrices, recomputed only for instances whose 3x3 part
        changed since the last call."""
        if self._normal_cache is None:
            self._normal_cache = (m3x3.copy(), normal_matrices(m3x3))
            return self._normal_cache[1]
        old, nm = self._normal_cache
        moved = np.nonzero((old != m3x3).any(axis=(1, 2)))[0]
        if len(moved):
            nm = nm.copy()
            nm[moved] = normal_matrices(m3x3[moved])
            self._normal_cache = (m3x3.copy(), nm)
        return nm

    def tick(self, dt: float) -> None:
        tsys = self.world.system("Transform") if self.world else None
        if tsys is None or tsys.world_matrices is None or not self.instances:
            return
        if self._topology_dirty:
            self._rebuild_soup()
            self._seen_tversion = -1
        if self._seen_tversion == tsys.version and self.geometry is not None:
            return  # nothing moved (version check, not an O(N) matrix scan)
        self._seen_tversion = tsys.version
        device = self._soup["position"].device
        mats = tsys.world_matrices[self._tids]
        rows = torch.from_numpy(np.ascontiguousarray(mats[:, :3, :])).to(device)
        nmats = torch.from_numpy(self._normal_matrices(mats[:, :3, :3])).to(device)
        p, n = transform_soup(self._soup["position"], self._soup["normal"],
                              self._soup["instance"], rows, nmats)
        self.geometry = Geometry(position=p, normal=n, uv=self._soup["uv"],
                                 color=self._soup["color"], indices=self._soup["indices"],
                                 material_id=self._soup["material_id"])
