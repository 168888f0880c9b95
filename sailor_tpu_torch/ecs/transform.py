"""Hierarchical transforms (counterpart of sailor_tpu/ecs/transform.py,
Runtime/ECS/TransformECS.cpp).

The whole pool recomputes at once: one ``trs`` over every slot, then one
batched 4x4 product per hierarchy level (world[i] = world[parent[i]] @
local[i]). It runs on the host in float32 and rounds as the reference's
compiled ``compute_world_matrices`` does on a CPU: ``math3d.trs``, and
each product's entry a chain of fused multiply-adds over k = 0..3. The
camera and the light table read this host copy; only the instances'
matrices go to the device (``StaticMeshSystem``).
"""

from __future__ import annotations

import numpy as np
import torch

from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.ecs.ecs import ComponentPool, System, SystemRegistry


def compute_world_matrices(position, rotation, scale, parent, levels: int) -> np.ndarray:
    """(N, 4, 4) float32 world matrices of N slots; ``parent`` (N,) int32,
    -1 for roots; ``levels`` the depth to resolve."""
    local = m3.trs(torch.from_numpy(np.asarray(position, np.float32)),
                   torch.from_numpy(np.asarray(rotation, np.float32)),
                   torch.from_numpy(np.asarray(scale, np.float32)))
    parent = torch.from_numpy(np.asarray(parent, np.int32)).long()
    is_root = (parent < 0)[:, None, None]
    safe_parent = torch.clamp(parent, min=0)
    cols = local.transpose(-1, -2)[:, None, :, :]  # (N, 1, j, k): local[k, j]
    world = local
    for _ in range(levels):
        prod = m3.dot(world[safe_parent][:, :, None, :], cols)  # sum over k
        world = torch.where(is_root, local, prod)
    return world.numpy()


@SystemRegistry.register
class TransformSystem(System):
    """Order 0 (the reference's TransformECS order)."""

    order = 0
    name = "Transform"

    def __init__(self, world=None, capacity: int = 1024):
        super().__init__(world)
        self.pool = ComponentPool(
            {
                "position": ((3,), np.float32, 0.0),
                "rotation": ((4,), np.float32, (0, 0, 0, 1)),
                "scale": ((3,), np.float32, 1.0),
                "parent": ((), np.int32, -1),
            },
            capacity,
        )
        self.world_matrices: np.ndarray | None = None  # host (N, 4, 4) after tick
        self._depth = 1
        # change counter: the lighting snapshot and the static-mesh
        # transform compare against it instead of scanning matrices
        self.version = 0
        self._computed_version = -1

    def add(self, position=(0, 0, 0), rotation=(0, 0, 0, 1), scale=(1, 1, 1),
            parent: int = -1) -> int:
        h = self.pool.acquire()
        self.pool.position[h] = position
        self.pool.rotation[h] = rotation
        self.pool.scale[h] = scale
        self.pool.parent[h] = parent
        self.version += 1
        return h

    def set_position(self, h: int, p) -> None:
        self.pool.position[h] = p
        self.version += 1

    def set_rotation(self, h: int, q) -> None:
        self.pool.rotation[h] = q
        self.version += 1

    def set_scale(self, h: int, s) -> None:
        self.pool.scale[h] = s
        self.version += 1

    def set_parent(self, h: int, parent: int) -> None:
        self.pool.parent[h] = parent
        self.version += 1

    def hierarchy_depth(self) -> int:
        parent = self.pool.parent
        depth = 1
        cur = parent[self.pool.alive]
        seen = 0
        while (cur >= 0).any() and seen < 64:
            cur = np.where(cur >= 0, parent[np.maximum(cur, 0)], -1)
            depth += 1
            seen += 1
        return depth

    def tick(self, dt: float) -> None:
        if self.world_matrices is not None and self._computed_version == self.version:
            return  # nothing moved since the last recompute
        self._depth = self.hierarchy_depth()
        self.world_matrices = compute_world_matrices(
            self.pool.position, self.pool.rotation, self.pool.scale, self.pool.parent,
            levels=self._depth)
        self._computed_version = self.version

    def world_matrix(self, h: int) -> np.ndarray:
        return self.world_matrices[h]
