"""Lighting system (counterpart of sailor_tpu/ecs/lighting.py,
Runtime/ECS/LightingECS.cpp). The pool is host SoA; the snapshot is a
device ``Lights`` table rebuilt only when a light or a transform changed,
with positions and directions from the host world matrices (numpy, as the
reference computes them)."""

from __future__ import annotations

import numpy as np

from sailor_tpu_torch import config
from sailor_tpu_torch.ecs.ecs import ComponentPool, System, SystemRegistry
from sailor_tpu_torch.kernels.lights import Lights


@SystemRegistry.register
class LightingSystem(System):
    order = 150
    name = "Lighting"

    MAX_LIGHTS = config.MAX_LIGHTS

    def __init__(self, world=None, capacity: int = 4096):
        super().__init__(world)
        self.version = 0  # bumped on add/remove: the snapshot's cache key
        self.pool = ComponentPool(
            {
                "transform": ((), np.int32, -1),
                "type": ((), np.int32, 0),
                "shadow_type": ((), np.int32, 0),
                "intensity": ((3,), np.float32, 1.0),
                "attenuation": ((3,), np.float32, (1, 0, 1)),
                "direction": ((3,), np.float32, (0, -1, 0)),
                "cutoff": ((2,), np.float32, (0.9, 0.7)),
                "radius": ((), np.float32, 10.0),
            },
            capacity,
        )
        self.snapshot: Lights | None = None
        self._snapshot_key = None

    def add(self, transform: int, type: int = 1, intensity=(1, 1, 1),
            attenuation=(1, 0, 1), direction=(0, -1, 0), cutoff=(0.9, 0.7),
            radius: float = 10.0, shadow_type: int = 0) -> int:
        if self.pool.num_alive >= self.MAX_LIGHTS:
            raise RuntimeError(f"light budget exceeded ({self.MAX_LIGHTS})")
        h = self.pool.acquire()
        self.pool.transform[h] = transform
        self.pool.type[h] = type
        self.pool.intensity[h] = intensity
        self.pool.attenuation[h] = attenuation
        self.pool.direction[h] = direction
        self.pool.cutoff[h] = cutoff
        self.pool.radius[h] = radius
        self.pool.shadow_type[h] = shadow_type
        self.version += 1
        return h

    def remove(self, h: int) -> None:
        self.pool.release(h)
        self.version += 1

    def tick(self, dt: float) -> None:
        tsys = self.world.system("Transform") if self.world else None
        key = (self.version, tsys.version if tsys is not None else -1)
        if self.snapshot is not None and key == self._snapshot_key:
            return
        self._snapshot_key = key
        device = self.world.device if self.world else "cpu"
        alive = np.nonzero(self.pool.alive)[0]
        n = len(alive)
        if n and tsys is not None and tsys.world_matrices is not None:
            wm = tsys.world_matrices
            tidx = self.pool.transform[alive]
            positions = wm[np.maximum(tidx, 0)][:, :3, 3]
            # the light's direction is its local direction rotated
            directions = np.einsum("nij,nj->ni", wm[np.maximum(tidx, 0)][:, :3, :3],
                                   self.pool.direction[alive])
            norms = np.linalg.norm(directions, axis=-1, keepdims=True)
            directions = directions / np.maximum(norms, 1e-12)
        else:
            positions = np.zeros((n, 3), np.float32)
            directions = self.pool.direction[alive]
        self.snapshot = Lights.from_host(
            types=self.pool.type[alive],
            positions=positions,
            directions=directions,
            intensities=self.pool.intensity[alive],
            attenuations=self.pool.attenuation[alive],
            cutoffs=self.pool.cutoff[alive],
            radii=self.pool.radius[alive],
            shadow_types=self.pool.shadow_type[alive],
            capacity=max(int(2 ** np.ceil(np.log2(max(n, 1)))), 8),
            device=device,
        ) if n else Lights.empty(8, device=device)
