"""Camera system (counterpart of sailor_tpu/ecs/camera.py,
Runtime/ECS/CameraECS.cpp): view and projection from the transforms' world
matrices, one FrameData per camera. The constants are made on the host
(the view is ``math3d.inverse`` of the host world matrix, bit-equal to the
reference's ``jnp.linalg.inv``) and copied to the world's device, so the
frame reads nothing back."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.ecs.ecs import ComponentPool, System, SystemRegistry
from sailor_tpu_torch.rhi.types import FrameData


@SystemRegistry.register
class CameraSystem(System):
    order = 100
    name = "Camera"

    def __init__(self, world=None, capacity: int = 8):
        super().__init__(world)
        self.pool = ComponentPool(
            {
                "transform": ((), np.int32, -1),
                "fov_y": ((), np.float32, np.pi / 3),
                "aspect": ((), np.float32, 16 / 9),
                "z_near": ((), np.float32, 0.1),
                "z_far": ((), np.float32, 100.0),
            },
            capacity,
        )
        self.frames: dict[int, FrameData] = {}
        self._time = 0.0

    def add(self, transform: int, fov_y=np.pi / 3, aspect=16 / 9,
            z_near=0.1, z_far=100.0) -> int:
        h = self.pool.acquire()
        self.pool.transform[h] = transform
        self.pool.fov_y[h] = fov_y
        self.pool.aspect[h] = aspect
        self.pool.z_near[h] = z_near
        self.pool.z_far[h] = z_far
        return h

    def tick(self, dt: float) -> None:
        self._time += dt
        tsys = self.world.system("Transform") if self.world else None
        device = self.world.device if self.world else torch.device("cpu")
        self.frames = {}
        for h in np.nonzero(self.pool.alive)[0]:
            t = int(self.pool.transform[h])
            if tsys is not None and t >= 0 and tsys.world_matrices is not None:
                model = torch.from_numpy(tsys.world_matrices[t].copy())
                view = m3.inverse(model)
                cam_pos = model[:3, 3]
            else:
                view = m3.identity4()
                cam_pos = torch.zeros(3)
            z_near, z_far = float(self.pool.z_near[h]), float(self.pool.z_far[h])
            proj = m3.perspective(float(self.pool.fov_y[h]), float(self.pool.aspect[h]),
                                  z_near, z_far)
            frame = FrameData.create(view, proj, cam_pos, z_near, z_far,
                                     time=self._time, dt=dt)
            self.frames[int(h)] = dataclasses.replace(frame, **{
                f.name: getattr(frame, f.name).to(device)
                for f in dataclasses.fields(FrameData)})

    def main_frame(self) -> FrameData | None:
        if not self.frames:
            return None
        return self.frames[min(self.frames)]
