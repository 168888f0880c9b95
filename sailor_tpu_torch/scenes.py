"""Procedural scenes for the port.

``flagship_scene`` is the Forward+ benchmark scene of the JAX package's
``bench.py`` (``_build_scene``): a 60 m ground plane plus ``num_objects``
alternating UV spheres (16x32) and cubes, one directional light plus
``num_lights`` point lights, no materials. It repeats the same numpy RNG
calls in the same order, so both packages build the same scene from the
same seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sailor_tpu_torch.assets import primitives
from sailor_tpu_torch.config import resolve_device
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.kernels.lights import DIRECTIONAL, POINT, Lights
from sailor_tpu_torch.raster.setup import Geometry
from sailor_tpu_torch.rhi.scene_view import SceneView
from sailor_tpu_torch.rhi.types import FrameData


def flagship_scene(width: int, height: int, num_lights: int, num_objects: int,
                   seed: int = 11, device="cuda") -> SceneView:
    """The flagship scene at ``width`` x ``height``; 1920x1088 with 1000
    lights and 96 objects is the benchmark frame."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    instances = [(primitives.plane(60.0), np.eye(4))]
    for i in range(num_objects):
        t = np.eye(4)
        t[:3, 3] = [rng.uniform(-20, 20), rng.uniform(0.4, 2.0), rng.uniform(-20, 20)]
        mesh = (primitives.cube(rng.uniform(0.8, 2.0)) if i % 2
                else primitives.uv_sphere(rng.uniform(0.4, 1.0), 16, 32))
        instances.append((mesh, t))
    soup = primitives.merge(instances)

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    tint = torch.tensor([0.65, 0.62, 0.6, 1.0], dtype=torch.float32, device=dev)
    geo = Geometry(position=t32(soup["position"]), normal=t32(soup["normal"]),
                   uv=t32(soup["uv"]), color=t32(soup["color"]) * tint,
                   indices=t32(soup["indices"]), material_id=t32(soup["material_id"]))
    n = num_lights
    lp = np.stack([rng.uniform(-22, 22, n), rng.uniform(0.3, 3.0, n),
                   rng.uniform(-22, 22, n)], -1)
    lights = Lights.from_host(
        types=[DIRECTIONAL] + [POINT] * n,
        positions=np.concatenate([[[0, 0, 0]], lp]),
        directions=np.concatenate([[[-0.35, -0.7, -0.3]], np.tile([[0, -1, 0]], (n, 1))]),
        intensities=np.concatenate([[[3.0, 2.9, 2.6]], rng.uniform(0.3, 1, (n, 3)) * 6]),
        attenuations=[[1, 0, 0.8]] * (n + 1),
        radii=[0.0] + list(rng.uniform(2.0, 5.0, n)),
        device=dev,
    )
    f32 = dict(dtype=torch.float32, device=dev)
    cam = torch.tensor([24.0, 10.0, 26.0], **f32)
    view = m3.look_at(cam, torch.tensor([0.0, 0.5, 0.0], **f32),
                      torch.tensor([0.0, 1.0, 0.0], **f32))
    proj = m3.perspective(math.pi / 3, width / height, 0.1, 150.0, device=dev)
    frame = FrameData.create(view, proj, cam, 0.1, 150.0, dt=1 / 60)
    return SceneView.create(geo, lights, frame)
