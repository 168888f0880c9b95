"""The canonical end-to-end frame: the whole engine frame graph -> PNG
(counterpart of examples/render_frame.py).

Usage: python -m sailor_tpu_torch.examples.render_frame [--width 640]
       [--height 384] [--lights 64] [--frames 1] [--out /tmp/frame.png] [--cpu]

Renders cubes and spheres on a ground plane lit by coloured point lights
and a directional sun through ``content/DefaultRenderer.renderer``, the
node pipeline the engine runs (visibility raster, Forward+ culling and
shading, CSM/EVSM, sky, HiZ, HBAO, bloom, exposure, tonemap, dither). On
the card the Forward+ shading runs its CUDA kernel (``pallas_shading``, as
the reference's ``--tpu`` asks); ``--cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch

from sailor_tpu_torch.assets import primitives
from sailor_tpu_torch.assets.materials import MaterialTable
from sailor_tpu_torch.config import resolve_device
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
from sailor_tpu_torch.kernels.lights import DIRECTIONAL, POINT, Lights
from sailor_tpu_torch.kernels.sky import SkyParams
from sailor_tpu_torch.raster.setup import Geometry
from sailor_tpu_torch.rhi.scene_view import SceneView
from sailor_tpu_torch.rhi.types import FrameData
from sailor_tpu_torch.utils.png import encode_png

RENDERER = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "content", "DefaultRenderer.renderer")
CONFIG = {"z_far": 100.0, "bin_capacity": 512, "bin_rounds": 3,
          "shadow_resolution": 512, "env_resolution": 16}


def build_scene(width: int, height: int, num_lights: int, device) -> SceneView:
    """The reference example's scene (numpy rng seed 7): a 40 m plane, 6
    cubes and 6 spheres in three materials, ``num_lights`` point lights and
    a sun, the camera at (10, 6, 12) looking at (0, 0.5, 0)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    instances = [(primitives.plane(40.0), np.eye(4))]
    mats = [0]
    for i in range(12):
        t = np.eye(4)
        t[:3, 3] = [rng.uniform(-8, 8), 0.5, rng.uniform(-8, 8)]
        mesh = primitives.cube(1.0) if i % 2 == 0 else primitives.uv_sphere(0.6)
        instances.append((mesh, t))
        mats.append(1 + i % 3)
    soup = primitives.merge(instances, mats)
    palette = np.asarray([[0.6, 0.6, 0.6], [0.9, 0.3, 0.25], [0.3, 0.8, 0.35],
                          [0.3, 0.4, 0.9]])
    table = {
        "albedo": palette.astype(np.float32),
        "metallic": np.asarray([0.0, 0.1, 0.1, 0.4], np.float32),
        "roughness": np.asarray([0.75, 0.4, 0.5, 0.3], np.float32),
        "emissive": np.zeros((4, 3), np.float32),
    }
    materials = MaterialTable.from_host(table, device=dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    geo = Geometry(position=t(soup["position"]), normal=t(soup["normal"]), uv=t(soup["uv"]),
                   color=t(np.ones((len(soup["position"]), 4), np.float32)),
                   indices=t(soup["indices"]), material_id=t(soup["material_id"]))

    f32 = dict(dtype=torch.float32, device=dev)
    cam = torch.tensor([10.0, 6.0, 12.0], **f32)
    view = m3.look_at(cam, torch.tensor([0.0, 0.5, 0.0], **f32),
                      torch.tensor([0.0, 1.0, 0.0], **f32))
    proj = m3.perspective(math.pi / 3, width / height, 0.1, 100.0, device=dev)

    n = num_lights
    lp = np.stack([rng.uniform(-9, 9, n), rng.uniform(0.5, 2.0, n), rng.uniform(-9, 9, n)], -1)
    lc = rng.uniform(0.3, 1.0, (n, 3)) * 4.0
    sun_dir = np.asarray([-0.35, -0.8, -0.3]) / np.linalg.norm([-0.35, -0.8, -0.3])
    lights = Lights.from_host(
        types=[DIRECTIONAL] + [POINT] * n,
        positions=np.concatenate([[[0, 0, 0]], lp]),
        directions=np.concatenate([[sun_dir], np.tile([[0, -1, 0]], (n, 1))]),
        intensities=np.concatenate([[[2.0, 1.9, 1.7]], lc]),
        attenuations=[[1, 0, 0.5]] * (n + 1),
        radii=[0.0] + [4.0] * n,
        device=dev,
    )
    frame = FrameData.create(view, proj, cam, 0.1, 100.0, dt=1 / 60)
    sky = SkyParams.default(sun_direction=tuple(sun_dir))
    return SceneView.create(geo, lights, frame, sky=sky, materials=materials)


def frame_graph(width: int, height: int, device) -> FrameGraph:
    """DefaultRenderer.renderer with the example's config; the shading
    kernel on the card, the plain shading on the CPU."""
    dev = resolve_device(device)
    return FrameGraph(FrameGraphAsset.load(RENDERER), width, height,
                      config=dict(CONFIG, pallas_shading=dev.type == "cuda"), device=dev)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--lights", type=int, default=64)
    ap.add_argument("--out", default="/tmp/frame.png")
    ap.add_argument("--cpu", action="store_true", help="run the plain PyTorch path on the CPU")
    ap.add_argument("--frames", type=int, default=1, help="timed frames after the first")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    w, h = args.width, args.height

    scene = build_scene(w, h, args.lights, dev)
    print(f"scene: {scene.geometry.position.shape[0]} verts, "
          f"{scene.geometry.indices.shape[0]} tris")
    fg = frame_graph(w, h, dev)
    state = fg.initial_state()
    fg.prepare(scene, state)

    t0 = time.perf_counter()
    targets, state = fg.process(scene, state)
    _sync(dev)
    print(f"first frame: {time.perf_counter() - t0:.2f}s  "
          f"avg_lum={float(state['avg_luminance']):.4f}")

    times = []
    for i in range(args.frames):
        # a new delta time each frame: EyeAdaptation reads it
        s = dataclasses.replace(scene, frame=dataclasses.replace(
            scene.frame, delta_time=scene.frame.delta_time + 1e-6 * (i + 1)))
        t0 = time.perf_counter()
        targets, state = fg.process(s, state)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    if times:
        ms = 1000 * min(times)
        print(f"frame: {ms:.2f} ms  ({1000 / ms:.1f} FPS)  "
              f"overflow={int(targets.get('BinOverflow', 0))}")

    img = targets["Final"].cpu().numpy()
    with open(args.out, "wb") as f:
        f.write(encode_png((np.clip(img, 0, 1) * 255).astype(np.uint8)))
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
