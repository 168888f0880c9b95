"""Frame time of the HiZ occlusion cull on an occlusion-heavy scene
(counterpart of the JAX package's tools/time_hiz.py).

The flagship camera overlooks a mostly visible scene (4-6% culled), which
cannot show the cull paying for itself. This scene is the case the
reference's ComputeMeshCulling.shader targets: a near wall hides a dense
field of cubes behind it. Each of ``hiz_culling`` on and off renders all
of content/DefaultRenderer.renderer: a first frame, then 2 x TH_FRAMES
frames (each with its delta time nudged, as the reference does), and
prints the best mean frame time of the two runs and the last frame's
culled triangle count.

Settings (environment, as in the reference): TH_W, TH_H (1920 x 1088),
TH_CUBES (2000), TH_LIGHTS (1000), TH_FRAMES (8).

Usage:
  python -m sailor_tpu_torch.tools.time_hiz          # the card
  python -m sailor_tpu_torch.tools.time_hiz --cpu    # the plain twins (set small TH_*)
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

RENDERER = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "content", "DefaultRenderer.renderer")
#: the reference's frame graph config for both runs (hiz_culling added per run)
CONFIG = {"z_far": 150.0, "shadow_resolution": 1024, "env_resolution": 32,
          "bin_capacity": 1024, "bin_rounds": 4, "max_lights_per_tile": 128,
          "pallas_shading": True, "fused_resolve": True}


def settings() -> dict:
    """The TH_* settings with the reference's defaults."""
    env = os.environ.get
    return {"width": int(env("TH_W", "1920")), "height": int(env("TH_H", "1088")),
            "n_cubes": int(env("TH_CUBES", "2000")), "n_lights": int(env("TH_LIGHTS", "1000")),
            "frames": int(env("TH_FRAMES", "8"))}


def occlusion_heavy_scene(width: int, height: int, n_cubes: int, n_lights: int,
                          device="cuda"):
    """The reference tool's scene: an 80 m ground, a 40 m wall 6 m up at
    z = 0 facing the camera (0, 5, 18), ``n_cubes`` cubes of 0.5-1.2 m
    behind it and ``n_lights`` point lights plus the sun, from the same
    seeded RNG calls in the same order."""
    from sailor_tpu_torch.assets import primitives
    from sailor_tpu_torch.config import resolve_device
    from sailor_tpu_torch.core import math3d as m3
    from sailor_tpu_torch.kernels.lights import DIRECTIONAL, POINT, Lights
    from sailor_tpu_torch.kernels.sky import SkyParams
    from sailor_tpu_torch.raster.setup import Geometry
    from sailor_tpu_torch.rhi.scene_view import SceneView
    from sailor_tpu_torch.rhi.types import FrameData

    dev = resolve_device(device)
    rot = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    t_wall = rot.copy()
    t_wall[:3, 3] = [0, 6.0, 0.0]
    items = [(primitives.plane(80.0), np.eye(4)), (primitives.plane(40.0), t_wall)]
    rng = np.random.default_rng(9)
    for _ in range(n_cubes):
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = [rng.uniform(-15, 15), rng.uniform(0.4, 10.0), rng.uniform(-25, -4)]
        items.append((primitives.cube(rng.uniform(0.5, 1.2)), t))
    soup = primitives.merge(items)
    geo = Geometry(**{k: torch.from_numpy(np.ascontiguousarray(soup[k])).to(dev)
                      for k in ("position", "normal", "uv", "color", "indices", "material_id")})
    n = n_lights
    lp = np.stack([rng.uniform(-20, 20, n), rng.uniform(0.3, 8.0, n),
                   rng.uniform(-20, 12, n)], -1)
    lights = Lights.from_host(
        types=[DIRECTIONAL] + [POINT] * n,
        positions=np.concatenate([[[0, 0, 0]], lp]),
        directions=np.concatenate([[[-0.3, -0.8, -0.3]], np.tile([[0, -1, 0]], (n, 1))]),
        intensities=np.concatenate([[[3.0, 2.9, 2.6]], rng.uniform(0.3, 1, (n, 3)) * 6]),
        attenuations=[[1, 0, 0.8]] * (n + 1),
        radii=[0.0] + list(rng.uniform(2.0, 5.0, n)),
        device=dev,
    )
    f32 = dict(dtype=torch.float32, device=dev)
    cam = torch.tensor([0.0, 5.0, 18.0], **f32)
    view = m3.look_at(cam, torch.tensor([0.0, 5.0, 0.0], **f32),
                      torch.tensor([0.0, 1.0, 0.0], **f32))
    proj = m3.perspective(math.pi / 3, width / height, 0.1, 150.0, device=dev)
    frame = FrameData.create(view, proj, cam, 0.1, 150.0, dt=1 / 60)
    return SceneView.create(geo, lights, frame,
                            sky=SkyParams.default(sun_direction=(-0.3, -0.8, -0.3)))


def nudged(scene, eps: float):
    """The scene with its frame's delta time moved by ``eps`` seconds."""
    f = scene.frame
    return dataclasses.replace(scene, frame=dataclasses.replace(
        f, delta_time=f.delta_time + eps))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run the plain twins on the CPU")
    args = ap.parse_args(argv)

    from sailor_tpu_torch.config import resolve_device
    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset

    device = resolve_device("cpu" if args.cpu else "cuda")
    s = settings()
    w, h, frames = s["width"], s["height"], s["frames"]
    scene = occlusion_heavy_scene(w, h, s["n_cubes"], s["n_lights"], device)
    total = int(scene.geometry.indices.shape[0])
    print(f"# occlusion scene: {total} tris ({s['n_cubes']} cubes behind a wall), "
          f"{s['n_lights']} lights, {w}x{h}, device={device}", file=sys.stderr)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for hiz in (True, False):
        fg = FrameGraph(FrameGraphAsset.load(RENDERER), w, h, config=dict(CONFIG, hiz_culling=hiz),
                        device=device)
        state = fg.initial_state()
        fg.prepare(scene, state)
        t0 = time.perf_counter()
        targets, state = fg.process(scene, state)
        sync()
        print(f"# hiz={hiz}: first frame {time.perf_counter() - t0:.1f}s", file=sys.stderr)
        times = []
        for rep in range(2):
            t0 = time.perf_counter()
            for i in range(frames):
                targets, state = fg.process(nudged(scene, 1e-6 * (rep * frames + i + 1)), state)
            sync()
            times.append((time.perf_counter() - t0) / frames)
        culled = int(targets.get("HiZCulledCount", 0))
        best = min(times)
        print(f"hiz={int(hiz)}  frame {best * 1e3:.1f} ms  ({1.0 / best:.2f} FPS)  "
              f"culled {culled}/{total} ({100.0 * culled / total:.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
