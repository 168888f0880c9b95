"""Path tracer demo: a grid of material balls on a ground plane, sun and
sky (counterpart of examples/trace.py).

Usage: python -m sailor_tpu_torch.examples.trace [--size 256] [--spp 16]
       [--bounces 4] [--out /tmp/trace.png] [--cpu] [--gltf path.glb]
       [--camera X Y Z] [--target X Y Z] [--ambient R G B] [--sky]

Renders twice with ``render_cached`` (seeds 1 and 2; the second is timed),
tonemaps with ACES at 0.6 times the mean radiance and writes an sRGB PNG.
On the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from sailor_tpu_torch.assets import primitives
from sailor_tpu_torch.config import resolve_device
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.kernels import tonemap
from sailor_tpu_torch.raytracing import path_tracer as pt
from sailor_tpu_torch.utils.png import encode_png


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--out", default="/tmp/trace.png")
    ap.add_argument("--cpu", action="store_true", help="run the plain PyTorch path on the CPU")
    ap.add_argument("--gltf", default=None, help="render a GLTF/GLB file instead")
    # PathTracer.cpp:30-73's options: camera position and target, a flat
    # ambient sky, and the raymarched sky baked into the environment
    ap.add_argument("--camera", type=float, nargs=3, default=[0.0, 4.0, 9.0])
    ap.add_argument("--target", type=float, nargs=3, default=[0.0, 0.6, 0.0])
    ap.add_argument("--ambient", type=float, nargs=3, default=None,
                    help="flat ambient sky radiance (overrides the gradient)")
    ap.add_argument("--sky", action="store_true",
                    help="bake the engine's raymarched sky into the environment")
    return ap.parse_args(argv)


def scene_inputs(args):
    """(soup, materials, scene_from_mesh keywords) of the example: the GLB
    or glTF of ``--gltf``, else the ground and two rows of four balls
    (dielectric and metal, roughness 0.08 to 0.9)."""
    if args.gltf:
        from sailor_tpu_torch.assets import gltf

        soup, materials = gltf.load_merged(args.gltf)
        # the model's images too: the reference example leaves them out, so
        # its textured materials gather from an empty texture stack (which
        # JAX does silently and PyTorch refuses); tests/test_golden.py's
        # textured trace loads them so
        materials = dict(materials, images=gltf.GLTF.load(args.gltf).load_texture_images())
        print(f"gltf: {len(soup['position'])} verts, {len(soup['indices'])} tris")
    else:
        meshes = [(primitives.plane(40.0), np.eye(4))]
        mats = {"albedo": [[0.65, 0.65, 0.65]], "metallic": [0.0],
                "roughness": [0.7], "emissive": [[0, 0, 0]]}
        mat_ids = [0]
        k = 1
        for i, metallic in enumerate((0.0, 1.0)):
            for j, rough in enumerate((0.08, 0.3, 0.6, 0.9)):
                t = np.eye(4)
                t[:3, 3] = [(j - 1.5) * 2.2, 0.9, (i - 0.5) * 2.4]
                meshes.append((primitives.uv_sphere(0.9, 24, 48), t))
                mats["albedo"].append([0.8, 0.35, 0.25] if metallic < 0.5
                                      else [0.95, 0.78, 0.45])
                mats["metallic"].append(metallic)
                mats["roughness"].append(rough)
                mats["emissive"].append([0, 0, 0])
                mat_ids.append(k)
                k += 1
        soup = primitives.merge(meshes, mat_ids)
        materials = {k2: np.asarray(v, np.float32) for k2, v in mats.items()}
    sky_kw = {}
    if args.ambient is not None:
        sky_kw = {"sky_zenith": args.ambient, "sky_horizon": args.ambient}
    if args.sky:
        from sailor_tpu_torch.kernels.sky import SkyParams

        sky_kw["sky"] = SkyParams.default()
    return soup, materials, sky_kw


def build_scene(args, device) -> pt.TraceScene:
    soup, materials, sky_kw = scene_inputs(args)
    return pt.scene_from_mesh(soup, materials, device=device, **sky_kw)


def camera(args, device):
    """(camera position, view, projection) of a square image."""
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    cam = torch.tensor(args.camera, **f32)
    view = m3.look_at(cam, torch.tensor(args.target, **f32), torch.tensor([0.0, 1.0, 0.0], **f32))
    proj = m3.perspective(math.pi / 4, 1.0, 0.1, 100.0, device=device)
    return cam, view, proj


def to_png(img) -> bytes:
    """ACES at 0.6 times the mean radiance, sRGB, bytes truncated."""
    ldr = tonemap.tonemap(img, avg_luminance=float(img.mean()) * 0.6, mode="aces")
    return encode_png((m3.linear_to_srgb(ldr) * 255).cpu().numpy().astype(np.uint8))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    t0 = time.perf_counter()
    scene = build_scene(args, dev)
    print(f"BVH build: {time.perf_counter() - t0:.2f}s  ({scene.num_triangles} tris)")

    w = h = args.size
    cam, view, proj = camera(args, dev)
    kw = dict(width=w, height=h, spp=args.spp, max_bounces=args.bounces)
    t0 = time.perf_counter()
    img, rays = pt.render_cached(scene, cam, view, proj, seed=1, **kw)
    _sync(dev)
    print(f"first render: {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    img, rays = pt.render_cached(scene, cam, view, proj, seed=2, **kw)
    _sync(dev)
    dt = time.perf_counter() - t0
    n = float(rays)
    print(f"render: {dt:.2f}s  {n / 1e6:.1f} Mrays  -> {n / dt / 1e6:.2f} Mrays/s")

    with open(args.out, "wb") as f:
        f.write(to_png(img))
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
