"""The path tracer's benchmark scene (``bench.py``'s ``bench_trace``): a
40 m ground and eight UV spheres of radius 0.9 (24 x 48), 18,434
triangles, one default material, the analytic sky and a sun, seen at
512x512 from (0, 4, 9).

The scene is the same for every seed; ``--seed`` draws each render's
sample seed (``render_seeds``), so every seed traces the same work with
other random numbers.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.scenes import geometry


def host(args: dict, seed: int) -> dict:
    meshes = [(geometry.plane(float(args["ground"])), np.eye(4))]
    for i in range(int(args["spheres"])):
        t = np.eye(4)
        t[:3, 3] = [(i % 4 - 1.5) * 2.2, 0.9, (i // 4 - 0.5) * 2.4]
        meshes.append((geometry.uv_sphere(float(args["radius"]), int(args["rings"]),
                                          int(args["sectors"])), t))
    soup = geometry.merge(meshes, [0] * len(meshes))
    eye = np.asarray(args["camera"], np.float32)
    sun = np.asarray(args["sun_direction"], np.float32)
    return {
        "width": int(args["width"]), "height": int(args["height"]), "soup": soup,
        "material": {k: np.asarray(v, np.float32) for k, v in args["material"].items()},
        "eye": eye, "view": geometry.look_at(eye, args["target"], (0, 1, 0)),
        "proj": geometry.perspective(math.radians(float(args["fov_y_deg"])),
                                     int(args["width"]) / int(args["height"]),
                                     float(args["z_near"]), float(args["z_far"])),
        "sun_direction": sun / np.linalg.norm(sun),
        "sun_intensity": np.asarray(args["sun_intensity"], np.float32),
        "sky_zenith": np.asarray(args["sky_zenith"], np.float32),
        "sky_horizon": np.asarray(args["sky_horizon"], np.float32),
        "seed": int(seed),
    }


def render_seeds(seed: int, count: int) -> list:
    """The sample seed of each render, drawn from ``seed``: 63-bit ints."""
    words = np.random.SeedSequence(int(seed)).generate_state(2 * count, np.uint32)
    return [int(words[2 * i]) << 31 | int(words[2 * i + 1]) >> 1 for i in range(count)]


def program(h: dict, device):
    """(TraceScene, camera_pos, view, proj) of the port, from the host
    arrays."""
    import torch

    from sailor_tpu_torch.raytracing import path_tracer

    mat = h["material"]
    scene = path_tracer.scene_from_mesh(
        h["soup"], {"albedo": mat["albedo"][None], "metallic": mat["metallic"][None],
                    "roughness": mat["roughness"][None], "emissive": mat["emissive"][None]},
        sun_direction=tuple(float(x) for x in h["sun_direction"]),
        sun_intensity=tuple(float(x) for x in h["sun_intensity"]),
        sky_zenith=tuple(float(x) for x in h["sky_zenith"]),
        sky_horizon=tuple(float(x) for x in h["sky_horizon"]), tracer="auto", device=device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return scene, t(h["eye"]), t(h["view"]), t(h["proj"])
