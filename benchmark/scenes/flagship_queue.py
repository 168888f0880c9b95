"""The flagship queue scene: 1920x1088, one sun and 1000 point lights,
96 objects over a 60 m ground, a third of them in each of the Opaque,
Masked and Transparent queues (``bench.py``'s ``_build_scene`` with the
port's ``flagship_queue_scene`` materials).

The layout (where each object and light stands, and its size) comes from
``layout_seed``, as the project's flagship frame has it. ``--seed`` draws
what changes the values and not the work: the order of the objects and of
the lights in their tables, and the point lights' colours.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.scenes import geometry, maps

QUEUE_OPAQUE, QUEUE_MASKED, QUEUE_TRANSPARENT = 0, 1, 2


def materials(texture_size: int):
    """Four materials: 0 the ground and 1 the opaque objects (albedo and
    normal maps), 2 Masked (cutoff 0.5, an albedo whose alpha is 0/1
    stripes floor(8 v) % 2), 3 Transparent (opacity 0.5). Returns (table,
    images)."""
    m = maps.procedural_test_maps(0, texture_size)
    v = (np.arange(texture_size) + 0.5) / texture_size
    stripes = m[0].copy()
    stripes[..., 3] = (np.floor(8 * v) % 2)[:, None]
    table = {
        "albedo": np.array([[0.9, 0.9, 0.9], [1.0, 1.0, 1.0], [0.9, 0.85, 0.7],
                            [0.6, 0.8, 1.0]], np.float32),
        "metallic": np.array([0.0, 0.2, 0.0, 0.0], np.float32),
        "roughness": np.array([0.7, 0.45, 0.6, 0.1], np.float32),
        "emissive": np.zeros((4, 3), np.float32),
        "albedo_texture": np.array([0, 0, 2, 0], np.int32),
        "normal_texture": np.array([1, 1, -1, -1], np.int32),
        "queue": np.array([QUEUE_OPAQUE, QUEUE_OPAQUE, QUEUE_MASKED, QUEUE_TRANSPARENT],
                          np.int32),
        "alpha_cutoff": np.full(4, 0.5, np.float32),
        "opacity": np.array([1.0, 1.0, 1.0, 0.5], np.float32),
    }
    return table, [m[0], m[1], stripes]


def host(args: dict, seed: int) -> dict:
    """The scene's host arrays: geometry soup, lights, camera, sun and
    material table, all numpy."""
    width, height = int(args["width"]), int(args["height"])
    n_obj, n_lights = int(args["objects"]), int(args["point_lights"])
    rng = np.random.default_rng(int(args["layout_seed"]))
    objects = []
    for i in range(n_obj):
        t = np.eye(4)
        t[:3, 3] = [rng.uniform(-20, 20), rng.uniform(0.4, 2.0), rng.uniform(-20, 20)]
        mesh = (geometry.cube(rng.uniform(0.8, 2.0)) if i % 2
                else geometry.uv_sphere(rng.uniform(0.4, 1.0), int(args["sphere_rings"]),
                                        int(args["sphere_sectors"])))
        objects.append((mesh, t, 1 + i % 3))
    lp = np.stack([rng.uniform(-22, 22, n_lights), rng.uniform(0.3, 3.0, n_lights),
                   rng.uniform(-22, 22, n_lights)], -1)
    rng.uniform(0.3, 1, (n_lights, 3))  # the layout's colours, redrawn from --seed below
    radii = rng.uniform(2.0, 5.0, n_lights)

    draw = np.random.default_rng(seed)
    order = draw.permutation(n_obj)
    lorder = draw.permutation(n_lights)
    colours = draw.uniform(0.3, 1, (n_lights, 3)) * 6
    objects = [objects[k] for k in order]
    soup = geometry.merge([(geometry.plane(float(args["ground"])), np.eye(4))]
                          + [(m, t) for m, t, _ in objects],
                          [0] + [mat for _, _, mat in objects])
    soup["color"] = soup["color"] * np.array([0.65, 0.62, 0.6, 1.0], np.float32)
    sun = np.asarray(args["sun_direction"], np.float32)
    n = n_lights
    lights = {
        "type": np.array([0] + [1] * n, np.int32),  # 0 directional, 1 point
        "position": np.concatenate([[[0, 0, 0]], lp[lorder]]).astype(np.float32),
        "direction": np.concatenate([[sun], np.tile([[0, -1, 0]], (n, 1))]).astype(np.float32),
        "intensity": np.concatenate([[[3.0, 2.9, 2.6]], colours]).astype(np.float32),
        "attenuation": np.tile(np.array([[1, 0, 0.8]], np.float32), (n + 1, 1)),
        "radius": np.concatenate([[0.0], radii[lorder]]).astype(np.float32),
        "cutoff": np.zeros((n + 1, 2), np.float32),
    }
    eye = np.asarray(args["camera"], np.float32)
    near, far = float(args["z_near"]), float(args["z_far"])
    table, images = materials(int(args["texture_size"]))
    return {
        "width": width, "height": height, "soup": soup, "lights": lights,
        "eye": eye, "view": geometry.look_at(eye, args["target"], (0, 1, 0)),
        "proj": geometry.perspective(math.radians(float(args["fov_y_deg"])), width / height,
                                     near, far),
        "z_near": near, "z_far": far, "sun_direction": sun, "materials": table,
        "images": images, "texture_size": int(args["texture_size"]),
    }


def program(h: dict, device):
    """The port's SceneView built from the host arrays."""
    import torch

    from sailor_tpu_torch.assets.materials import MaterialTable
    from sailor_tpu_torch.kernels.lights import Lights
    from sailor_tpu_torch.kernels.sky import SkyParams
    from sailor_tpu_torch.raster.setup import Geometry
    from sailor_tpu_torch.rhi.scene_view import SceneView
    from sailor_tpu_torch.rhi.types import FrameData

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    s = h["soup"]
    geo = Geometry(position=t(s["position"]), normal=t(s["normal"]), uv=t(s["uv"]),
                   color=t(s["color"]), indices=t(s["indices"]),
                   material_id=t(s["material_id"]))
    lt = h["lights"]
    lights = Lights.from_host(types=list(lt["type"]), positions=lt["position"],
                              directions=lt["direction"], intensities=lt["intensity"],
                              attenuations=lt["attenuation"], cutoffs=lt["cutoff"],
                              radii=list(lt["radius"]),
                              device=device)
    mats = MaterialTable.from_host(h["materials"], h["images"],
                                   texture_size=h["texture_size"], device=device)
    frame = FrameData.create(t(h["view"]), t(h["proj"]), t(h["eye"]), h["z_near"],
                             h["z_far"], dt=1 / 60)
    sky = SkyParams.default(sun_direction=tuple(float(x) for x in h["sun_direction"]))
    return SceneView.create(geo, lights, frame, sky=sky, materials=mats)
