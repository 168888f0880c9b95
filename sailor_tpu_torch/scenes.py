"""Procedural scenes for the port.

``flagship_scene`` is the Forward+ benchmark scene of the JAX package's
``bench.py`` (``_build_scene``): a 60 m ground plane plus ``num_objects``
alternating UV spheres (16x32) and cubes, one directional light plus
``num_lights`` point lights, no materials. It repeats the same numpy RNG
calls in the same order, so both packages build the same scene from the
same seed.

``flagship_queue_scene`` is the same scene with a material table: the
ground and a third of the objects Opaque, a third Masked (striped alpha)
and a third Transparent, all textured with ``procedural_test_maps``.

``flagship_world_doc`` is the flagship scene as a `.world` document for
the engine (``engine.World.deserialize``): the same RNG calls give the
same objects and lights as game objects with components, and the camera
orbits.

``content_instances_scene`` is bench.py's ``--content`` scene
(``_build_content_scene``): a grid of rotated instances of one glTF model
with its textures over a ground plane, for any GLB the caller names.

``occlusion_scene`` is the HiZ test scene of the JAX package's
``tests/test_hiz_culling.py``: a wall that hides 24 cubes from the
camera, so a frame after the first culls them.

``tracer_scene`` is the path tracer's benchmark scene (``bench_trace``),
``dense_tracer_scene`` the same with finer spheres (294,914 triangles,
past the sweep's limit);
``material_balls`` is the JAX package's tracer demo scene
(``examples/trace.py``), optionally with the procedural sky and with
``procedural_test_maps`` on its ground: seeded numpy maps that stand in for
a textured asset, which the repo does not hold.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sailor_tpu_torch.assets import primitives
from sailor_tpu_torch.config import resolve_device
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.kernels.lights import DIRECTIONAL, POINT, Lights
from sailor_tpu_torch.kernels.sky import SkyParams
from sailor_tpu_torch.raster.setup import Geometry
from sailor_tpu_torch.raytracing import path_tracer
from sailor_tpu_torch.rhi.scene_view import SceneView
from sailor_tpu_torch.rhi.types import FrameData


def flagship_scene(width: int, height: int, num_lights: int, num_objects: int,
                   seed: int = 11, device="cuda") -> SceneView:
    """The flagship scene at ``width`` x ``height``; 1920x1088 with 1000
    lights and 96 objects is the benchmark frame."""
    return _flagship(width, height, num_lights, num_objects, seed, resolve_device(device))


def _flagship(width, height, num_lights, num_objects, seed, dev, material_ids=None,
              materials=None) -> SceneView:
    rng = np.random.default_rng(seed)
    instances = [(primitives.plane(60.0), np.eye(4))]
    for i in range(num_objects):
        t = np.eye(4)
        t[:3, 3] = [rng.uniform(-20, 20), rng.uniform(0.4, 2.0), rng.uniform(-20, 20)]
        mesh = (primitives.cube(rng.uniform(0.8, 2.0)) if i % 2
                else primitives.uv_sphere(rng.uniform(0.4, 1.0), 16, 32))
        instances.append((mesh, t))
    soup = primitives.merge(instances, material_ids)

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
    sky = SkyParams.default(sun_direction=(-0.35, -0.7, -0.3))
    return SceneView.create(geo, lights, frame, sky=sky, materials=materials)


#: flagship_queue_scene's texture size (bench.py's material scenes use 256)
QUEUE_TEXTURE_SIZE = 256


def queue_materials(texture_size: int = QUEUE_TEXTURE_SIZE):
    """The host rows and images of ``flagship_queue_scene``'s four
    materials: 0 the ground and 1 the opaque objects, with
    ``procedural_test_maps(0)``'s albedo and normal maps; 2 Masked (cutoff
    0.5) with a copy of the albedo whose alpha is 0/1 stripes
    floor(8 y) % 2; 3 Transparent (opacity 0.5) with the albedo map.
    Returns (table, images) for ``MaterialTable.from_host``."""
    maps = procedural_test_maps(0, texture_size)
    y = (np.arange(texture_size) + 0.5) / texture_size
    stripes = maps[0].copy()
    stripes[..., 3] = (np.floor(8 * y) % 2)[:, None]
    table = {
        "albedo": np.array([[0.9, 0.9, 0.9], [1.0, 1.0, 1.0], [0.9, 0.85, 0.7],
                            [0.6, 0.8, 1.0]], np.float32),
        "metallic": np.array([0.0, 0.2, 0.0, 0.0], np.float32),
        "roughness": np.array([0.7, 0.45, 0.6, 0.1], np.float32),
        "emissive": np.zeros((4, 3), np.float32),
        "albedo_texture": np.array([0, 0, 2, 0], np.int32),
        "normal_texture": np.array([1, 1, -1, -1], np.int32),
        "queue": np.array([0, 0, 1, 2], np.int32),
        "alpha_cutoff": np.full(4, 0.5, np.float32),
        "opacity": np.array([1.0, 1.0, 1.0, 0.5], np.float32),
    }
    return table, [maps[0], maps[1], stripes]


def flagship_queue_scene(width: int, height: int, num_lights: int, num_objects: int,
                         seed: int = 11, device="cuda"):
    """The flagship scene with materials on the raster path: the same
    geometry, lights, camera and sun from the same RNG calls, the ground
    material 0 and object i material 1 + (i % 3) (from the index, never
    the RNG), so a third of the objects, spheres and cubes alike, land in
    each of the Opaque, Masked and Transparent queues
    (``queue_materials``). Returns (SceneView, table, images)."""
    from sailor_tpu_torch.assets.materials import MaterialTable

    dev = resolve_device(device)
    table, images = queue_materials()
    mats = MaterialTable.from_host(table, images, texture_size=QUEUE_TEXTURE_SIZE, device=dev)
    ids = [0] + [1 + i % 3 for i in range(num_objects)]
    scene = _flagship(width, height, num_lights, num_objects, seed, dev, ids, mats)
    return scene, table, images


def content_instances_scene(width: int, height: int, num_lights: int, instances: int,
                            path: str, rng_seed: int = 13, device="cuda") -> SceneView:
    """bench.py's content scene over the model at ``path``: ``instances``
    copies on a jittered 3.2 m grid, each turned about y, loaded through
    ``gltf.load_merged`` with its textures (256 px); a 60 m ground with an
    untextured material row of its own; the flagship's lights and sun from
    the same RNG calls; the camera at (20, 9, 22)."""
    from sailor_tpu_torch.assets import gltf
    from sailor_tpu_torch.assets.materials import MaterialTable

    dev = resolve_device(device)
    soup, mats = gltf.load_merged(path)
    images = gltf.GLTF.load(path).load_texture_images()
    rng = np.random.default_rng(rng_seed)
    floor = primitives.merge([(primitives.plane(60.0), np.eye(4))])
    n_floor_mat = len(mats["albedo"])
    pos_l = [np.asarray(floor["position"], np.float32)]
    nrm_l = [np.asarray(floor["normal"], np.float32)]
    uv_l = [np.asarray(floor["uv"], np.float32)]
    col_l = [np.asarray(floor["color"], np.float32) * [0.55, 0.55, 0.58, 1.0]]
    idx_l = [np.asarray(floor["indices"], np.int32)]
    mat_l = [np.full(len(floor["indices"]), n_floor_mat, np.int32)]
    voff = len(floor["position"])
    side = int(np.ceil(np.sqrt(instances)))
    for i in range(instances):
        gx, gz = i % side, i // side
        ang = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(ang), np.sin(ang)
        rot = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        off = np.asarray([(gx - side / 2) * 3.2 + rng.uniform(-0.5, 0.5), 0.0,
                          (gz - side / 2) * 3.2 + rng.uniform(-0.5, 0.5)], np.float32)
        pos_l.append(np.asarray(soup["position"]) @ rot.T + off)
        nrm_l.append(np.asarray(soup["normal"]) @ rot.T)
        uv_l.append(np.asarray(soup["uv"]))
        col_l.append(np.asarray(soup["color"]))
        idx_l.append(np.asarray(soup["indices"]) + voff)
        mat_l.append(np.asarray(soup["material_id"]))
        voff += len(soup["position"])
    floor_row = {"albedo": [[0.6, 0.6, 0.62]], "metallic": [0.0], "roughness": [0.7],
                 "emissive": [[0, 0, 0]], "albedo_texture": [-1], "normal_texture": [-1],
                 "queue": [0], "alpha_cutoff": [0.5], "opacity": [1.0], "transmission": [0.0],
                 "ior": [1.5], "atten_color": [[1, 1, 1]], "atten_dist": [0.0]}
    table = {k: np.concatenate([np.asarray(v), np.asarray(floor_row[k], np.asarray(v).dtype)])
             for k, v in mats.items() if k in floor_row}
    materials = MaterialTable.from_host(table, images, texture_size=256, device=dev)

    def t32(parts, dtype):
        return torch.from_numpy(np.ascontiguousarray(np.concatenate(parts), dtype)).to(dev)

    geo = Geometry(position=t32(pos_l, np.float32), normal=t32(nrm_l, np.float32),
                   uv=t32(uv_l, np.float32), color=t32(col_l, np.float32),
                   indices=t32(idx_l, np.int32), material_id=t32(mat_l, np.int32))
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
    cam = torch.tensor([20.0, 9.0, 22.0], **f32)
    view = m3.look_at(cam, torch.tensor([0.0, 0.8, 0.0], **f32),
                      torch.tensor([0.0, 1.0, 0.0], **f32))
    proj = m3.perspective(math.pi / 3, width / height, 0.1, 150.0, device=dev)
    frame = FrameData.create(view, proj, cam, 0.1, 150.0, dt=1 / 60)
    sky = SkyParams.default(sun_direction=(-0.35, -0.7, -0.3))
    return SceneView.create(geo, lights, frame, sky=sky, materials=materials)


def occlusion_scene(width: int = 128, height: int = 96, device="cuda") -> SceneView:
    """A 12 m wall at z = 0 in front of the camera (0, 2, 10), 24 cubes of
    0.8 m behind it from a seeded generator, a 60 m ground and one
    directional light; no materials."""
    dev = resolve_device(device)
    rot = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    t_wall = rot.copy()
    t_wall[:3, 3] = [0, 2.0, 0.0]
    items = [(primitives.plane(60.0), np.eye(4)), (primitives.plane(12.0), t_wall)]
    rng = np.random.default_rng(5)
    for _ in range(24):
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = [rng.uniform(-3, 3), rng.uniform(0.5, 3.5), rng.uniform(-8, -3)]
        items.append((primitives.cube(0.8), t))
    soup = primitives.merge(items)

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    geo = Geometry(**{k: t32(soup[k]) for k in ("position", "normal", "uv", "color",
                                                 "indices", "material_id")})
    lights = Lights.from_host(types=[DIRECTIONAL], positions=[[0, 0, 0]],
                              directions=[[0.0, -0.7, -0.7]], intensities=[[3.0, 3.0, 3.0]],
                              device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    cam = torch.tensor([0.0, 2.0, 10.0], **f32)
    view = m3.look_at(cam, torch.tensor([0.0, 2.0, 0.0], **f32),
                      torch.tensor([0.0, 1.0, 0.0], **f32))
    proj = m3.perspective(math.pi / 3, width / height, 0.1, 100.0, device=dev)
    frame = FrameData.create(view, proj, cam, 0.1, 100.0, time=0.0, dt=1 / 60)
    return SceneView.create(geo, lights, frame)


def tracer_soup(rings: int = 24, sectors: int = 48, spheres: int = 8) -> dict:
    """The path tracer's benchmark geometry as a primitive soup: the
    defaults give the bench's 18,434 triangles (73 clusters of 256); fewer
    ``rings``/``sectors``/``spheres`` give the tests' small versions."""
    meshes = [(primitives.plane(40.0), np.eye(4))]
    for i in range(spheres):
        t = np.eye(4)
        t[:3, 3] = [(i % 4 - 1.5) * 2.2, 0.9, (i // 4 - 0.5) * 2.4]
        meshes.append((primitives.uv_sphere(0.9, rings, sectors), t))
    return primitives.merge(meshes)


def tracer_camera(device="cuda"):
    """The bench tracer's camera: (camera_pos, view, proj)."""
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    cam = torch.tensor([0.0, 4.0, 9.0], **f32)
    view = m3.look_at(cam, torch.tensor([0.0, 0.6, 0.0], **f32),
                      torch.tensor([0.0, 1.0, 0.0], **f32))
    return cam, view, m3.perspective(math.pi / 4, 1.0, 0.1, 100.0, device=f32["device"])


def tracer_scene(device="cuda", tracer: str = "auto", **soup_kw):
    """The path tracer's benchmark scene (default materials, analytic sky)
    and camera: (TraceScene, camera_pos, view, proj). ``tracer`` is
    ``scene_from_mesh``'s; ``soup_kw`` go to ``tracer_soup``."""
    dev = resolve_device(device)
    scene = path_tracer.scene_from_mesh(tracer_soup(**soup_kw), tracer=tracer, device=dev)
    return (scene, *tracer_camera(dev))


def dense_tracer_scene(device="cuda"):
    """The bench tracer scene with its spheres at 96x192: 8 x 36,864 + 2 =
    294,914 triangles, over ``path_tracer.MAX_SWEEP_TRIANGLES``, so "auto"
    builds no sweep and every pass takes the BVH8 traversal."""
    return tracer_scene(device, rings=96, sectors=192)


def material_balls_soup(rings: int = 24, sectors: int = 48):
    """The tracer demo's geometry and materials: a 40 m ground plane and
    eight spheres, metallic 0 and 1 by roughness 0.08, 0.3, 0.6 and 0.9
    (``examples/trace.py``'s default scene). Returns (soup, materials)."""
    meshes = [(primitives.plane(40.0), np.eye(4))]
    mats = {"albedo": [[0.65, 0.65, 0.65]], "metallic": [0.0], "roughness": [0.7],
            "emissive": [[0, 0, 0]]}
    mat_ids = [0]
    for i, metallic in enumerate((0.0, 1.0)):
        for j, rough in enumerate((0.08, 0.3, 0.6, 0.9)):
            t = np.eye(4)
            t[:3, 3] = [(j - 1.5) * 2.2, 0.9, (i - 0.5) * 2.4]
            meshes.append((primitives.uv_sphere(0.9, rings, sectors), t))
            mats["albedo"].append([0.8, 0.35, 0.25] if metallic < 0.5 else [0.95, 0.78, 0.45])
            mats["metallic"].append(metallic)
            mats["roughness"].append(rough)
            mats["emissive"].append([0, 0, 0])
            mat_ids.append(len(mat_ids))
    soup = primitives.merge(meshes, mat_ids)
    return soup, {k: np.asarray(v, np.float32) for k, v in mats.items()}


def procedural_test_maps(seed: int = 0, size: int = 256) -> list:
    """Seeded (size, size, 4) float32 maps for tests and the chip smoke run:
    [albedo (tinted checker with noise), tangent-space normal (from a sum of
    random waves), ORM (occlusion 1, roughness and metallic in tiles),
    emissive (a few glowing stripes)]."""
    rng = np.random.default_rng(seed)
    y, x = (np.mgrid[0:size, 0:size] + 0.5) / size
    cells = (np.floor(x * 8) + np.floor(y * 8)) % 2
    tint = rng.uniform(0.3, 0.9, (2, 3))
    albedo = np.where(cells[..., None] > 0, tint[0], tint[1])
    albedo = np.clip(albedo * rng.uniform(0.85, 1.15, (size, size, 1)), 0.0, 1.0)
    dh_dx = np.zeros((size, size))
    dh_dy = np.zeros((size, size))
    for _ in range(6):  # height = sum of a * sin(k . p + phase)
        k = rng.uniform(-40.0, 40.0, 2)
        a = rng.uniform(0.002, 0.01)
        c = a * np.cos(k[0] * x + k[1] * y + rng.uniform(0, 2 * np.pi))
        dh_dx += c * k[0]
        dh_dy += c * k[1]
    nrm = np.stack([-dh_dx, -dh_dy, np.ones_like(x)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tiles = rng.random((4, 4))
    ti = (np.floor(y * 4).astype(int), np.floor(x * 4).astype(int))
    orm = np.stack([np.ones_like(x), 0.3 + 0.7 * tiles[ti], (tiles[ti] > 0.7) * 1.0], -1)
    emissive = np.zeros((size, size, 3))
    for yy in rng.uniform(0.05, 0.95, 3):
        emissive[np.abs(y - yy) < 0.01] = rng.uniform(0.5, 1.0, 3)
    alpha = np.ones((size, size, 1))
    return [np.concatenate([m, alpha], -1).astype(np.float32)
            for m in (albedo, nrm * 0.5 + 0.5, orm, emissive)]


def material_balls(device="cuda", *, sky=None, textured: bool = False, seed: int = 0,
                   **soup_kw):
    """The tracer demo scene and camera: (TraceScene, camera_pos, view,
    proj). ``sky``: a ``kernels.sky.SkyParams`` to bake for miss rays;
    ``textured``: ``procedural_test_maps(seed)`` as the ground's albedo,
    normal, ORM and emissive maps (its emissive factor then 0.5, so the
    emissive map shows)."""
    dev = resolve_device(device)
    soup, mats = material_balls_soup(**soup_kw)
    if textured:
        maps = procedural_test_maps(seed)
        m = len(mats["albedo"])
        for i, k in enumerate(("albedo", "normal", "orm", "emissive")):
            layer = np.full(m, -1, np.int32)
            layer[0] = i
            mats[f"{k}_texture"] = layer
        mats["emissive"][0] = 0.5
        mats["images"] = maps
        mats["texture_size"] = maps[0].shape[0]
    scene = path_tracer.scene_from_mesh(soup, mats, sky=sky, device=dev)
    return (scene, *tracer_camera(dev))


def flagship_world_doc(num_lights: int, num_objects: int, seed: int = 11,
                       aspect: float = 1920 / 1088) -> dict:
    """The flagship scene as a plain `.world` document (lists and numbers),
    which both packages' ``World.deserialize`` take: a 60 m ground plane;
    bench.py's objects from the same RNG calls (cubes of ``size`` and
    spheres of ``radius``, which give ``uv_sphere(r, 16, 32)`` as the bench
    does); the bench's sun and point lights as LightComponents (the point
    lights' attenuation (1, 0, 0.8), their radii from the RNG); a camera
    at (35.36, 10, 0) turned to look at (0, 0.5, 0) (fov 60 degrees,
    ``aspect``, near 0.1, far 150) with a ``TestComponent`` that orbits it
    about the y axis at radius 35.36 and 0.2 rad/s, so every frame moves a
    transform. At (1000, 96): 1,099 game objects and 1,001 lights."""
    rng = np.random.default_rng(seed)
    ident = [0.0, 0.0, 0.0, 1.0]

    def obj(name, position, components, rotation=ident):
        return {"name": name, "position": [float(v) for v in position],
                "rotation": [float(v) for v in rotation], "scale": [1.0, 1.0, 1.0],
                "parentIndex": -1, "components": components}

    def mesh(asset, **params):
        return [{"typename": "MeshRendererComponent", "mesh_asset": asset, "material_id": 0,
                 "mesh_params": {k: float(v) for k, v in params.items()}}]

    objs = [obj("Ground", (0, 0, 0), mesh("plane", size=60.0))]
    for i in range(num_objects):
        pos = [rng.uniform(-20, 20), rng.uniform(0.4, 2.0), rng.uniform(-20, 20)]
        objs.append(obj(f"Object_{i}", pos, mesh("cube", size=rng.uniform(0.8, 2.0)) if i % 2
                        else mesh("sphere", radius=rng.uniform(0.4, 1.0))))
    n = num_lights
    lp = np.stack([rng.uniform(-22, 22, n), rng.uniform(0.3, 3.0, n),
                   rng.uniform(-22, 22, n)], -1)
    intensity = rng.uniform(0.3, 1, (n, 3)) * 6
    radii = rng.uniform(2.0, 5.0, n)

    def light(kind, inten, radius, direction=(0.0, -1.0, 0.0)):
        return [{"typename": "LightComponent", "light_type": kind,
                 "intensity": [float(v) for v in inten], "attenuation": [1.0, 0.0, 0.8],
                 "direction": list(direction), "cutoff": [0.9, 0.7],
                 "radius": float(radius), "shadow_type": 0}]

    objs.append(obj("Sun", (0, 0, 0), light(DIRECTIONAL, (3.0, 2.9, 2.6), 0.0,
                                             (-0.35, -0.7, -0.3))))
    objs += [obj(f"Light_{i}", lp[i], light(POINT, intensity[i], radii[i])) for i in range(n)]
    cam = torch.tensor([35.36, 10.0, 0.0])
    rot = m3.quat_look_rotation(torch.tensor([0.0, 0.5, 0.0]) - cam)
    objs.append(obj("Camera", cam.tolist(), [
        {"typename": "CameraComponent", "fov_degrees": 60.0, "aspect": float(aspect),
         "z_near": 0.1, "z_far": 150.0},
        {"typename": "TestComponent", "num_lights": 0, "orbit_radius": 35.36,
         "orbit_speed": 0.2}], rotation=rot.tolist()))
    for i, o in enumerate(objs):
        o["instanceId"] = f"{i:016x}"
    return {"name": "FlagshipWorld", "gameObjects": objs}


def mesh_boxes(doc: dict) -> list[tuple[np.ndarray, np.ndarray]]:
    """World-space bounds (lo, hi) of each solid mesh object of a `.world`
    document's top-level objects (a primitive's vertices rotated, scaled
    and moved as the object is); flat meshes, such as a ground plane, have
    none. Debug boxes for the engine's night cell: one ``draw_aabb`` each."""
    from sailor_tpu_torch.engine.components import primitive_mesh

    boxes = []
    for o in doc["gameObjects"]:
        for c in o["components"]:
            if c["typename"] != "MeshRendererComponent":
                continue
            mesh = primitive_mesh(c.get("mesh_asset") or "cube", c.get("mesh_params") or {})
            if mesh is None:
                continue
            rot = m3.quat_to_mat3(torch.tensor(o["rotation"], dtype=torch.float32)).numpy()
            p = (mesh.positions * np.asarray(o["scale"], np.float32)) @ rot.T + np.asarray(
                o["position"], np.float32)
            lo, hi = p.min(0), p.max(0)
            if np.all(hi > lo):
                boxes.append((lo, hi))
    return boxes
